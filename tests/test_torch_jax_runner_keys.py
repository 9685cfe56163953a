"""The keys the JAX package's runners return, read from their source
without running them (the dict literals assigned to `rows`, by their
"mode", and the dict a function returns). The port's runner tests hold
their outputs to these; the tests here hold the reader to what the JAX
sources say, and the harness runners' rows (`bench_curve`, `benchmark`,
`image_benchmark`, `scaling_eval`) of both packages to each other, read
the same way, with the port's deliberate renames listed in `RENAMES`."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_row_keys(module: str) -> dict:
    """The keys of every dict literal assigned to `rows` in the JAX
    package's `utils/<module>`, by its "mode" ("default" where it has
    none)."""
    src = (ROOT / "anticipated_vins_mono_tpu" / "utils" / module).read_text()
    out = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "rows" for t in node.targets):
            keys = [k.value for k in node.value.keys]
            mode = "default"
            if "mode" in keys:
                mode = node.value.values[keys.index("mode")].value
            out[mode] = set(keys)
    return out


def jax_return_keys(module: str, function: str) -> set:
    """The keys of the dict literal that `function` of the JAX package's
    `utils/<module>` returns."""
    src = (ROOT / "anticipated_vins_mono_tpu" / "utils" / module).read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.FunctionDef) and node.name == function:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) \
                        and isinstance(sub.value, ast.Dict):
                    return {k.value for k in sub.value.keys}
    raise LookupError(f"{module}:{function} returns no dict literal")


def test_reader_finds_every_mode_of_the_jax_runners():
    dvb = jax_row_keys("device_vio_bench.py")
    assert set(dvb) == {"default", "host_control", "corruption_recovery"}
    assert {"device_ms_per_frame", "ate_rmse_m", "fail_flags"} <= \
        dvb["default"]
    assert "ate_recovered_m" in dvb["corruption_recovery"]
    stream = jax_row_keys("streaming_bench.py")
    assert set(stream) == {"default"} and "null_rtt_ms" in stream["default"]
    loop = jax_return_keys("loop_benchmark.py", "run_loop_benchmark")
    assert {"ate_vio", "ate_loop", "ate_loop_path", "funnel"} <= loop


# ---------------------------------------------------------------------------
# The harness runners: the JAX row dicts and the port's, both read from
# their sources
# ---------------------------------------------------------------------------


def dict_keys(package: str, module: str, name: str) -> set:
    """The keys of the dict literals assigned to `name` (or returned, for
    name=None) in `<package>/<module>`, joined."""
    src = (ROOT / package / module).read_text()
    keys = set()
    for node in ast.walk(ast.parse(src)):
        if name is None and isinstance(node, ast.Return) \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == name for t in node.targets):
            keys |= {k.value for k in node.value.keys}
    if not keys:
        raise LookupError(f"{package}/{module}: no dict named {name}")
    return keys


JAX, PORT = "anticipated_vins_mono_tpu", "anticipated_vins_mono_torch"

# Deliberate renames, JAX key → port key, each with its reason:
RENAMES = {
    # no XLA executable: the count is FlopCounterMode's aten products plus
    # the Schur kernel's operations (utils/bench_curve.py docstring)
    "bench_curve": {"xla_flops_per_solve": "flops_per_solve",
                    # no compile step: the first, untimed solve (kernel
                    # build at first use, allocator, cuSOLVER handles)
                    "compile_s": "first_solve_s"},
    # the JAX sweep ends at 8 virtual devices, the port's at its last dp
    "scaling_eval": {"efficiency_dp8": "efficiency_dp_max"},
}
# keys only the port's rows carry
PORT_ONLY = {
    "bench_curve": {"fused_schur", "solves", "schur_launches", "device",
                    "nvidia_smi"},
    "scaling_eval": {"device", "cards", "caveat"},
}


def _renamed(keys, runner):
    ren = RENAMES.get(runner, {})
    return {ren.get(k, k) for k in keys} | PORT_ONLY.get(runner, set())


def test_bench_curve_row_keys():
    jax = dict_keys(JAX, "utils/bench_curve.py", "row")
    assert {"B", "iters_per_s", "xla_flops_per_solve", "mfu_f32",
            "compile_s"} <= jax
    assert dict_keys(PORT, "utils/bench_curve.py", "row") == \
        _renamed(jax, "bench_curve")


@pytest.mark.parametrize("module", ["utils/benchmark.py",
                                    "utils/image_benchmark.py"])
def test_benchmark_row_keys_equal_jax(module):
    jax = dict_keys(JAX, module, "row")
    assert {"ate_rmse", "frames", "failures", "initialized"} <= jax
    assert dict_keys(PORT, module, "row") == jax


def test_benchmark_optional_row_keys_equal_jax():
    """The keys `run_one` adds to its row under its options."""
    def added(package):
        src = (ROOT / package / "utils/benchmark.py").read_text()
        return {node.slice.value for node in ast.walk(ast.parse(src))
                if isinstance(node, ast.Subscript)
                and getattr(node.value, "id", None) == "row"
                and isinstance(node.ctx, ast.Store)}
    assert added(PORT) == added(JAX) and "td_est" in added(JAX)


def test_scaling_eval_keys():
    rep_j = dict_keys(JAX, "parallel/distributed.py", None)
    rep_t = dict_keys(PORT, "parallel/distributed.py", None)
    assert rep_t == rep_j == {"batch", "seconds_per_step", "solves_per_s",
                              "devices", "hosts"}
    res_j = dict_keys(JAX, "utils/scaling_eval.py", "result")
    assert dict_keys(PORT, "utils/scaling_eval.py", "result") == \
        _renamed(res_j, "scaling_eval")
