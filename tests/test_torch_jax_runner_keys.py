"""The keys the JAX package's runners return, read from their source
without running them (the dict literals assigned to `rows`, by their
"mode", and the dict a function returns). The port's runner tests hold
their outputs to these; the tests here hold the reader to what the JAX
sources say."""

import ast
import pathlib

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
