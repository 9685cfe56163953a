"""The port stands on torch alone, and its entry points do not fall back
to the CPU on their own."""

import ast
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "anticipated_vins_mono_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN_TEXT = ("import jax", "from jax", "import_module", "__import__")
FORBIDDEN_MODULES = ("jax", "jaxlib", "anticipated_vins_mono_tpu")


def _imported_modules(text):
    """Every module named by an import statement anywhere in the source."""
    mods = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_and_nothing_of_the_jax_package(path):
    """No import statement names jax or the JAX package (docstrings may point
    at the JAX counterpart of a function by its path), and nothing imports by
    a computed name."""
    text = path.read_text()
    for word in FORBIDDEN_TEXT:
        assert word not in text, f"{path.name} contains {word!r}"
    for mod in _imported_modules(text):
        assert mod.split(".")[0] not in FORBIDDEN_MODULES, \
            f"{path.name} imports {mod}"


def _package_imports(tree, package="anticipated_vins_mono_torch"):
    """(module, inside a function body) for every module of `package` that
    an import statement of the parsed source names; `from a import b`
    names `a.b`."""
    inner = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            inner.update(id(n) for n in ast.walk(fn) if n is not fn)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        found += [(m, id(node) in inner) for m in mods
                  if m.split(".")[0] == package]
    return found


def test_the_kernel_layer_sits_below_the_ops():
    """The imports between the ops and their kernels point one way: no
    `ops/` module imports from the package inside a function body (where
    an import cycle would hide), and `ops/hopper_kernels.py` imports
    nothing of the package but `ops.lie`."""
    ops = sorted((ROOT / "anticipated_vins_mono_torch" / "ops").glob("*.py"))
    lazy = [(p.name, m) for p in ops
            for m, inner in _package_imports(ast.parse(p.read_text()))
            if inner]
    assert lazy == []
    hk = ROOT / "anticipated_vins_mono_torch" / "ops" / "hopper_kernels.py"
    assert [m for m, _ in _package_imports(ast.parse(hk.read_text()))] == \
        ["anticipated_vins_mono_torch.ops.lie"]


def test_port_has_the_expected_modules_and_kernel_sources():
    names = {str(p.relative_to(ROOT / "anticipated_vins_mono_torch"))
             for p in PORT_FILES[:-1]}
    for need in ("ops/lie.py", "ops/preintegration.py", "ops/factors.py",
                 "ops/window.py", "ops/hopper_kernels.py",
                 "ops/triangulation.py", "ops/marginalization.py",
                 "models/anticipation.py", "models/feature_selector.py",
                 "models/estimator_device.py", "models/feature_db.py",
                 "models/initialization.py", "models/estimator.py",
                 "models/pipeline.py", "models/frontend.py",
                 "models/tracker_device.py", "models/node.py",
                 "ops/cameras.py", "utils/render.py", "native/__init__.py",
                 "utils/synthetic.py", "utils/convert.py",
                 "utils/sequence.py", "utils/metrics.py",
                 "utils/profile_slice.py", "models/posegraph.py",
                 "models/loop_node.py", "utils/loop_benchmark.py",
                 "utils/placerec_eval.py", "utils/device_vio_bench.py",
                 "utils/streaming_bench.py", "parallel/distributed.py",
                 "parallel/sharded.py", "parallel/selector.py", "entry.py",
                 "utils/timing.py", "utils/config.py", "utils/euroc.py",
                 "utils/checkpoint.py", "utils/bench_curve.py",
                 "utils/scaling_eval.py", "utils/benchmark.py",
                 "utils/image_benchmark.py", "utils/calibration.py",
                 "utils/viz.py", "utils/report.py"):
        assert need in names
    from anticipated_vins_mono_torch.ops import hopper_kernels as hk
    for src in hk.KERNEL_SOURCES.values():
        text = (hk.CSRC_DIR / src).read_text()
        assert "__global__" in text and "cudaGetLastError" in text
        assert "cublas" not in text.lower() and "cusolver" not in text.lower()


def test_importing_the_port_builds_nothing():
    import anticipated_vins_mono_torch  # noqa: F401
    from anticipated_vins_mono_torch.ops import hopper_kernels as hk
    assert hk._libs == {} or torch.cuda.is_available()


def test_native_source_is_the_jax_packages_whole():
    """The port's C++ is its own copy of the JAX package's, code unchanged
    (comments may differ), and the loader builds outside the source tree."""
    from anticipated_vins_mono_torch import native
    code = lambda p: [ln for ln in p.read_text().splitlines()
                      if not ln.startswith("//")]
    jax_src = ROOT / "anticipated_vins_mono_tpu/native/src/avm_native.cc"
    assert code(native.SRC) == code(jax_src)
    assert native.BUILD_DIR == ROOT / "build" / "native"


def _unbuildable(monkeypatch, tmp_path, cxx):
    """Point the native loader at compiler `cxx` and an empty build
    directory under `tmp_path`, with nothing loaded yet."""
    from anticipated_vins_mono_torch import native
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    return native


def test_native_loader_raises_when_the_compiler_is_missing(monkeypatch,
                                                          tmp_path):
    native = _unbuildable(monkeypatch, tmp_path, tmp_path / "no-such-g++")
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.get_lib()
    with pytest.raises(RuntimeError):
        native.hamming_all_pairs(np.zeros((1, 4), np.uint64),
                                 np.zeros((1, 4), np.uint64))


def test_native_loader_raises_with_the_compilers_output(monkeypatch,
                                                        tmp_path):
    bad = tmp_path / "bad-cxx"
    bad.write_text("#!/bin/sh\necho 'avm: this compiler refuses' >&2\n"
                   "exit 3\n")
    bad.chmod(0o755)
    native = _unbuildable(monkeypatch, tmp_path, bad)
    with pytest.raises(RuntimeError, match="this compiler refuses"):
        native.MeasurementAligner()
    assert not list((tmp_path / "build").glob("*.so"))


def test_vio_node_with_native_raises_when_the_library_cannot_be_built(
        monkeypatch, tmp_path):
    from anticipated_vins_mono_torch.models.estimator import VioEstimator
    from anticipated_vins_mono_torch.models.node import VioNode, _PyAligner
    from anticipated_vins_mono_torch.ops.window import WindowConfig
    _unbuildable(monkeypatch, tmp_path, tmp_path / "no-such-g++")
    est = VioEstimator(WindowConfig(window=2, max_feats=4), device="cpu")
    with pytest.raises(RuntimeError, match="native build failed"):
        VioNode(est, use_native=True)
    assert isinstance(VioNode(est, use_native=False).aligner, _PyAligner)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")


def test_make_window_problem_raises_without_card():
    _no_card()
    from anticipated_vins_mono_torch.ops.window import WindowConfig
    from anticipated_vins_mono_torch.utils.synthetic import make_window_problem
    with pytest.raises((RuntimeError, AssertionError)):
        make_window_problem(WindowConfig(window=2, max_feats=4))


def test_lm_solve_raises_without_card():
    _no_card()
    from anticipated_vins_mono_torch.ops.window import WindowConfig, lm_solve
    from anticipated_vins_mono_torch.utils.synthetic import make_window_problem
    cfg = WindowConfig(window=2, max_feats=4, iters=1)
    prob = make_window_problem(cfg, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        lm_solve(prob.init, prob.meas, cfg)


def test_select_informative_raises_without_card():
    _no_card()
    from anticipated_vins_mono_torch.models.anticipation import \
        select_informative
    eye = torch.eye(18, dtype=torch.float64)
    with pytest.raises((RuntimeError, AssertionError)):
        select_informative(eye, torch.zeros(3, 18, 18, dtype=torch.float64),
                           torch.ones(3, dtype=torch.float64),
                           torch.ones(3, dtype=torch.float64), 2)


def test_device_select_raises_without_card():
    _no_card()
    from anticipated_vins_mono_torch.models import anticipation as ant
    from anticipated_vins_mono_torch.models.feature_selector import \
        device_select
    t = lambda *s: torch.zeros(*s, dtype=torch.float64)
    q = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64)
    with pytest.raises((RuntimeError, AssertionError)):
        device_select(ant.SelectorConfig(horizon=2), 1, 2, 0.005,
                      t(3), q, t(3), t(3), t(3), t(3), t(3), t(3), q,
                      t(4, 3), t(4), t(4), t(4, 3), t(4), t(4),
                      t(4, 2), t(4), t(4))


def test_image_path_entry_points_raise_without_card():
    _no_card()
    from anticipated_vins_mono_torch.models import tracker_device as td
    from anticipated_vins_mono_torch.ops import cameras
    from anticipated_vins_mono_torch.utils import render
    with pytest.raises((RuntimeError, AssertionError)):
        cameras.euroc_camera()
    with pytest.raises((RuntimeError, AssertionError)):
        render.make_box_world(np.zeros((2, 3)))
    cam = cameras.euroc_camera(device="cpu")
    state = td.tracker_init(cam, td.TrackerDeviceParams(max_features=8),
                            np.zeros((48, 64), np.float32), 0.0)
    assert state.key.device.type == "cpu"


def test_loop_closure_entry_points_raise_without_card():
    """The pose graph's solve, the loop node, the retrieval and the four
    runners default to the card: without one they raise."""
    _no_card()
    from anticipated_vins_mono_torch.models import posegraph as pg
    from anticipated_vins_mono_torch.models.loop_node import LoopClosureNode
    from anticipated_vins_mono_torch.ops import cameras
    from anticipated_vins_mono_torch.utils import (
        device_vio_bench, loop_benchmark, placerec_eval, streaming_bench)
    cam = cameras.euroc_camera(device="cpu")

    def optimize():
        graph, q = pg.PoseGraph(), np.array([1.0, 0, 0, 0])
        graph.add_keyframe(np.zeros(3), q)
        graph.add_keyframe(np.ones(3), q, loop_hint=(0, np.zeros(3), 0.0))
        graph.optimize()

    for make in (optimize, lambda: LoopClosureNode(cam=cam),
                 lambda: pg.direct_similarities(np.zeros((2, 256)), [0, 2],
                                                np.zeros((1, 256))),
                 lambda: loop_benchmark.run_loop_benchmark(duration=0.5),
                 lambda: device_vio_bench.main(duration=0.5),
                 lambda: streaming_bench.main(n_frames=1),
                 lambda: placerec_eval.build_keyframe_data(duration=0.5)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()


def test_harness_entry_points_raise_without_card(tmp_path, monkeypatch):
    """The curve, the flagship entry, the config's camera, the chessboard
    detector on a numpy image and both EuRoC runners default to the card:
    without one they raise."""
    _no_card()
    from anticipated_vins_mono_torch import entry
    from anticipated_vins_mono_torch.ops.window import WindowConfig
    from anticipated_vins_mono_torch.utils import (
        bench_curve, benchmark, calibration, config, euroc, image_benchmark)
    from anticipated_vins_mono_torch.utils.synthetic import (
        analytic_trajectory, write_euroc_csv)
    (tmp_path / "SIM").mkdir()
    write_euroc_csv(str(tmp_path / "SIM" / "data.csv"),
                    analytic_trajectory(1.0))
    monkeypatch.setattr(euroc, "REFERENCE_GT_DIR", str(tmp_path))
    tiny = WindowConfig(window=2, max_feats=4, iters=1)
    for make in (lambda: bench_curve.run_curve((1,), reps=1, cfg=tiny),
                 entry.entry,
                 lambda: config.VinsConfig().camera_model(),
                 lambda: calibration.detect_chessboard(
                     np.zeros((40, 40)), 2, 2),
                 lambda: benchmark.run_one("SIM", max_seconds=0.5),
                 lambda: image_benchmark.run_image_benchmark(
                     "SIM", max_seconds=0.5)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()


def test_chip_smoke_refuses_to_run_without_card():
    """Without a CUDA device the script exits non-zero and prints no result
    line."""
    _no_card()
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
