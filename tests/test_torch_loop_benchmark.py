"""The port's loop-closure benchmark (`utils/loop_benchmark.py`), CPU,
160×120 (pinhole, fx = 0.6·W), 1.5 s of the circuit, float64, a
3-keyframe window with 48 slots, 1000 interior landmarks.

The runner's second pass must equal stepping the same ported components by
hand — the grounded landmark field, `SequenceSimulator`, `VioEstimator` with
the real initialization, a `LoopClosureNode` fed the rendered image at each
keyframe with the estimator as its relocalization consumer, and
`correct_pose` on every output — exactly (the same ATE, keyframes and
funnel). So short a run closes no loop, so both passes see the same
stream, solve the same windows and report the same trajectory: ATE with and
without the node equal exactly. Its keys are the JAX runner's (read from
the JAX module's source) plus the port's own; outputs are finite.

The runner against the JAX runner: the JAX package's `run_loop_benchmark`
on the same arguments (its window set to the same 3 keyframes and 48 slots;
float64 on both sides) gives the same landmark count, keyframes, funnel,
loops and failures, the keyframe poses it dumps within one step of the
dump's rounding (1e-5 m, 1e-4°: two values a rounding apart can round
apart) and both ATEs within 1e-5 m (measured 9.4e-7 m: the host chain at
0.5 px of pixel noise amplifies rounding, ROADMAP queue C 4(b)). A
module-scoped fixture runs it once.
"""

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.ops import window as jwindow
from anticipated_vins_mono_tpu.utils import loop_benchmark as jlb
from anticipated_vins_mono_torch.models import posegraph as pg
from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.models.loop_node import LoopClosureNode
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import loop_benchmark as lb
from anticipated_vins_mono_torch.utils import render
from anticipated_vins_mono_torch.utils.metrics import ate_rmse
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator
from test_torch_jax_runner_keys import jax_return_keys

torch.set_num_threads(1)

W, H, DURATION, N_INTERIOR = 160, 120, 1.5, 1000
SIZE = dict(width=W, height=H, device="cpu", n_interior=N_INTERIOR,
            window=3, max_feats=48)


@pytest.fixture(scope="module")
def bench():
    return lb.run_loop_benchmark(duration=DURATION, **SIZE)


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX runner at the same size: its window (10 keyframes, 192 slots
    in its source) set to the port test's through the `WindowConfig` it
    builds."""
    cfg = jwindow.WindowConfig
    jlb.WindowConfig = lambda **kw: cfg(**{**kw, "window": SIZE["window"],
                                           "max_feats": SIZE["max_feats"]})
    try:
        return jlb.run_loop_benchmark(duration=DURATION, width=W, height=H,
                                      n_interior=N_INTERIOR)
    finally:
        jlb.WindowConfig = cfg


def test_loop_benchmark_equals_the_jax_runner(bench, jax_bench):
    """Same arguments into both runners, float64: the counts and the funnel
    exactly, the dumped keyframe poses within one step of their rounding,
    the ATEs 1e-5 m."""
    for key in ("landmarks", "keyframes", "loops_accepted", "funnel",
                "edges", "vio_failures", "duration_s", "laps"):
        assert bench[key] == jax_bench[key], key
    for kt, kj in zip(bench["keyframes_vio"], jax_bench["keyframes_vio"],
                      strict=True):
        assert kt["t"] == kj["t"]
        np.testing.assert_allclose(kt["p"], kj["p"], rtol=0, atol=1.5e-5)
        np.testing.assert_allclose(kt["ypr"], kj["ypr"], rtol=0, atol=1.5e-4)
    for key in ("ate_vio", "ate_loop"):
        assert abs(bench[key] - jax_bench[key]) <= 1e-5, key
    assert np.isnan(bench["ate_loop_path"]) == np.isnan(
        jax_bench["ate_loop_path"])


def test_loop_pass_equals_stepping_by_hand(bench):
    dev = torch.device("cpu")
    cam, traj, world, rays, R_all, lms = lb.loop_scene(
        DURATION, DURATION / 10.0, 3.0, W, H, 0, 0.0, 3.0, N_INTERIOR, dev)
    assert bench["landmarks"] == len(lms)
    fx = 0.6 * W
    sim = SequenceSimulator(
        traj, seed=0, landmarks=lms, pixel_noise=0.5, max_features=150,
        depth_range=(0.5, 30.0), fov_x=(W / 2.0) / fx, fov_y=(H / 2.0) / fx,
        imu_acc_sigma=0.25, imu_gyr_sigma=0.012, imu_acc_bias=0.06,
        imu_gyr_bias=0.004)
    est = VioEstimator(WindowConfig(window=3, max_feats=48, iters=8,
                                    estimate_extrinsic=False), device=dev)
    node = LoopClosureNode(cam=cam, graph=pg.PoseGraph(device=dev),
                           skip_cnt=1, device=dev)
    out = []
    for fm in sim.frames():
        n_before = len(est.trajectory)
        est.process_frame(fm)
        if len(est.trajectory) < n_before:
            out, n_before = [], 0
        if est.last_keyframe is not None:
            k = min(int(round(fm.t * 200.0)), len(traj.t) - 1)
            node.on_keyframe(render.render_frame(world, cam, rays, traj.p[k],
                                                 R_all[k]),
                             est.last_keyframe, est)
        out += [(tt, node.correct_pose(pp, qq)[0])
                for tt, pp, qq, _ in est.trajectory[n_before:]]
    ate = ate_rmse(np.array([o[0] for o in out]),
                   np.stack([o[1] for o in out]), traj.t, traj.p)
    assert bench["ate_loop"] == ate
    assert bench["keyframes"] == len(node.entries) >= 2
    assert bench["funnel"] == node.stats
    assert bench["vio_failures"] == est.diag.failures == 0
    assert bench["solves"] == est.diag.solves >= 1
    assert est.initialized


def test_loop_benchmark_keys_and_no_loop_consistency(bench):
    jax_keys = jax_return_keys("loop_benchmark.py", "run_loop_benchmark")
    assert jax_keys <= set(bench)
    assert set(bench) - jax_keys == {
        "ate_path_vio", "device", "dtype", "loop_pass_frames", "solves",
        "first_loop_frame",
        "relo_after_first_loop_frame", "corrected_path_finite",
        "node_ms_per_keyframe"}
    assert bench["loops_accepted"] == 0 and bench["edges"] == []
    assert bench["ate_vio"] == bench["ate_loop"] < 0.5
    assert bench["corrected_path_finite"]
    assert bench["loop_pass_frames"] == int(DURATION * 10)
    assert np.isfinite(bench["node_ms_per_keyframe"])
    assert len(bench["keyframes_vio"]) == bench["keyframes"]
