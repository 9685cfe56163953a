"""The port's capstone runner, `utils/device_vio_bench.py`, on the CPU at
160×120 (pinhole, fx = 0.6·W) over 1.5 s of the circuit, float64, a
3-keyframe window with 48 slots, κ̄ = 30 (the on-device gate on).

The runner's loop must equal stepping the same ported components by hand:
render the circuit, warm the host estimator up on the device tracker's
measurements until the hand-off, `vio_init_from_host`, then
`tracker_step` → `vio_step` per frame with the tracker's generator — the
same trajectory bit for bit, hence the same ATE (exact). Its output keys are
the JAX runner's (read from the JAX module's source: its `rows` literals),
plus the port's stage split; `host_control` returns exactly the JAX keys.
Outputs are finite.
"""

import numpy as np
import pytest
import torch

from anticipated_vins_mono_torch.models import anticipation as ant
from anticipated_vins_mono_torch.models import estimator_device as ed
from anticipated_vins_mono_torch.models import tracker_device as td
from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import device_vio_bench as dvb
from anticipated_vins_mono_torch.utils.metrics import ate_rmse
from test_torch_jax_runner_keys import jax_row_keys

torch.set_num_threads(1)

SIZE = dict(width=160, height=120, n_feats=64, device="cpu",
            dtype_str="float64", window=3, max_feats=48)
DURATION = 1.5


@pytest.fixture(scope="module")
def bench():
    return dvb.main(duration=DURATION, kappa=30, **SIZE)


def test_device_vio_bench_equals_stepping_by_hand(bench):
    """The same circuit stepped by hand: the hand-off frame, the trajectory
    and its ATE exactly; no fail flag; finite."""
    dev = torch.device("cpu")
    cam, traj, imgs, ts, imu = dvb.render_circuit(DURATION, 160, 120, None,
                                                  dev)
    wcfg = WindowConfig(window=3, max_feats=48, iters=8, accum="f64")
    tparams = td.TrackerDeviceParams(max_features=64)
    tracker = td.DeviceFeatureTracker(cam, tparams, seed=0)
    est = VioEstimator(wcfg, dtype=torch.float64, device=dev, init_state={
        "p": traj.p[0], "q": traj.q[0], "v": traj.v[0]})
    f = 0
    while not (est.initialized and est.n_frames == wcfg.nf - 1):
        est.process_frame(dvb._frame_measurement(tracker, imgs, ts, imu, f))
        f += 1
    assert f == bench["handoff_frame"]
    vst = ed.vio_init_from_host(est)
    pr = ed.DeviceVioParams(wcfg=wcfg,
                            sel_cfg=ant.SelectorConfig(max_features=30))
    tst, ps, fails = tracker.state, [], []
    f64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    for g in range(f, len(ts)):
        tst, (ids, rays, vel, prob, active) = td.tracker_step(
            cam, tparams, tst, imgs[g], float(ts[g]),
            generator=tracker.generator)
        vst, o = ed.vio_step(pr, vst, ids, rays.double(), vel.double(),
                             prob.double(), active,
                             *(f64(x[g]) for x in imu), device=dev)
        ps.append(o["p"].numpy())
        fails.append(bool(o["fail"]))
    ate = ate_rmse(ts[f:], np.stack(ps), traj.t, traj.p)
    assert bench["ate_rmse_m"] == ate
    assert bench["fail_flags"] == sum(fails) == 0
    assert bench["n_frames_device"] == len(ps) == len(ts) - f
    assert all(np.isfinite(v) for v in bench.values()
               if isinstance(v, float))


def test_device_vio_bench_keys_are_the_jax_runners(bench):
    jax_keys = jax_row_keys("device_vio_bench.py")
    assert jax_keys["default"] <= set(bench)
    assert set(bench) - jax_keys["default"] == {
        "handoff_frame", "host_solves", "tracker_ms_per_frame",
        "vio_step_ms_per_frame"}
    assert bench["host_solves"] == 1
    assert bench["backend"] == "cpu" and bench["kappa"] == 30
    assert bench["accum"] == "f64"


def test_host_control_returns_the_jax_keys():
    """`host_control`: the host selector + estimator on the same
    measurements; exactly the JAX keys, finite, no failure."""
    rows = dvb.main(duration=DURATION, kappa=30, host_control=True, **SIZE)
    assert set(rows) == jax_row_keys("device_vio_bench.py")["host_control"]
    assert rows["mode"] == "host_control" and rows["failures"] == 0
    assert np.isfinite(rows["ate_rmse_m"]) and rows["ate_rmse_m"] < 0.1
