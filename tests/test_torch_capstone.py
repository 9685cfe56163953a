"""The port's capstone runner, `utils/device_vio_bench.py`, on the CPU at
160×120 (pinhole, fx = 0.6·W) over 1.5 s of the circuit, float64, a
3-keyframe window with 48 slots, 64 tracker slots, κ̄ = 30 (the on-device
gate on), tracker seed 0.

The runner's loop must equal stepping the same ported components by hand:
render the circuit, warm the host estimator up on the device tracker's
measurements until the hand-off, `vio_init_from_host`, then
`tracker_step` → `vio_step` per frame, the tracker state carrying its
RANSAC key — the same trajectory bit for bit, hence the same ATE (exact).
Its output keys are the JAX runner's (read from the JAX module's source:
its `rows` literals), plus the port's stage split; `host_control` returns
exactly the JAX keys. Outputs are finite.

The runner against the JAX runner, `device_vio_bench.main` of the JAX
package at the same size (its window, 10 keyframes and 128 slots in its
source, set to the port test's through the `WindowConfig` it builds; the
same tracker seed, so the same RANSAC draws), each run once in a
module-scoped fixture that records its tracker's measurements and its
`vio_step`s: see `test_device_vio_bench_equals_the_jax_runner`. A free
run cannot be held frame for frame: the host warm-up's rounding (ROADMAP
queue C 4(b)) leaves the two hand-off states 5e-8 m apart, and the
float32 tracker's one known RANSAC flip (queue C 5(c)) parts the two
measurement streams at frame 5; the estimators then part by up to 1.2e-2
m. So the hand-off and every device step are held from the same inputs.
"""

import jax
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models import estimator_device as jed
from anticipated_vins_mono_tpu.models import tracker_device as jtd
from anticipated_vins_mono_tpu.ops import window as jwindow
from anticipated_vins_mono_tpu.utils import device_vio_bench as jdvb
from anticipated_vins_mono_torch.models import anticipation as ant
from anticipated_vins_mono_torch.models import estimator_device as ed
from anticipated_vins_mono_torch.models import tracker_device as td
from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import convert
from anticipated_vins_mono_torch.utils import device_vio_bench as dvb
from anticipated_vins_mono_torch.utils.metrics import ate_rmse
from test_torch_jax_runner_keys import jax_row_keys

torch.set_num_threads(1)

SIZE = dict(width=160, height=120, n_feats=64, device="cpu",
            dtype_str="float64", window=3, max_feats=48)
DURATION = 1.5


@pytest.fixture(scope="module")
def port_run():
    """The port's runner at the test size: its row, and on the way its
    tracker's measurement of every frame (ids, active) and the state it
    hands to the device."""
    rec = {"tracker": [], "handoff": None}
    init, step, vio = td.tracker_init, td.tracker_step, ed.vio_step

    def tracker_init(*a, **kw):
        st = init(*a, **kw)
        rec["tracker"].append((st.ids.numpy().copy(),
                               st.active.numpy().copy()))
        return st

    def tracker_step(*a, **kw):
        st, m = step(*a, **kw)
        rec["tracker"].append((m[0].numpy().copy(), m[4].numpy().copy()))
        return st, m

    def vio_step(pr, st, *a, **kw):
        if rec["handoff"] is None:
            rec["handoff"] = convert.device_vio_state_to_numpy(st)
        return vio(pr, st, *a, **kw)

    td.tracker_init, td.tracker_step, ed.vio_step = (
        tracker_init, tracker_step, vio_step)
    try:
        rows = dvb.main(duration=DURATION, kappa=30, **SIZE)
    finally:
        td.tracker_init, td.tracker_step, ed.vio_step = init, step, vio
    return rows, rec


@pytest.fixture(scope="module")
def bench(port_run):
    return port_run[0]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX runner at the same size, float64: its row, its tracker's
    measurement of every call (ids, active; the device frames' twice: the
    runner scans them once to compile and once to time) and every
    `vio_step` (the state before it, its inputs, the slot ids and the
    position after it), recorded through host callbacks."""
    rec = {"tracker": [], "steps": []}
    tree = lambda x: jax.tree_util.tree_map(np.array, x)
    cfg, init, step, vio = (jwindow.WindowConfig, jtd.tracker_init,
                            jtd.tracker_step, jed.vio_step)

    def tracker_init(*a, **kw):
        st = init(*a, **kw)
        rec["tracker"].append((np.array(st.ids), np.array(st.active)))
        return st

    def tracker_step(*a, **kw):
        st, m = step(*a, **kw)
        jax.debug.callback(lambda i, act: rec["tracker"].append(
            (np.array(i), np.array(act))), m[0], m[4], ordered=True)
        return st, m

    def vio_step(pr, st, *a, **kw):
        st2, o = vio(pr, st, *a, **kw)
        jax.debug.callback(lambda *x: rec["steps"].append(tree(x)), st, a,
                           st2.ids, o["p"], ordered=True)
        return st2, o

    jwindow.WindowConfig = lambda **kw: cfg(**{
        **kw, "window": SIZE["window"], "max_feats": SIZE["max_feats"]})
    jtd.tracker_init, jtd.tracker_step, jed.vio_step = (
        tracker_init, tracker_step, vio_step)
    try:
        rows = jdvb.main(duration=DURATION, width=SIZE["width"],
                         height=SIZE["height"], n_feats=SIZE["n_feats"],
                         dtype_str=SIZE["dtype_str"], kappa=30)
    finally:
        jwindow.WindowConfig = cfg
        jtd.tracker_init, jtd.tracker_step, jed.vio_step = init, step, vio
    return rows, rec


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
            cam, tparams, tst, imgs[g], float(ts[g]))
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


def _kept(ids, active, prev_ids):
    """The slots a measurement kept from the frame before (a refilled slot
    takes a new id)."""
    return active & (ids == prev_ids)


def test_device_vio_bench_equals_the_jax_runner(port_run, jax_run):
    """The two runners on the same arguments and tracker seed. The frame
    counts and the hand-off frame equal, no fail flag on either. The
    tracker's measurements (ids, active) exact on every frame up to the
    first on which the two part; that frame must be the one known flip
    (ROADMAP queue C 5(c)): exactly one slot kept by one tracker and
    refilled by the other (measured: frame 5, one frame after the
    hand-off). The hand-off state: slot ids exact, window positions 1e-4 m
    (the host/device bound; measured 5.2e-8 m). Each of the JAX runner's
    device steps taken by the port's `vio_step` from the JAX state before
    it on the JAX inputs: slot ids exact, position 1e-4 m (measured
    6.5e-13 m)."""
    rows, rec = port_run
    jrows, jrec = jax_run
    n = rows["n_frames_device"]
    assert (n, rows["n_frames_total"]) == (jrows["n_frames_device"],
                                           jrows["n_frames_total"])
    assert rows["fail_flags"] == jrows["fail_flags"] == 0
    jtrack = jrec["tracker"][:len(jrec["tracker"]) - n]
    assert len(jtrack) == len(rec["tracker"]) == rows["n_frames_total"]
    assert len(jrec["steps"]) == 2 * n
    parted = None
    for f, ((ids, act), (jids, jact)) in enumerate(zip(rec["tracker"],
                                                       jtrack)):
        if np.array_equal(ids, jids) and np.array_equal(act, jact):
            continue
        prev = jtrack[f - 1][0]
        flips = _kept(ids, act, prev) != _kept(jids, jact, prev)
        assert flips.sum() == 1, (f, int(flips.sum()))
        parted = f
        break
    assert parted is None or parted >= rows["handoff_frame"]

    wcfg = WindowConfig(window=3, max_feats=48, iters=8, accum="f64")
    pr = ed.DeviceVioParams(wcfg=wcfg,
                            sel_cfg=ant.SelectorConfig(max_features=30))
    jhand = jrec["steps"][n][0]
    np.testing.assert_array_equal(rec["handoff"].ids, jhand.ids)
    np.testing.assert_allclose(rec["handoff"].p, jhand.p, rtol=0, atol=1e-4)
    for before, inputs, jids, jp in jrec["steps"][n:]:
        st = convert.device_vio_state_from_numpy(before, "cpu")
        x = [torch.from_numpy(np.array(v)) for v in inputs]
        x[1:4] = [v.double() for v in x[1:4]]
        st2, out = ed.vio_step(pr, st, *x, device="cpu")
        np.testing.assert_array_equal(st2.ids.numpy(), jids)
        np.testing.assert_allclose(out["p"].numpy(), jp, rtol=0, atol=1e-4)
