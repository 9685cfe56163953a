"""Port vs JAX: models/estimator_device.py (f64, CPU) — every helper of the
per-frame step on the JAX package's own hand-off state, and `vio_step` frame
after frame against the JAX `vio_step`.

One module-scoped fixture runs the JAX hand-off once: the host
`VioEstimator` up to its first full window, `vio_init_from_host`, then 14 JAX
`vio_step`s whose states and outputs are kept as numpy.

Tolerances. Single helpers on the same f64 inputs: 1e-12 (same algebra,
other summation order), slot bookkeeping (ids, masks, flags) exact.
Multi-frame runs: the JAX package's own host/device bounds
(`tests/test_estimator_device.py`): `out["p"]`, `out["v"]` atol 1e-4 per
frame, after the last frame `ids` and `mask` exact, `inv_depth` atol 1e-5,
`p`, `ba` of frames 0..NF−2 atol 1e-3 — LM accept/reject amplifies
summation-order noise (~1e-13 a frame) to ~1e-5 over 14 frames, while a
semantic fault measures 1e-2 or more.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.models import anticipation as jant
from anticipated_vins_mono_tpu.models import estimator_device as jed
from anticipated_vins_mono_tpu.models.estimator import VioEstimator
from anticipated_vins_mono_tpu.ops import window as jw
from anticipated_vins_mono_tpu.utils import sequence as jseq
from anticipated_vins_mono_tpu.utils import synthetic as jsyn
from anticipated_vins_mono_torch.models import anticipation as tant
from anticipated_vins_mono_torch.models import estimator_device as ted
from anticipated_vins_mono_torch.ops import window as tw
from anticipated_vins_mono_torch.utils import convert
from anticipated_vins_mono_torch.utils import sequence as tseq
from anticipated_vins_mono_torch.utils import synthetic as tsyn
from anticipated_vins_mono_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

CFG = dict(window=10, max_feats=64, iters=8)
JCFG, TCFG = jw.WindowConfig(**CFG), tw.WindowConfig(**CFG)
F, NF = TCFG.max_feats, TCFG.nf
JPR, TPR = jed.DeviceVioParams(wcfg=JCFG), ted.DeviceVioParams(wcfg=TCFG)
N_CHECK = 14
DB_FIELDS = ("ids", "pts", "vel", "prob", "mask", "inv_depth", "solved")


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _to_torch(jstate):
    return convert.device_vio_state_from_numpy(_np_tree(jstate), "cpu")


def _to_jax(np_state):
    """A numpy tree of a `DeviceVioState` (either package's) → the JAX
    package's, copied."""
    prior = np_state.prior
    jprior = jw.PriorFactor(
        J0=jnp.array(prior.J0), r0=jnp.array(prior.r0),
        lin=jw.WindowState(*(None if x is None else jnp.array(x)
                             for x in prior.lin)),
        weight=jnp.array(prior.weight))
    vals = {n: jnp.array(getattr(np_state, n))
            for n in jed.DeviceVioState._fields if n != "prior"}
    return jed.DeviceVioState(prior=jprior, **vals)


def _tpack(fm):
    return ted.pack_frame(fm, F, device="cpu")


def _hover_trajectory(mod, lie_rot):
    """The hover trajectory of the JAX package's non-keyframe test: the
    analytic trajectory, stopped dead after 3 s."""
    tr = mod.analytic_trajectory(9.0)
    k_stop = int(3.0 * 200)
    p, v, q = tr.p.copy(), tr.v.copy(), tr.q.copy()
    acc, gyr = tr.acc_body.copy(), tr.gyr_body.copy()
    p[k_stop:] = p[k_stop]
    v[k_stop:] = 0
    q[k_stop:] = q[k_stop]
    acc[k_stop:] = lie_rot(q[k_stop]).T @ np.array([0, 0, 9.81007])
    gyr[k_stop:] = 0
    return mod.Trajectory(tr.t, p, q, v, acc, gyr)


def _handoff(traj, max_features=40):
    """The JAX package's hand-off: its simulator, its host estimator run to
    the first full window, `vio_init_from_host`."""
    sim = jseq.SequenceSimulator(traj, seed=0, pixel_noise=0.3,
                                 max_features=max_features)
    est = VioEstimator(JCFG, init_state={
        "p": traj.p[0], "q": traj.q[0], "v": traj.v[0]})
    frames = list(sim.frames())
    i = 0
    while not (est.initialized and est.n_frames == NF - 1):
        est.process_frame(frames[i])
        i += 1
    return frames, i, jed.vio_init_from_host(est)


@pytest.fixture(scope="module")
def ref():
    traj = jsyn.analytic_trajectory(8.0)
    frames, i, dst = _handoff(traj)
    states, outs = [_np_tree(dst)], []
    for fm in frames[i:i + N_CHECK]:
        dst, out = jed.vio_step(JPR, dst, *jed.pack_frame(fm, F))
        states.append(_np_tree(dst))
        outs.append(_np_tree(out))
    return types.SimpleNamespace(traj=traj, frames=frames, i=i,
                                 states=states, outs=outs)


def _pair(ref, n):
    """The state after n JAX steps, in both packages, and the next frame."""
    np_state = ref.states[n]
    return (_to_jax(np_state), convert.device_vio_state_from_numpy(
        np_state, "cpu"), ref.frames[ref.i + n])


def _assert_db_equal(tst, jst, atol=1e-12):
    tst = convert.to_numpy_tree(tst)
    for name in DB_FIELDS:
        a, b = getattr(tst, name), np.asarray(getattr(jst, name))
        if name in ("ids", "mask", "solved"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# helpers, each against its JAX counterpart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [True, False])
def test_propagate_equals_the_jax_scan(ref, padded):
    """The prefix-product form against the sample-by-sample scan, on a
    buffer with dt = 0 padding (20 of 64 rows valid, junk in the padding)
    and on a full one."""
    jst, st, fm = _pair(ref, 3)
    rng = np.random.default_rng(0)
    S = ted.MAX_IMU_PER_PAIR
    n = 20 if padded else S
    dts = np.zeros(S)
    dts[:n] = 0.005
    acc = np.tile(fm.imu_acc, (4, 1))[:S] + rng.normal(size=(S, 3)) * 0.1
    gyr = np.tile(fm.imu_gyr, (4, 1))[:S] + rng.normal(size=(S, 3)) * 0.01
    k = NF - 2
    jout = jed._propagate(jst.p[k], jst.q[k], jst.v[k], jst.ba[k] + 0.01,
                          jst.bg[k] - 0.001, jnp.asarray(dts),
                          jnp.asarray(acc), jnp.asarray(gyr),
                          jnp.asarray(fm.acc0), jnp.asarray(fm.gyr0))
    t = torch.tensor
    tout = ted._propagate(st.p[k], st.q[k], st.v[k], st.ba[k] + 0.01,
                          st.bg[k] - 0.001, t(dts), t(acc), t(gyr),
                          t(fm.acc0), t(fm.gyr0))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    assert np.linalg.norm(np.asarray(jout[0]) - np.asarray(jst.p[k])) > 0.01


def test_propagate_skips_interior_zero_dt_rows(ref):
    """A dt = 0 row in the middle is skipped and the next row's midpoint
    takes the last VALID sample, as the scan's carried sample does."""
    jst, st, fm = _pair(ref, 3)
    S = ted.MAX_IMU_PER_PAIR
    dts, acc, gyr = np.zeros(S), np.zeros((S, 3)), np.zeros((S, 3))
    dts[:20], acc[:20], gyr[:20] = fm.imu_dts, fm.imu_acc, fm.imu_gyr
    dts[7] = 0.0
    acc[7], gyr[7] = 50.0, 3.0
    k = NF - 2
    jout = jed._propagate(jst.p[k], jst.q[k], jst.v[k], jst.ba[k], jst.bg[k],
                          jnp.asarray(dts), jnp.asarray(acc), jnp.asarray(gyr),
                          jnp.asarray(fm.acc0), jnp.asarray(fm.gyr0))
    t = torch.tensor
    tout = ted._propagate(st.p[k], st.q[k], st.v[k], st.ba[k], st.bg[k],
                          t(dts), t(acc), t(gyr), t(fm.acc0), t(fm.gyr0))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("still", [False, True])
def test_zupt_flag_equals_jax(ref, still):
    _, st, fm = _pair(ref, 0)
    S = ted.MAX_IMU_PER_PAIR
    dts, acc, gyr = np.zeros(S), np.zeros((S, 3)), np.zeros((S, 3))
    dts[:20] = fm.imu_dts
    if still:
        acc[:20] = [0.0, 0.0, 9.81]
    else:
        acc[:20], gyr[:20] = fm.imu_acc, fm.imu_gyr
    bg = np.zeros(3)
    jflag = jed._zupt_flag(JPR, jnp.asarray(dts), jnp.asarray(acc),
                           jnp.asarray(gyr), jnp.asarray(bg))
    t = torch.tensor
    tflag = ted._zupt_flag(TPR, t(dts), t(acc), t(gyr), t(bg))
    assert float(tflag) == float(jflag) == float(still)
    # an empty buffer is never stationary
    z = np.zeros(S)
    assert float(ted._zupt_flag(TPR, t(z), t(acc * 0), t(gyr * 0), t(bg))) \
        == float(jed._zupt_flag(JPR, jnp.asarray(z), jnp.asarray(acc * 0),
                                jnp.asarray(gyr * 0), jnp.asarray(bg))) == 0.0


def test_first_true_follows_jnp_argmax():
    rows = np.array([[0, 1, 0, 1], [0, 0, 0, 0], [1, 1, 1, 1], [0, 0, 0, 1]],
                    bool)
    np.testing.assert_array_equal(
        ted._first_true(torch.tensor(rows), 1).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(rows), axis=1)))
    np.testing.assert_array_equal(
        ted._first_true(torch.tensor(rows), 1).numpy(), [1, 0, 0, 3])


def _add_frame_both(jst, st, fm, k=NF - 1, slot_evict=True, edit=None):
    jargs = list(jed.pack_frame(fm, F)[:5])
    targs = list(_tpack(fm)[:5])
    if edit is not None:
        edit(jargs, lambda x, i, v: x.at[i].set(v))
        edit(targs, lambda x, i, v: ted._set_row(x, i, v))
    jout = jed._db_add_frame(jst, k, *jargs, JPR.min_parallax,
                             slot_evict=slot_evict)
    tout = ted._db_add_frame(st, k, *targs, TPR.min_parallax,
                             slot_evict=slot_evict)
    _assert_db_equal(tout[0], jout[0])
    assert bool(tout[1]) == bool(jout[1])
    assert float(tout[2]) == float(jout[2])
    return tout, jout


def test_db_add_frame_equals_jax(ref):
    jst, st, fm = _pair(ref, 2)
    (tst, _, tracked), _ = _add_frame_both(jst, st, fm)
    assert float(tracked) >= 20
    n_obs = int((tst.mask[:, NF - 1] > 0).sum())
    assert float(tracked) < n_obs <= len(fm.feats)


def test_db_add_frame_duplicate_input_id_takes_the_first(ref):
    """Two active inputs with one id give a slot row with two matches: both
    packages take the first."""
    jst, st, fm = _pair(ref, 2)

    def edit(args, put):
        args[0] = put(args[0], 5, args[0][2])        # ids[5] = ids[2]
    _add_frame_both(jst, st, fm, edit=edit)


def _with_junk_and_no_free_slot(np_state, fm):
    """Five slots that this frame does not observe, and every free slot,
    turned into junk: a fresh id with one old observation."""
    unmatched = np.nonzero(~np.isin(np_state.ids, list(fm.feats)))[0]
    junk = np.union1d(unmatched[:5], np.nonzero(np_state.ids < 0)[0])
    ids, mask = np_state.ids.copy(), np_state.mask.copy()
    pts = np_state.pts.copy()
    ids[junk] = 100_000 + np.arange(len(junk), dtype=np.int32)
    mask[junk] = 0.0
    mask[junk, 4] = 1.0
    pts[junk, 4] = [0.1, -0.1, 1.0]
    return np_state._replace(ids=ids, mask=mask, pts=pts), junk


@pytest.mark.parametrize("slot_evict", [True, False])
def test_db_add_frame_with_no_free_slot(ref, slot_evict):
    """DB full: new features take the junk slots (one old observation, none
    in the previous frame) in index order, or are dropped without
    `slot_evict`."""
    fm = ref.frames[ref.i + 2]
    full, junk = _with_junk_and_no_free_slot(ref.states[2], fm)
    assert len(junk) >= 5 and np.all(full.ids >= 0)
    jst, st = _to_jax(full), convert.device_vio_state_from_numpy(full, "cpu")
    (tst, _, _), _ = _add_frame_both(jst, st, fm, slot_evict=slot_evict)
    evicted = np.nonzero(tst.ids.numpy()[junk] < 100_000)[0]
    if slot_evict:
        # the first junk slots by index, as many as there are new features
        assert len(evicted) > 0
        np.testing.assert_array_equal(evicted, np.arange(len(evicted)))
    else:
        assert len(evicted) == 0


def test_demote_outliers_equals_jax(ref):
    np_state = ref.states[5]
    solved = np.nonzero((np_state.solved > 0) & (np_state.ids >= 0)
                        & (np_state.mask.sum(1) >= 3))[0]
    inv_depth, pts = np_state.inv_depth.copy(), np_state.pts.copy()
    inv_depth[solved[0]] = TCFG.min_inv_depth        # collapsed depth
    anchor = int(np.argmax(np_state.mask[solved[1]] > 0))
    pts[solved[1], anchor + 1:, 0] += 0.05           # ~23 px off the anchor
    bad = np_state._replace(inv_depth=inv_depth, pts=pts)
    jout = jed._demote_outliers(_to_jax(bad), JPR)
    tout = ted._demote_outliers(
        convert.device_vio_state_from_numpy(bad, "cpu"), TPR)
    _assert_db_equal(tout, jout)
    assert tout.solved[solved[0]] == 0 and tout.solved[solved[1]] == 0
    assert float(tout.inv_depth[solved[1]]) == 0.2
    assert int(tout.solved.sum()) <= int(np_state.solved.sum()) - 2


@pytest.mark.parametrize("name", ["_slide_oldest_db",
                                  "_slide_second_newest_db"])
def test_db_slides_equal_jax(ref, name):
    jst, st, fm = _pair(ref, 4)
    # a window that holds a newest frame, as at the point of the slide
    jst, _, _ = jed._db_add_frame(jst, NF - 1, *jed.pack_frame(fm, F)[:5],
                                  JPR.min_parallax)
    st, _, _ = ted._db_add_frame(st, NF - 1, *_tpack(fm)[:5],
                                 TPR.min_parallax)
    before = st.ids.clone()
    _assert_db_equal(getattr(ted, name)(st, TCFG),
                     getattr(jed, name)(jst, JCFG))
    assert torch.equal(st.ids, before)


@pytest.mark.parametrize("na,nb", [(20, 20), (40, 40), (64, 1), (0, 20)])
def test_merge_pair_buffers_equals_jax(na, nb):
    """Under the 64-sample cap the buffers are joined; over it adjacent
    samples are fused pairwise."""
    rng = np.random.default_rng(na + nb)
    S = ted.MAX_IMU_PER_PAIR

    def buf(n):
        d, a, g = np.zeros(S), np.zeros((S, 3)), np.zeros((S, 3))
        d[:n] = rng.uniform(0.004, 0.006, n)
        a[:n], g[:n] = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
        return d, a, g

    args = buf(na) + buf(nb)
    jout = jed._merge_pair_buffers(*(jnp.asarray(x) for x in args))
    tout = ted._merge_pair_buffers(*(torch.tensor(x) for x in args))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    assert int((tout[0] > 0).sum()) == (na + nb if na + nb <= S
                                        else (na + nb + 1) // 2)
    np.testing.assert_allclose(float(tout[0].sum()),
                               args[0].sum() + args[3].sum(), rtol=1e-12)


def test_device_reboot_equals_jax(ref):
    jst, st, fm = _pair(ref, 6)
    acc0 = np.array([0.3, -0.2, 9.7])
    jout = _np_tree(jed._device_reboot(JPR, jst, jnp.asarray(acc0)))
    tout = convert.to_numpy_tree(ted._device_reboot(TPR, st,
                                                    torch.tensor(acc0)))
    jl, tl = jax.tree_util.tree_leaves(jout), tree_leaves(tout)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    # the watermark survives the reboot, as in the JAX package
    assert int(tout.last_id) == int(ref.states[6].last_id) >= 0
    assert int(tout.since_fail) == 0 and np.all(tout.ids == -1)


def test_select_stage_equals_jax(ref, monkeypatch):
    """Gated mask and watermark exact (f64: both scorings resolve the
    gains)."""
    monkeypatch.setenv("ANT_SELECT_IMPL", "chol")
    monkeypatch.setenv("ANT_SELECT_GROUP", "1")
    jpr = JPR._replace(sel_cfg=jant.SelectorConfig(max_features=37))
    tpr = TPR._replace(sel_cfg=tant.SelectorConfig(max_features=37),
                       sel_impl="chol")
    jst, st, fm = _pair(ref, 3)
    # an older watermark, so that the new ids of this frame are candidates
    new_ids = [i for i in fm.feats if i not in set(ref.states[3].ids.tolist())]
    assert len(new_ids) >= 2
    low = np.int32(min(new_ids) - 1)
    jst = jst._replace(last_id=jnp.asarray(low))
    st = st._replace(last_id=torch.tensor(low))
    jargs, targs = jed.pack_frame(fm, F), _tpack(fm)
    jgated, jlast = jed._select_stage(jpr, jst, NF - 1, *jargs[:8])
    tgated, tlast = ted._select_stage(tpr, st, NF - 1, *targs[:8])
    np.testing.assert_array_equal(tgated.numpy(), np.asarray(jgated))
    assert int(tlast) == int(jlast) == max(fm.feats)
    assert tlast.dtype == torch.int32
    tracked = sum(i in set(ref.states[3].ids.tolist()) for i in fm.feats)
    assert tracked < int(tgated.sum()) <= 37


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _run_port(pr, st, frames):
    outs = []
    for fm in frames:
        st, out = ted.vio_step(pr, st, *_tpack(fm), device="cpu")
        outs.append(out)
    return st, outs


def test_vio_step_follows_jax_over_14_frames(ref):
    st0 = convert.device_vio_state_from_numpy(ref.states[0], "cpu")
    before = convert.to_numpy_tree(st0)
    st, outs = _run_port(TPR, st0, ref.frames[ref.i:ref.i + N_CHECK])
    for out, jout in zip(outs, ref.outs):
        assert not bool(out["fail"]) and not bool(jout["fail"])
        assert bool(out["keyframe"]) == bool(jout["keyframe"])
        np.testing.assert_allclose(out["p"].numpy(), jout["p"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(out["v"].numpy(), jout["v"], rtol=0,
                                   atol=1e-4)
        assert float(out["tracked"]) == float(jout["tracked"])
        assert int(out["n_live"]) == int(jout["n_live"])
        assert out["t_slot"] == NF - 2
    last = ref.states[-1]
    np.testing.assert_array_equal(st.ids.numpy(), last.ids)
    np.testing.assert_array_equal(st.mask.numpy(), last.mask)
    np.testing.assert_allclose(st.inv_depth.numpy(), last.inv_depth, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(st.p[:NF - 1].numpy(), last.p[:NF - 1], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(st.ba[:NF - 1].numpy(), last.ba[:NF - 1],
                               rtol=0, atol=1e-3)
    assert int(st.n_solves) == N_CHECK == int(last.n_solves)
    # vio_step left the state it was given as it was
    for a, b in zip(tree_leaves(convert.to_numpy_tree(st0)),
                    tree_leaves(before)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kappa,n_frames", [(12, 10), (36, 6)])
def test_vio_step_with_selector_admits_the_jax_ids(ref, monkeypatch, kappa,
                                                   n_frames):
    """The ids admitted per frame equal the JAX run's, never more than κ̄, no
    failure. With κ̄ = 12 the 34–39 tracked features use up the budget and
    nothing new is admitted (the JAX package's own test case); with κ̄ = 36
    the gate admits some of the new ids and rejects others."""
    monkeypatch.setenv("ANT_SELECT_IMPL", "chol")
    monkeypatch.setenv("ANT_SELECT_GROUP", "1")
    jpr = JPR._replace(sel_cfg=jant.SelectorConfig(max_features=kappa))
    tpr = TPR._replace(sel_cfg=tant.SelectorConfig(max_features=kappa),
                       sel_impl="chol")
    jst = _to_jax(ref.states[0])
    st = convert.device_vio_state_from_numpy(ref.states[0], "cpu")
    live = lambda ids: set(np.asarray(ids)[np.asarray(ids) >= 0].tolist())
    n_admitted = n_rejected = 0
    for fm in ref.frames[ref.i:ref.i + n_frames]:
        jbefore = live(jst.ids)
        jst, jout = jed.vio_step(jpr, jst, *jed.pack_frame(fm, F))
        st, out = ted.vio_step(tpr, st, *_tpack(fm), device="cpu")
        admitted = live(st.ids.numpy()) - jbefore
        assert admitted == live(jst.ids) - jbefore
        assert len(admitted) <= kappa
        n_rejected += len(set(fm.feats) - live(st.ids.numpy()))
        assert not bool(out["fail"]) and not bool(jout["fail"])
        np.testing.assert_array_equal(st.ids.numpy(), np.asarray(jst.ids))
        np.testing.assert_allclose(out["p"].numpy(), np.asarray(jout["p"]),
                                   rtol=0, atol=1e-4)
        n_admitted += len(admitted)
    assert (n_admitted > 0) == (kappa == 36) and n_rejected > 0
    assert int(st.last_id) == int(jst.last_id) == max(fm.feats)
    assert np.isfinite(float(out["cost"]))


def test_vio_step_nonkeyframe_branch_follows_jax():
    """Hover → low parallax → non-keyframe slides: the prior-only Schur drop
    and the raw-IMU pair merge, 25 frames against JAX."""
    from anticipated_vins_mono_tpu.ops import lie as jlie
    traj = _hover_trajectory(
        jsyn, lambda q: np.asarray(jlie.quat_to_rot(jnp.asarray(q))))
    # the port's own function for that trajectory gives the same one
    for a, b in zip(tsyn.stopped_trajectory(9.0, 3.0), traj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    frames, i, jst = _handoff(traj)
    st = _to_torch(jst)
    kfs = []
    for fm in frames[i:i + 25]:
        jst, jout = jed.vio_step(JPR, jst, *jed.pack_frame(fm, F))
        st, out = ted.vio_step(TPR, st, *_tpack(fm), device="cpu")
        assert bool(out["keyframe"]) == bool(jout["keyframe"])
        assert not bool(out["fail"])
        kfs.append(bool(out["keyframe"]))
        np.testing.assert_allclose(out["p"].numpy(), np.asarray(jout["p"]),
                                   rtol=0, atol=1e-4)
    assert not all(kfs), "hover never produced a non-keyframe slide"
    np.testing.assert_array_equal(st.ids.numpy(), np.asarray(jst.ids))
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(jst.mask))
    np.testing.assert_allclose(st.imu_dts.numpy(), np.asarray(jst.imu_dts),
                               rtol=0, atol=1e-12)


def test_vio_scan_equals_steps(ref):
    """Same program: atol 1e-12."""
    st0 = convert.device_vio_state_from_numpy(ref.states[0], "cpu")
    packed = [_tpack(fm) for fm in ref.frames[ref.i:ref.i + 4]]
    st1, outs = st0, []
    for pk in packed:
        st1, o = ted.vio_step(TPR, st1, *pk, device="cpu")
        outs.append(o)
    stacked = tuple(torch.stack([pk[j] for pk in packed]) for j in range(10))
    st2, so = ted.vio_scan(TPR, st0, *stacked, device="cpu")
    for a, b in zip(tree_leaves(convert.to_numpy_tree(st2)),
                    tree_leaves(convert.to_numpy_tree(st1))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert set(so) == set(outs[0])
    for name in ("p", "v", "cost", "speed"):
        np.testing.assert_allclose(
            so[name].numpy(), np.stack([o[name].numpy() for o in outs]),
            rtol=0, atol=1e-12)
    assert so["p"].shape == (4, 3) and so["t_slot"].tolist() == [NF - 2] * 4
    assert so["keyframe"].tolist() == [bool(o["keyframe"]) for o in outs]


def test_reboot_bounds_corruption():
    """+30 m/s and +50 m on the carried state trip the failure flag; the
    device-side reboot keeps the state finite, restarts the trajectory near
    the origin and keeps the speeds an order of magnitude below the
    corruption (the JAX package's own bounds for this scenario)."""
    traj = tsyn.analytic_trajectory(5.0)
    sim = tseq.SequenceSimulator(traj, seed=0, pixel_noise=0.3,
                                 max_features=40)
    frames = list(sim.frames())
    packed = [_tpack(fm) for fm in frames]
    st = ted.vio_init_oracle(TPR, {"p": traj.p[0], "q": traj.q[0],
                                   "v": traj.v[0]}, packed[:NF - 1],
                             device="cpu")
    for pk in packed[NF - 1:NF + 2]:
        st, out = ted.vio_step(TPR, st, *pk, device="cpu")
        assert not bool(out["fail"])
    watermark = int(st.last_id)
    st = st._replace(v=st.v + 30.0, p=st.p + 50.0)
    fails, ps, speeds = [], [], []
    for pk in packed[NF + 2:NF + 14]:
        st, out = ted.vio_step(TPR, st, *pk, device="cpu")
        fails.append(bool(out["fail"]))
        ps.append(out["p"].numpy())
        speeds.append(float(out["speed"]))
    assert any(fails[:8]), "corruption never tripped the failure detector"
    k_fail = fails.index(True)
    ps = np.stack(ps)
    assert np.all(np.isfinite(ps))
    assert all(np.all(np.isfinite(x)) for x in
               tree_leaves(convert.to_numpy_tree(st)))
    assert np.linalg.norm(ps[k_fail + 1]) < 5.0, ps[k_fail + 1]
    assert max(speeds[k_fail + 1:]) < 12.0, max(speeds[k_fail + 1:])
    assert int(st.since_fail) == len(fails) - k_fail - 1
    assert float(st.prior.weight) == 0.0 and int(st.last_id) >= watermark


def test_init_oracle_then_one_step_is_the_host_handoff(ref):
    """`vio_init_oracle` on the first NF−1 frames and one `vio_step` give the
    state the JAX package hands over after its host estimator's first
    full-window frame."""
    frames = ref.frames
    assert ref.i == NF
    packed = [_tpack(fm) for fm in frames[:NF]]
    init = {"p": ref.traj.p[0], "q": ref.traj.q[0], "v": ref.traj.v[0]}
    st = ted.vio_init_oracle(TPR, init, packed[:NF - 1], device="cpu")
    assert float(st.prior.weight) == 0.0 and int(st.since_fail) == 10_000
    assert int(st.last_id) == max(max(fm.feats) for fm in frames[:NF - 1])
    assert float(st.mask[:, NF - 1].sum()) == 0.0
    st, out = ted.vio_step(TPR, st, *packed[NF - 1], device="cpu")
    host = ref.states[0]
    assert not bool(out["fail"])
    np.testing.assert_array_equal(st.ids.numpy(), host.ids)
    np.testing.assert_array_equal(st.mask.numpy(), host.mask)
    np.testing.assert_allclose(st.p[:NF - 1].numpy(), host.p[:NF - 1], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(st.v[:NF - 1].numpy(), host.v[:NF - 1], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(st.imu_dts.numpy()[:NF - 2],
                               host.imu_dts[:NF - 2], rtol=0, atol=1e-15)
    assert float(st.prior.weight) == 1.0
    with pytest.raises(ValueError):
        ted.vio_init_oracle(TPR, init, packed[:3], device="cpu")


def test_entry_points_raise_without_a_card(ref):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    st = convert.device_vio_state_from_numpy(ref.states[0], "cpu")
    pk = _tpack(ref.frames[ref.i])
    stacked = tuple(x[None] for x in pk)
    with pytest.raises((RuntimeError, AssertionError)):
        ted.vio_step(TPR, st, *pk)
    with pytest.raises((RuntimeError, AssertionError)):
        ted.vio_scan(TPR, st, *stacked)
    with pytest.raises((RuntimeError, AssertionError)):
        ted.vio_init_oracle(TPR, {"p": np.zeros(3), "q": [1.0, 0, 0, 0]},
                            [pk] * (NF - 1))
    with pytest.raises((RuntimeError, AssertionError)):
        ted.pack_frame(ref.frames[0], F)
    with pytest.raises((RuntimeError, AssertionError)):
        convert.device_vio_state_from_numpy(ref.states[0])


def test_state_conversion_copies_and_keeps_dtypes(ref):
    src = ref.states[3]
    st = convert.device_vio_state_from_numpy(src, "cpu")
    assert isinstance(st, ted.DeviceVioState)
    assert isinstance(st.prior, tw.PriorFactor)
    assert isinstance(st.prior.lin, tw.WindowState)
    assert st.prior.lin.relo_p is None
    assert ted.DeviceVioState._fields == jed.DeviceVioState._fields
    for name in ("ids", "n_solves", "last_id", "since_fail"):
        assert getattr(st, name).dtype == torch.int32, name
    assert st.p.dtype == torch.float64 and st.prior.J0.shape == (TCFG.dim,) * 2
    before = src.p.copy()
    st.p.add_(1.0)
    st.prior.J0.zero_()
    np.testing.assert_array_equal(src.p, before)
    assert np.any(src.prior.J0 != 0)
    back = convert.device_vio_state_to_numpy(st)
    assert isinstance(back, ted.DeviceVioState) and back.ids.dtype == np.int32
    back.q[...] = 7.0
    assert not np.any(st.q.numpy() == 7.0)
    # the two parameter fields the JAX package lacks, and nothing else
    assert ted.DeviceVioParams._fields == \
        jed.DeviceVioParams._fields + ("sel_impl", "sel_group")
    tdef, jdef = ted.DeviceVioParams()._asdict(), jed.DeviceVioParams()._asdict()
    for name in jdef:
        if name not in ("wcfg", "noise"):
            assert tdef[name] == jdef[name], name
    assert tdef["sel_impl"] is None and tdef["sel_group"] is None
