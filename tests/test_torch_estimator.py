"""Port vs JAX: the host estimator chain (models/estimator.py,
models/pipeline.py, estimator_device.vio_init_from_host,
utils/convert.host_estimator_*), f64, CPU.

Both packages run the same simulated stream (`analytic_trajectory(3.0)`,
0.3 px noise as in the reference's host/device parity fixture, 50 features
a frame, 25 frames) through `VioEstimator` with the small window of the JAX
package's own tests (window 6, 64 slots, 6 LM iterations). The JAX runs are
shared through module-scoped fixtures.

Tolerances. Per frame `p`, `v` atol 1e-4 and the slot DB (`ids`, `mask`)
exact — the JAX package's host/device bound (`tests/test_estimator_device.py`):
LM accept/reject amplifies summation-order noise, a semantic fault measures
1e-2 or more. Measured at 0.5 px: 7e-6 after 25 frames from the oracle
start, but 1.5e-4 with the selector (κ̄ = 20; ids exact every frame): the
marginalization's eigenvalue cut (`EIG_EPS`) keeps or drops a direction of
near-zero information in one package and not the other, which shows as an
offset of 1e-3 in the reported cost and a slow drift of the state; from the
real initialization (SfM scale 0.032 on this short stretch) the same
rounding grows to 3e-4 by frame 25. At 0.3 px all three runs stay under
2e-5 (the real initialization under 1.3e-6). `init_diag` is held to 1e-6.
The snapshot `vio_init_from_host` copies, so from the same host state it is
equal leaf by leaf to 1e-12.
"""

import copy
import types

import numpy as np
import jax
import pytest
import torch

from anticipated_vins_mono_tpu.models import anticipation as jant
from anticipated_vins_mono_tpu.models import estimator_device as jed
from anticipated_vins_mono_tpu.models.estimator import VioEstimator as JEst
from anticipated_vins_mono_tpu.models.feature_selector import \
    AttentionSelector as JSel
from anticipated_vins_mono_tpu.models.pipeline import run_sequence as jrun
from anticipated_vins_mono_tpu.ops.window import WindowConfig as JCfg
from anticipated_vins_mono_tpu.utils.sequence import SequenceSimulator as JSim
from anticipated_vins_mono_tpu.utils.synthetic import \
    analytic_trajectory as jtraj
from anticipated_vins_mono_torch.models import anticipation as tant
from anticipated_vins_mono_torch.models import estimator_device as ted
from anticipated_vins_mono_torch.models.estimator import VioEstimator as TEst
from anticipated_vins_mono_torch.models.feature_selector import \
    AttentionSelector as TSel
from anticipated_vins_mono_torch.models.pipeline import run_sequence as trun
from anticipated_vins_mono_torch.ops.window import WindowConfig as TCfg
from anticipated_vins_mono_torch.utils import convert
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator as TSim
from anticipated_vins_mono_torch.utils.synthetic import \
    analytic_trajectory as ttraj

torch.set_num_threads(1)

CFG = dict(window=6, max_feats=64, iters=6)
NF = CFG["window"] + 1
N_FRAMES = 25
HANDOVER_AT = 12
SEL = dict(horizon=6, max_features=20)


def _sims(mod_sim, traj):
    return mod_sim(traj, seed=0, pixel_noise=0.3, max_features=50)


def _oracle(traj):
    return {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}


def _record(est, rec):
    rec["p"].append(est.p.copy())
    rec["v"].append(est.v.copy())
    rec["ids"].append(est.db.ids.copy())
    rec["mask"].append(est.db.mask.copy())
    rec["initialized"].append(est.initialized)


def _new_rec():
    return {k: [] for k in ("p", "v", "ids", "mask", "initialized")}


def _jax_fields(est):
    """The state of a JAX host estimator as numpy, in the layout of
    `convert.host_estimator_from_numpy`."""
    out = {name: copy.deepcopy(getattr(est, name))
           for name in convert.HOST_FIELDS if hasattr(est, name)}
    out["db"] = {name: copy.deepcopy(getattr(est.db, name))
                 for name in convert.DB_FIELDS}
    out["prior"] = jax.tree_util.tree_map(np.array, est.prior)
    if est.selector is not None:
        out["selector"] = {name: copy.deepcopy(getattr(est.selector, name))
                           for name in convert.SELECTOR_FIELDS}
    return out


class _Recording:
    """The simulator as `run_sequence` sees it, recording the estimator's
    state after each `process_frame`, and calling `at_snapshot(est)` just
    before the frame `snapshot_at` is handed out."""

    def __init__(self, sim, est, snapshot_at=None, at_snapshot=None):
        self.sim, self.est, self.traj = sim, est, sim.traj
        self.snapshot_at, self.at_snapshot = snapshot_at, at_snapshot
        self.rec, self.snap = _new_rec(), None

    def frames(self, n_frames=None):
        for i, fm in enumerate(self.sim.frames(n_frames)):
            if i == self.snapshot_at:
                self.snap = self.at_snapshot(self.est)
            yield fm
            _record(self.est, self.rec)


def _jax_snapshot(est):
    return (_jax_fields(est),
            jax.tree_util.tree_map(np.array, jed.vio_init_from_host(est)))


def _jax_run(selector=False, oracle=True, snapshot_at=None):
    traj = jtraj(3.0)
    sel = JSel(jant.SelectorConfig(**SEL), max_candidates=64) \
        if selector else None
    est = JEst(JCfg(**CFG), init_state=_oracle(traj) if oracle else None,
               selector=sel)
    sim = _Recording(_sims(JSim, traj), est, snapshot_at, _jax_snapshot)
    res = jrun(est, sim, n_frames=N_FRAMES)
    return types.SimpleNamespace(est=est, rec=sim.rec, snap=sim.snap,
                                 res=res)


@pytest.fixture(scope="module")
def jax_oracle():
    return _jax_run(snapshot_at=HANDOVER_AT)


@pytest.fixture(scope="module")
def jax_selector():
    return _jax_run(selector=True)


@pytest.fixture(scope="module")
def jax_init():
    return _jax_run(oracle=False)


def _port_est(selector=False, oracle=True, impl="chol"):
    traj = ttraj(3.0)
    sel = TSel(tant.SelectorConfig(**SEL), max_candidates=64, impl=impl,
               device="cpu") if selector else None
    return traj, TEst(TCfg(**CFG), init_state=_oracle(traj) if oracle
                      else None, selector=sel, device="cpu")


def _assert_frames(trec, jrec, frames, atol=1e-4):
    for i in frames:
        assert trec["initialized"][i] == jrec["initialized"][i], i
        np.testing.assert_array_equal(trec["ids"][i], jrec["ids"][i],
                                      err_msg=f"ids, frame {i}")
        np.testing.assert_array_equal(trec["mask"][i], jrec["mask"][i],
                                      err_msg=f"mask, frame {i}")
        np.testing.assert_allclose(trec["p"][i], jrec["p"][i], rtol=0,
                                   atol=atol, err_msg=f"p, frame {i}")
        np.testing.assert_allclose(trec["v"][i], jrec["v"][i], rtol=0,
                                   atol=atol, err_msg=f"v, frame {i}")


def _assert_diag_counts(td, jd):
    for name in ("solves", "failures", "keyframes", "lm_stalls"):
        assert getattr(td, name) == getattr(jd, name), name
    for name in ("costs", "speeds", "imu_chi2s", "prior_chi2s"):
        assert len(getattr(td, name)) == len(getattr(jd, name)), name
    np.testing.assert_allclose(td.speeds, jd.speeds, rtol=0, atol=1e-4)


def _port_run(selector=False, oracle=True, impl="chol"):
    traj, est = _port_est(selector, oracle, impl)
    sim = _Recording(_sims(TSim, traj), est)
    res = trun(est, sim, n_frames=N_FRAMES)
    return types.SimpleNamespace(est=est, rec=sim.rec, res=res)


@pytest.fixture(scope="module")
def port_oracle():
    return _port_run()


def test_oracle_run_equals_jax_frame_by_frame(jax_oracle, port_oracle):
    est = port_oracle.est
    _assert_frames(port_oracle.rec, jax_oracle.rec, range(N_FRAMES))
    _assert_diag_counts(est.diag, jax_oracle.est.diag)
    assert est.diag.solves == N_FRAMES - NF + 1 and est.diag.failures == 0


def test_run_sequence_equals_jax(jax_oracle, port_oracle):
    """`run_sequence`'s result on the same stream: trajectory, ATE and RTE."""
    tres, jres = port_oracle.res, jax_oracle.res
    np.testing.assert_array_equal(tres.est_t, jres.est_t)
    np.testing.assert_allclose(tres.est_p, jres.est_p, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.est_q, jres.est_q, rtol=0, atol=1e-4)
    assert tres.ate == pytest.approx(jres.ate, abs=1e-4)
    assert tres.ate < 0.05
    for name, val in jres.rte_stats.items():
        assert tres.rte_stats[name] == pytest.approx(val, abs=1e-4)
    assert tres.diag is port_oracle.est.diag


@pytest.mark.parametrize("impl", ["chol", "lowrank"])
def test_selector_run_equals_jax_frame_by_frame(jax_selector, impl):
    """With the anticipation selector between the stream and the DB: the
    same ids reach the DB every frame (so the same selections), p/v 1e-4."""
    run = _port_run(selector=True, impl=impl)
    est = run.est
    _assert_frames(run.rec, jax_selector.rec, range(N_FRAMES))
    _assert_diag_counts(est.diag, jax_selector.est.diag)
    assert len(est.diag.sel_s) == len(jax_selector.est.diag.sel_s)
    assert est.selector.tracked_ids == jax_selector.est.selector.tracked_ids
    # the pipeline ran on some frames after the window filled (the others
    # had no new feature to rank or no budget left)
    assert 0 < est.selector.n_anticipate <= N_FRAMES - NF + 1


def test_real_initialization_equals_jax(jax_init):
    """No init state: SfM → gyro bias → linear alignment on the first full
    window, in the same frame, with the same diagnostics to 1e-6."""
    run = _port_run(oracle=False)
    rec = run.rec
    first = rec["initialized"].index(True)
    assert first == jax_init.rec["initialized"].index(True) == NF - 1
    for name, val in jax_init.est.init_diag.items():
        assert run.est.init_diag[name] == pytest.approx(val, rel=1e-6,
                                                        abs=1e-9)
    _assert_frames(rec, jax_init.rec, range(N_FRAMES))
    _assert_diag_counts(run.est.diag, jax_init.est.diag)


def _handed_over(fields):
    traj, est = _port_est()
    convert.host_estimator_from_numpy(fields, est)
    return traj, est


def test_handover_from_a_jax_estimator_mid_run(jax_oracle):
    """The JAX estimator's state after frame 12, carried into a port
    estimator by `convert.host_estimator_from_numpy`; both then take the
    remaining frames: p/v 1e-4 and slots exact every frame."""
    fields, _ = jax_oracle.snap
    traj, est = _handed_over(fields)
    frames = list(_sims(TSim, traj).frames(N_FRAMES))
    rec = _new_rec()
    for fm in frames[HANDOVER_AT:]:
        est.process_frame(fm)
        _record(est, rec)
    jrec = {k: v[HANDOVER_AT:] for k, v in jax_oracle.rec.items()}
    _assert_frames(rec, jrec, range(N_FRAMES - HANDOVER_AT))


def test_host_estimator_numpy_round_trip(jax_oracle):
    """to_numpy(from_numpy(fields)) gives the fields back, as copies."""
    fields, _ = jax_oracle.snap
    _, est = _handed_over(fields)
    back = convert.host_estimator_to_numpy(est)
    for name in ("p", "q", "v", "ba", "bg", "tic", "qic", "stationary",
                 "td_at_frame"):
        np.testing.assert_array_equal(back[name], fields[name])
        assert not np.shares_memory(back[name], fields[name])
    for name in ("n_frames", "initialized", "frame_times", "_speed_hist"):
        assert back[name] == fields[name]
    for a, b in zip(back["imu_pairs"], fields["imu_pairs"]):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
    for name in convert.DB_FIELDS:
        np.testing.assert_array_equal(back["db"][name], fields["db"][name])
    for a, b in zip(jax.tree_util.tree_leaves(back["prior"]),
                    jax.tree_util.tree_leaves(fields["prior"])):
        np.testing.assert_array_equal(a, b)
    est.db.ids[:] = -7
    assert (fields["db"]["ids"] != -7).any()


def test_vio_init_from_host_equals_jax_leaf_by_leaf(jax_oracle):
    """From the same host state (the JAX estimator's after frame 12, handed
    over), the port's snapshot equals the JAX snapshot leaf by leaf."""
    fields, jsnap = jax_oracle.snap
    _, est = _handed_over(fields)
    tsnap = convert.to_numpy_tree(ted.vio_init_from_host(est))
    for name in ted.DeviceVioState._fields:
        a, b = getattr(tsnap, name), getattr(jsnap, name)
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype, name
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12,
                                       err_msg=name)


def test_vio_init_from_host_then_vio_step_tracks_the_host(jax_oracle):
    """The port's own hand-off (host estimator → `vio_init_from_host` →
    `vio_step`) against the port's host estimator on the same frames: p/v
    1e-4, the reference's host/device bound."""
    fields, _ = jax_oracle.snap
    traj, est = _handed_over(fields)
    st = ted.vio_init_from_host(est)
    pr = ted.DeviceVioParams(wcfg=est.cfg)
    frames = list(_sims(TSim, traj).frames(N_FRAMES))
    for fm in frames[HANDOVER_AT:HANDOVER_AT + 6]:
        st, out = ted.vio_step(pr, st, *ted.pack_frame(fm, 64, device="cpu"),
                               device="cpu")
        est.process_frame(fm)
        np.testing.assert_allclose(out["p"].numpy(), est.p[NF - 2],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["v"].numpy(), est.v[NF - 2],
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(st.ids.numpy(), est.db.ids)
    np.testing.assert_array_equal(st.mask.numpy(), est.db.mask)


def test_device_copies_do_not_alias_the_host_arrays(jax_oracle):
    """The tensors a solve used (`last_solve`: `_device_state` and
    `_measurements`) and a `vio_init_from_host` snapshot are copies: the
    host's in-place slides and shifts afterwards leave them as they were (on
    the CPU `torch.from_numpy` / `as_tensor` would share memory)."""
    fields, _ = jax_oracle.snap
    traj, est = _handed_over(fields)
    est.process_frame(list(_sims(TSim, traj).frames(N_FRAMES))[HANDOVER_AT])
    st, meas, _ = est.last_solve
    snap = ted.vio_init_from_host(est)
    used = (st.p, st.q, st.v, st.ba, st.bg, st.inv_depth, meas.pts,
            meas.vel, meas.mask, meas.feat_valid, snap.p, snap.v, snap.pts,
            snap.vel, snap.mask, snap.inv_depth, snap.stationary)
    before = [x.clone() for x in used]
    est._shift_state(0)
    est._slide_oldest_db()
    est.db.slide_second_newest()
    est.db.inv_depth[:] = 3.0
    est.p[:] = 7.0
    est.stationary[:] = 1.0
    for a, b in zip(before, used):
        assert torch.equal(a, b)


def test_estimator_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises((RuntimeError, AssertionError)):
        TEst(TCfg(**CFG))
