"""Port vs JAX: relocalization through the host estimator
(`VioEstimator.set_relo_frame` → the next `process_frame`'s window solve
with the relo pose as a variable → `relo_result`), f64, CPU.

The fixture of the JAX package's own test (`tests/test_relocalization.py`):
`analytic_trajectory(4.0)`, 0.3 px noise, 50 features a frame, window 6
with 64 slots and 10 LM iterations, the oracle start, 24 frames; after
frame 19 a "loop keyframe" at the ground-truth pose of frame 16 is
fabricated with the current solved landmarks projected into it. The same
frames and the same matches go into both packages: the port starts from the
JAX estimator's state after frame 19 (`convert.host_estimator_from_numpy`),
so the relo solve is one LM solve on the same inputs (the host chain's own
run-to-run parity is `tests/test_torch_estimator.py`'s). The JAX run is
shared through a module-scoped fixture.

Tolerances: `relo_result` (rel_t, rel_q) and the window's p, q 1e-6; the
oracle of the JAX test (ground-truth relative pose, 5 cm / 3°).
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models.estimator import VioEstimator as JEst
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.ops.window import WindowConfig as JCfg
from anticipated_vins_mono_tpu.utils.sequence import SequenceSimulator as JSim
from anticipated_vins_mono_tpu.utils.synthetic import \
    analytic_trajectory as jtraj
from anticipated_vins_mono_torch.models.estimator import VioEstimator as TEst
from anticipated_vins_mono_torch.ops.window import WindowConfig as TCfg
from anticipated_vins_mono_torch.utils import convert
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator as TSim
from anticipated_vins_mono_torch.utils.synthetic import \
    analytic_trajectory as ttraj

torch.set_num_threads(1)

CFG = dict(window=6, max_feats=64, iters=10)
RELO_FRAME = 20      # the frame whose solve carries the relo pose
OLD_FRAME = 16       # the fabricated loop keyframe's ground-truth frame
N_FRAMES = 24


def _oracle(traj):
    return {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}


def _jax_fields(est):
    out = {name: copy.deepcopy(getattr(est, name))
           for name in convert.HOST_FIELDS if hasattr(est, name)}
    out["db"] = {name: copy.deepcopy(getattr(est.db, name))
                 for name in convert.DB_FIELDS}
    out["prior"] = jax.tree_util.tree_map(np.array, est.prior)
    return out


def _relo_inputs(traj, sim, est, frame):
    """The JAX test's fabricated loop keyframe: the ground-truth pose of
    OLD_FRAME and the solved landmarks of `frame` projected into it."""
    k_old = OLD_FRAME * sim.frame_stride
    p_old, q_old = traj.p[k_old], traj.q[k_old]
    R_old = np.asarray(jlie.quat_to_rot(jnp.asarray(q_old)))
    matches = {}
    for fid in frame.feats:
        slot = est.db._find(fid)
        if slot < 0 or est.db.solved[slot] == 0:
            continue
        lm_idx = next(i for i, v in sim._id_of.items() if v == fid)
        P_c = R_old.T @ (sim.landmarks[lm_idx] - p_old)
        if P_c[2] < 0.5:
            continue
        matches[fid] = P_c / P_c[2]
    return p_old, q_old, R_old, matches


@pytest.fixture(scope="module")
def jax_relo():
    traj = jtraj(4.0)
    sim = JSim(traj, seed=0, pixel_noise=0.3, max_features=50)
    est = JEst(JCfg(**CFG), init_state=_oracle(traj))
    frames = list(sim.frames(N_FRAMES))
    for fm in frames[:RELO_FRAME]:
        est.process_frame(fm)
    fields = _jax_fields(est)
    p_old, q_old, R_old, matches = _relo_inputs(traj, sim, est,
                                                frames[RELO_FRAME - 1])
    est.set_relo_frame(p_old, q_old, matches)
    est.process_frame(frames[RELO_FRAME])
    return types.SimpleNamespace(
        traj=traj, fields=fields, relo=(p_old, q_old, matches),
        R_old=R_old, result=tuple(np.array(x) for x in est.relo_result),
        p=est.p.copy(), q=est.q.copy(), frame_t=est.frame_times[-1])


def _port_frames():
    traj = ttraj(4.0)
    sim = TSim(traj, seed=0, pixel_noise=0.3, max_features=50)
    return traj, sim, list(sim.frames(N_FRAMES))


@pytest.fixture(scope="module")
def port_relo(jax_relo):
    """The JAX estimator's state after frame 19 carried into the port, the
    same relo frame and matches, frame 20, then the remaining frames."""
    traj, sim, frames = _port_frames()
    est = TEst(TCfg(**CFG), init_state=_oracle(traj), device="cpu")
    convert.host_estimator_from_numpy(jax_relo.fields, est)
    # the port's simulator gives the same frames: its own fabricated
    # matches are the JAX ones
    matches = _relo_inputs(traj, sim, est, frames[RELO_FRAME - 1])[3]
    est.set_relo_frame(*jax_relo.relo)
    est.process_frame(frames[RELO_FRAME])
    run = types.SimpleNamespace(est=est, matches=matches,
                                pending_after=est.pending_relo,
                                result=est.relo_result,
                                p=est.p.copy(), q=est.q.copy())
    for fm in frames[RELO_FRAME + 1:]:
        est.process_frame(fm)
    return run


def test_relo_solve_equals_jax(jax_relo, port_relo):
    """From the same state, the same relo frame and matches: `relo_result`
    (rel_t, rel_q) and the window's p, q 1e-6 after the relo solve, and the
    relo state cleared."""
    assert port_relo.pending_after is None
    rel_t, rel_q = port_relo.result
    np.testing.assert_allclose(rel_t, jax_relo.result[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(rel_q, jax_relo.result[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_relo.p, jax_relo.p, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_relo.q, jax_relo.q, rtol=0, atol=1e-6)


def test_fabricated_matches_equal_jax(jax_relo, port_relo):
    """The port's simulator and DB give the JAX test's matches: the same ids
    in the same order, the points to rounding (1e-12)."""
    m_j, m_t = jax_relo.relo[2], port_relo.matches
    assert list(m_t) == list(m_j) and len(m_t) >= 10
    for fid in m_j:
        np.testing.assert_allclose(m_t[fid], m_j[fid], rtol=0, atol=1e-12)


def test_relo_recovers_the_relative_pose(jax_relo, port_relo):
    """The JAX test's oracle on the port's result: the ground-truth relative
    transform old frame → newest window frame within 5 cm and ~3°, and the
    pipeline goes on without a failure."""
    traj, R_old = jax_relo.traj, jax_relo.R_old
    p_old, q_old, _ = jax_relo.relo
    rel_t, rel_q = port_relo.result
    k_new = int(round(jax_relo.frame_t * 200))
    gt_rel_t = R_old.T @ (traj.p[k_new] - p_old)
    np.testing.assert_allclose(rel_t, gt_rel_t, atol=0.05)
    gt_rel_q = np.asarray(jlie.quat_mul(jlie.quat_conj(jnp.asarray(q_old)),
                                        jnp.asarray(traj.q[k_new])))
    dq = np.asarray(jlie.quat_mul(jlie.quat_conj(jnp.asarray(rel_q)),
                                  jnp.asarray(gt_rel_q)))
    assert 2 * np.abs(dq[1:]).max() < 0.05
    assert port_relo.est.diag.failures == 0
    assert port_relo.est.n_frames == CFG["window"]
