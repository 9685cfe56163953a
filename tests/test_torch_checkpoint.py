"""The port's estimator checkpoints against the JAX package's
(`utils/checkpoint.py`), CPU, float64.

Checkpoints carry the same npz keys in both packages, so either loads the
other's. The setup is the JAX package's own round-trip test's (window 5,
48 slots, oracle start, 0.5 px): the JAX estimator's checkpoint after 14
frames loads into the port with every array equal; the next 6 frames in
both agree within the host chain's bound (`p`, `v` atol 1e-4, the slot
ids and mask exact; ROADMAP queue C 4(b)). The port's checkpoint loads in
the JAX package with every array equal, and the port's own resume equals
its uninterrupted run to 1e-9. The JAX and port runs are module fixtures.
"""

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models.estimator import VioEstimator as JEst
from anticipated_vins_mono_tpu.ops.window import WindowConfig as JCfg
from anticipated_vins_mono_tpu.utils import checkpoint as jckpt
from anticipated_vins_mono_tpu.utils.sequence import SequenceSimulator as JSim
from anticipated_vins_mono_tpu.utils.synthetic import \
    analytic_trajectory as jtraj
from anticipated_vins_mono_torch.models.estimator import VioEstimator as TEst
from anticipated_vins_mono_torch.ops.window import WindowConfig as TCfg
from anticipated_vins_mono_torch.utils import checkpoint
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator as TSim
from anticipated_vins_mono_torch.utils.synthetic import analytic_trajectory
from test_torch_euroc import _assert_npz_equal

torch.set_num_threads(1)

CFG = dict(window=5, max_feats=48, iters=6)
SAVE_AT, N_FRAMES = 14, 20


# ---------------------------------------------------------------------------
# Estimator checkpoints, both ways
# ---------------------------------------------------------------------------


def _frames(sim_cls):
    traj = jtraj(3.0) if sim_cls is JSim else analytic_trajectory(3.0)
    sim = sim_cls(traj, seed=0, pixel_noise=0.5, max_features=40)
    return traj, list(sim.frames(N_FRAMES))


def _oracle(traj):
    return {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}


def _port_est(traj):
    return TEst(TCfg(**CFG), init_state=_oracle(traj), device="cpu")


def _track(est, frames, rec):
    for fm in frames:
        est.process_frame(fm)
        rec.append({"p": est.p.copy(), "v": est.v.copy(),
                    "ids": est.db.ids.copy(), "mask": est.db.mask.copy(),
                    "inv_depth": est.db.inv_depth.copy()})
    return rec


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@pytest.fixture(scope="module")
def jax_run(ckpt_dir):
    """The JAX estimator over 20 frames, checkpointed after frame 14."""
    traj, frames = _frames(JSim)
    est = JEst(JCfg(**CFG), init_state=_oracle(traj))
    rec = _track(est, frames[:SAVE_AT], [])
    path = str(ckpt_dir / "jax.npz")
    jckpt.save_estimator(path, est)
    _track(est, frames[SAVE_AT:], rec)
    return path, rec, est


@pytest.fixture(scope="module")
def port_run(ckpt_dir):
    """The port's estimator over 20 frames, checkpointed after frame 14."""
    traj, frames = _frames(TSim)
    est = _port_est(traj)
    rec = _track(est, frames[:SAVE_AT], [])
    path = str(ckpt_dir / "port.npz")
    checkpoint.save_estimator(path, est)
    _track(est, frames[SAVE_AT:], rec)
    return path, rec, traj, frames


def test_checkpoint_keys_equal_jax(jax_run, port_run):
    assert sorted(np.load(jax_run[0]).files) == sorted(np.load(port_run[0]).files)


def test_jax_checkpoint_loads_into_the_port(jax_run, port_run, ckpt_dir):
    """JAX save → port load: every array the JAX package wrote, and saving
    it again writes the same npz; the prior lands on the estimator's device
    in its dtype."""
    traj, _ = port_run[2], port_run[3]
    est = _port_est(traj)
    checkpoint.load_estimator(jax_run[0], est)
    assert est.prior.J0.dtype == torch.float64
    assert est.prior.J0.device.type == "cpu"
    z = np.load(jax_run[0])
    np.testing.assert_array_equal(est.p, z["p"])
    np.testing.assert_array_equal(est.prior.J0.numpy(), z["prior_J0"])
    np.testing.assert_array_equal(est.prior.lin.inv_depth.numpy(),
                                  z["prior_lin_invd"])
    again = str(ckpt_dir / "jax_via_port.npz")
    checkpoint.save_estimator(again, est)
    _assert_npz_equal(jax_run[0], again)


def test_port_resumes_from_a_jax_checkpoint(jax_run, port_run):
    """The next 6 frames after a JAX checkpoint, in the port, agree with the
    JAX estimator's own next 6 within the host chain's bound."""
    traj, frames = port_run[2], port_run[3]
    est = _port_est(traj)
    checkpoint.load_estimator(jax_run[0], est)
    rec = _track(est, frames[SAVE_AT:], [])
    for k, (t, j) in enumerate(zip(rec, jax_run[1][SAVE_AT:], strict=True)):
        np.testing.assert_array_equal(t["ids"], j["ids"], err_msg=str(k))
        np.testing.assert_array_equal(t["mask"], j["mask"], err_msg=str(k))
        np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(t["v"], j["v"], rtol=0, atol=1e-4)


def test_port_checkpoint_loads_in_the_jax_package(jax_run, port_run,
                                                  ckpt_dir):
    """Port save → JAX load gives the same arrays: the JAX estimator of the
    module's run, loaded with the port's checkpoint, saves exactly the npz
    the port wrote."""
    est = jax_run[2]
    jckpt.load_estimator(port_run[0], est)
    z = np.load(port_run[0])
    np.testing.assert_array_equal(np.asarray(est.prior.J0), z["prior_J0"])
    again = str(ckpt_dir / "port_via_jax.npz")
    jckpt.save_estimator(again, est)
    _assert_npz_equal(port_run[0], again)


def test_port_resume_equals_its_uninterrupted_run(port_run):
    traj, frames = port_run[2], port_run[3]
    est = _port_est(traj)
    checkpoint.load_estimator(port_run[0], est)
    rec = _track(est, frames[SAVE_AT:], [])
    for t, u in zip(rec, port_run[1][SAVE_AT:], strict=True):
        np.testing.assert_allclose(t["p"], u["p"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(t["inv_depth"], u["inv_depth"], rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(t["ids"], u["ids"])
