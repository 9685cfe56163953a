"""Port vs JAX, function by function: ops/lie.py (f64, CPU).

Tolerance rtol=1e-9, atol=1e-11: the same algebra in another reduction
order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_torch.ops import lie as tlie

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11


def _rng():
    return np.random.default_rng(0)


def _quats(rng, n=7):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vecs(rng, n=7, scale=1.0):
    return rng.normal(size=(n, 3)) * scale


def _rots(rng, n=7):
    return np.asarray(jlie.quat_to_rot(jnp.asarray(_quats(rng, n))))


CASES = {
    "quat_normalize": lambda r: (r.normal(size=(7, 4)),),
    "quat_mul": lambda r: (_quats(r), _quats(r)),
    "quat_conj": lambda r: (_quats(r),),
    "quat_inv": lambda r: (r.normal(size=(7, 4)),),
    "quat_rotate": lambda r: (_quats(r), _vecs(r)),
    "quat_to_rot": lambda r: (_quats(r),),
    "rot_to_quat": lambda r: (_rots(r, 32),),
    "skew": lambda r: (_vecs(r),),
    "delta_q": lambda r: (_vecs(r, scale=0.1),),
    "exp_so3_quat": lambda r: (np.concatenate(
        [_vecs(r), _vecs(r, scale=1e-9), np.zeros((1, 3))]),),
    "log_so3": lambda r: (np.concatenate(
        [_quats(r), np.array([[1.0, 0, 0, 0], [-1.0, 1e-10, 0, 0]])]),),
    "q_left": lambda r: (_quats(r),),
    "q_right": lambda r: (_quats(r),),
    "rot_to_ypr": lambda r: (_rots(r),),
    "ypr_to_rot": lambda r: (r.uniform(-80, 80, size=(7, 3)),),
    "gravity_to_rot": lambda r: (_vecs(r) + np.array([0, 0, 9.8]),),
    "logdet_psd": lambda r: ((lambda a: a @ a.transpose(0, 2, 1)
                              + 3 * np.eye(12))(r.normal(size=(5, 12, 12))),),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    args = CASES[name](_rng())
    ref = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    out = getattr(tlie, name)(*[torch.from_numpy(np.array(a)) for a in args])
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_pose_boxplus_matches_jax():
    r = _rng()
    p, q, dx = _vecs(r), _quats(r), r.normal(size=(7, 6)) * 0.1
    rp, rq = jlie.pose_boxplus(jnp.asarray(p), jnp.asarray(q), jnp.asarray(dx))
    tp, tq = tlie.pose_boxplus(*(torch.from_numpy(x) for x in (p, q, dx)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(rq), rtol=RTOL, atol=ATOL)


def test_quat_identity_dtype():
    assert tlie.quat_identity(torch.float64).dtype == torch.float64
    np.testing.assert_array_equal(tlie.quat_identity().numpy(),
                                  np.asarray(jlie.quat_identity()))


def test_logdet_psd_not_positive_definite_is_nan():
    """Like the JAX Cholesky path: NaN, no exception (the greedy masks it)."""
    M = torch.eye(4, dtype=torch.float64)[None].repeat(2, 1, 1)
    M[1, 2, 2] = -1.0
    out = tlie.logdet_psd(M)
    assert out[0].item() == 0.0 and torch.isnan(out[1])
