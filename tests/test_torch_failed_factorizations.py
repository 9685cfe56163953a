"""Port vs JAX: a Cholesky factorization that fails gives NaN, not an
exception, at each port site whose JAX counterpart factors with
`jnp.linalg.cholesky` (which returns a NaN factor for a matrix that is not
positive definite): `factors.sqrt_info_from_cov`, `preintegration.
preintegrate`'s whitening and `posegraph.pgo_solve`'s Gauss-Newton step.
Each is fed an input that makes the factored matrix indefinite, and its
output is held against the JAX function's, NaN for NaN (float64, 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models import posegraph as jpg
from anticipated_vins_mono_tpu.ops import factors as jfac
from anticipated_vins_mono_tpu.ops import preintegration as jpre
from anticipated_vins_mono_torch.models import posegraph as tpg
from anticipated_vins_mono_torch.ops import factors as tfac
from anticipated_vins_mono_torch.ops import preintegration as tpre

torch.set_num_threads(1)

RTOL = 1e-10


def _sqrt_info():
    """A [2,15,15] batch: one covariance positive definite, one with a
    negative eigenvalue. Only the second one's factor is NaN."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(15, 15)))
    w = rng.uniform(0.1, 2.0, 15)
    w_bad = w.copy()
    w_bad[0] = -0.5
    P = np.stack([Q @ np.diag(w) @ Q.T, Q @ np.diag(w_bad) @ Q.T])
    j = np.asarray(jfac.sqrt_info_from_cov(jnp.asarray(P)))
    t = tfac.sqrt_info_from_cov(torch.from_numpy(P)).numpy()
    assert np.all(np.isfinite(t[0])) and np.all(np.isnan(t[1]))
    return j, t


class _NegJ(jpre.ImuNoise):
    def noise_cov18(self, dtype=jnp.float64):
        return -super().noise_cov18(dtype)


class _NegT(tpre.ImuNoise):
    def noise_cov18(self, dtype=torch.float64, device=None):
        return -super().noise_cov18(dtype, device)


def _preintegrate():
    """A negative noise covariance: the propagated P is negative definite,
    so the whitening's factor fails; the deltas stay finite."""
    rng = np.random.default_rng(1)
    N = 12
    dts = np.full(N, 0.005)
    acc = rng.normal(size=(N, 3)) + [0.0, 0.0, 9.8]
    gyr = rng.normal(scale=0.1, size=(N, 3))
    a0, g0 = acc[0], gyr[0]
    ba, bg = np.full(3, 0.01), np.full(3, -0.002)
    j = jpre.preintegrate(*(jnp.asarray(x) for x in
                            (dts, acc, gyr, a0, g0, ba, bg)), _NegJ())
    t = tpre.preintegrate(*(torch.from_numpy(x) for x in
                            (dts, acc, gyr, a0, g0, ba, bg)), _NegT())
    assert np.all(np.isfinite(t.dp.numpy())) and np.all(np.isnan(t.S.numpy()))
    return (np.concatenate([np.ravel(np.asarray(getattr(j, f)))
                            for f in ("dp", "dq", "dv", "P", "S")]),
            np.concatenate([getattr(t, f).numpy().ravel()
                            for f in ("dp", "dq", "dv", "P", "S")]))


def _pgo():
    """A keyframe slot with no edge, a valid flag of 2 and a gauge weight of
    −1: its freeze mask is −1, so H has −1 + 1e-6 on that slot's diagonal.
    Every position is NaN."""
    rng = np.random.default_rng(2)
    K, L, n = 8, 4, 5
    pos = np.zeros((K, 3))
    pos[:n] = np.cumsum(rng.normal(scale=0.3, size=(n, 3)), 0)
    yaw = np.zeros(K)
    yaw[:n] = rng.uniform(-170, 170, n)
    pr = np.zeros((K, 2))
    kf_valid = (np.arange(K) < n).astype(float)
    kf_valid[K - 1] = 2.0
    E = 4 * K
    seq_i, seq_j = np.zeros(E, np.int32), np.zeros(E, np.int32)
    seq_valid = np.zeros(E)
    seq_i[:n - 1], seq_j[:n - 1], seq_valid[:n - 1] = \
        np.arange(n - 1), np.arange(1, n), 1.0
    seq_t = rng.normal(scale=0.3, size=(E, 3))
    seq_yaw = rng.normal(scale=10.0, size=E)
    loop_i, loop_j = np.zeros(L, np.int32), np.zeros(L, np.int32)
    loop_t, loop_yaw = np.zeros((L, 3)), np.zeros(L)
    loop_valid = np.zeros(L)
    gauge = (np.arange(K) == 0).astype(float)
    gauge[K - 1] = -1.0
    args = (pos, yaw, pr, kf_valid, seq_i, seq_j, seq_t, seq_yaw, seq_valid,
            loop_i, loop_j, loop_t, loop_yaw, loop_valid)
    pj, yj = jpg.pgo_solve(*(jnp.asarray(a) for a in args),
                           jpg.PGOConfig(max_kf=K, max_loops=L, iters=2),
                           gauge=jnp.asarray(gauge))
    pt, yt = tpg.pgo_solve(*(torch.tensor(a) for a in args),
                           tpg.PGOConfig(max_kf=K, max_loops=L, iters=2),
                           gauge=torch.tensor(gauge))
    assert np.all(np.isnan(pt.numpy()))
    return (np.concatenate([np.ravel(pj), np.ravel(yj)]),
            np.concatenate([pt.numpy().ravel(), yt.numpy().ravel()]))


@pytest.mark.parametrize("site", ["sqrt_info_from_cov", "preintegrate",
                                  "pgo_solve"])
def test_failed_cholesky_gives_nan_as_jax(site):
    j, t = {"sqrt_info_from_cov": _sqrt_info, "preintegrate": _preintegrate,
            "pgo_solve": _pgo}[site]()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-12)


def test_failed_eigh_gives_nan_not_an_exception(monkeypatch):
    """`lie.eigh_or_nan`, the eigensolver of the batched small-matrix sites
    (triangulation's 4×4 AᵀA, the RANSAC's 9×9, "lowrank"'s position
    blocks). cuSOLVER's batched Jacobi solver can fail to converge on an
    ill-conditioned small matrix (seen on the card in triangulation), and
    `torch.linalg.eigh` then raises for the whole batch, where
    `jnp.linalg.eigh` returns NaN for a matrix LAPACK fails on. Injected
    here on the CPU: the solver raises for any batch holding a marked
    matrix. Each matrix is taken again alone: the others equal the plain
    solve exactly, the marked one is NaN."""
    from anticipated_vins_mono_torch.ops import lie
    rng = np.random.default_rng(1)
    X = rng.normal(size=(5, 4, 4))
    A = torch.from_numpy(X @ np.swapaxes(X, -1, -2))
    A[2, 0, 0] = 123.0
    plain = torch.linalg.eigh

    def flaky(M, *args, **kw):
        if (M[..., 0, 0] == 123.0).any():
            raise torch.linalg.LinAlgError("failed to converge")
        return plain(M, *args, **kw)

    monkeypatch.setattr(torch.linalg, "eigh", flaky)
    w, V = lie.eigh_or_nan(A.reshape(5, 1, 4, 4))
    assert w.shape == (5, 1, 4) and V.shape == (5, 1, 4, 4)
    assert torch.isnan(w[2]).all() and torch.isnan(V[2]).all()
    for i in (0, 1, 3, 4):
        ref = plain(A[i])
        assert torch.equal(w[i, 0], ref.eigenvalues)
        assert torch.equal(V[i, 0], ref.eigenvectors)
    monkeypatch.setattr(torch.linalg, "eigh", plain)
    out = lie.eigh_or_nan(A)
    ref = plain(A)
    assert torch.equal(out.eigenvalues, ref.eigenvalues)
