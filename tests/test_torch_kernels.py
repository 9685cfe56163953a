"""The two Hopper kernels' plain versions and wrappers against the Pallas
kernels (interpret mode) and the JAX reference paths, on the CPU.

The CUDA kernels themselves run only on a card: that comparison carries the
`gpu` marker and is skipped here (chip_smoke.py makes it on the card)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.ops import pallas_kernels as pk
from anticipated_vins_mono_tpu.ops import window as jw
from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops import window as tw

torch.set_num_threads(1)


def _psd_batch(B, N, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N)).astype(np.float32) * 0.2
    return A @ A.transpose(0, 2, 1) + 3 * np.eye(N, dtype=np.float32)


def _schur_system(D=178, F=192, seed=3, lam=1e-3):
    """Jacobian-consistent system (rows touch the pose block and at most one
    landmark column), so H_red is a true PSD Schur complement. Same
    construction as the JAX package's Pallas test."""
    rng = np.random.default_rng(seed)
    N = 4 * D
    Jp = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    lm_of_row = rng.integers(0, F, size=N)
    Jl = (rng.normal(size=N) * 0.8).astype(np.float32)
    Jl[lm_of_row >= F - 10] = 0.0      # some landmarks get no rows (masked)
    r = rng.normal(size=N).astype(np.float32)
    H = Jp.T @ Jp + 0.1 * np.eye(D, dtype=np.float32)
    g = Jp.T @ r
    onehot = np.zeros((N, F), np.float32)
    onehot[np.arange(N), lm_of_row] = Jl
    return (H, g, onehot.T @ Jp, (onehot * onehot).sum(0), onehot.T @ r,
            np.float32(lam))


def _stack(systems):
    return [np.stack([s[i] for s in systems]) for i in range(6)]


# atol=2e-3 in f32: the tolerance of the Pallas kernel's own test against the
# Cholesky path (N sequential f32 pivots, logdet ~ 150)
@pytest.mark.parametrize("B,N", [(3, 64), (3, 126), (4, 128)])
def test_logdet_plain_matches_pallas_interpret_and_cholesky(B, N):
    M = _psd_batch(B, N, seed=N)
    plain = hk.logdet_psd_batched_plain(torch.from_numpy(M)).numpy()
    pallas = np.asarray(pk.logdet_psd_batched(jnp.asarray(M), interpret=True))
    chol = np.asarray(jlie.logdet_psd(jnp.asarray(M)))
    np.testing.assert_allclose(plain, pallas, atol=2e-3)
    np.testing.assert_allclose(plain, chol, atol=2e-3)


def test_logdet_identity_and_floor():
    eye = torch.eye(16).repeat(2, 1, 1)
    np.testing.assert_allclose(hk.logdet_psd_batched(eye).numpy(), 0.0,
                               atol=1e-6)
    # a non-PSD matrix hits the 1e-30 pivot floor: finite or NaN, no error
    bad = eye.clone()
    bad[0, 3, 3] = -1.0
    out = hk.logdet_psd_batched(bad)
    assert out[1].item() == 0.0
    assert out[0].item() < -60.0 or torch.isnan(out[0])


def test_logdet_wrapper_on_cpu_takes_plain_and_counts_no_launch():
    M = torch.from_numpy(_psd_batch(2, 20))
    hk.reset_launch_counts()
    out = hk.logdet_psd_batched(M)
    assert torch.equal(out, hk.logdet_psd_batched_plain(M))
    assert hk.launch_counts["logdet_psd_batched"] == 0
    # the dispatcher sends CPU tensors to the Cholesky path, f64 included
    M64 = M.double()
    np.testing.assert_allclose(hk.logdet_psd(M64).numpy(),
                               np.asarray(jlie.logdet_psd(jnp.asarray(
                                   M64.numpy()))), rtol=1e-12)


@pytest.mark.parametrize("bad", ["dtype", "rank", "square"])
def test_logdet_wrapper_raises(bad):
    M = torch.from_numpy(_psd_batch(2, 8))
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            hk.logdet_psd_batched(M.double())
        elif bad == "rank":
            hk.logdet_psd_batched(M[0])
        else:
            hk.logdet_psd_batched(M[:, :, :7])


def test_schur_plain_matches_pallas_interpret():
    """Same f32 algorithm class (elimination without pivoting on the
    Jacobi-scaled system): tight, rtol=1e-4 of each output's scale."""
    systems = [_schur_system(seed=s, lam=10.0 ** -s) for s in (1, 2, 3)]
    batch = _stack(systems)
    ref = pk._schur_solve_fused_batched(*[jnp.asarray(b) for b in batch],
                                        interpret=True)
    out = hk.schur_solve_fused_plain(*[torch.from_numpy(b) for b in batch])
    for a, b, n in zip(out, ref, ("dx", "d_rho", "pred")):
        a, b = a.numpy(), np.asarray(b)
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b)), n


@pytest.mark.parametrize("seed,lam", [(1, 1e-1), (2, 1e-2), (3, 1e-3)])
def test_schur_plain_matches_f64_schur_solve(seed, lam):
    """f32 fused arithmetic vs the f64 Schur path of both packages, at the
    tolerances of the Pallas kernel's own parity test."""
    sys_ = _schur_system(seed=seed, lam=lam)
    dx0, dr0, pred0 = jw.schur_solve(*[jnp.asarray(x) for x in sys_],
                                     jw.WindowConfig())
    t_sys = [torch.from_numpy(np.asarray(x)) for x in sys_]
    dx2, dr2, pred2 = tw.schur_solve(*t_sys, tw.WindowConfig())
    np.testing.assert_allclose(dx2.numpy(), np.asarray(dx0), rtol=1e-5,
                               atol=1e-6)
    dx1, dr1, pred1 = hk.schur_solve_fused(*[x[None] for x in t_sys])
    scale = float(jnp.max(jnp.abs(dx0)))
    np.testing.assert_allclose(dx1[0].numpy(), np.asarray(dx0, np.float32),
                               atol=2e-4 * max(scale, 1.0), rtol=2e-3)
    np.testing.assert_allclose(dr1[0].numpy(), np.asarray(dr0, np.float32),
                               atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(float(pred1[0]), float(pred0), rtol=2e-3)


def test_schur_wrapper_on_cpu_takes_plain_and_counts_no_launch():
    t_sys = [torch.from_numpy(np.asarray(x))[None]
             for x in _schur_system(D=24, F=10)]
    hk.reset_launch_counts()
    out = hk.schur_solve_fused(*t_sys)
    ref = hk.schur_solve_fused_plain(*t_sys)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert hk.launch_counts["schur_solve_fused"] == 0


@pytest.mark.parametrize("bad", ["dtype", "g_shape", "lam_shape", "H_rank"])
def test_schur_wrapper_raises(bad):
    H, g, H_lp, h_ll, g_l, lam = [
        torch.from_numpy(np.asarray(x))[None] for x in _schur_system(D=24, F=10)]
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            hk.schur_solve_fused(H.double(), g, H_lp, h_ll, g_l, lam)
        elif bad == "g_shape":
            hk.schur_solve_fused(H, g[:, :-1], H_lp, h_ll, g_l, lam)
        elif bad == "lam_shape":
            hk.schur_solve_fused(H, g, H_lp, h_ll, g_l, lam[0])
        else:
            hk.schur_solve_fused(H[0], g, H_lp, h_ll, g_l, lam)


def test_shared_memory_budget_of_the_main_path_shapes():
    """Sizes the wrappers check before a launch: the main-path shapes fit a
    block's 227 KB, oversize ones are refused."""
    assert hk.logdet_smem_bytes(126) == 126 * 127 * 4 <= hk.MAX_SMEM_BYTES
    assert hk.schur_smem_bytes(178, 128) <= hk.MAX_SMEM_BYTES
    assert hk.schur_smem_bytes(178, 192) <= hk.MAX_SMEM_BYTES
    assert hk.logdet_smem_bytes(256) > hk.MAX_SMEM_BYTES
    assert hk.schur_smem_bytes(256, 128) > hk.MAX_SMEM_BYTES


def test_fused_switch_in_lm_solve_takes_the_wrapper_on_cpu():
    """`fused_schur=True` routes the LM step through `schur_solve_fused`
    (plain version here) and still lowers the cost in f32."""
    from anticipated_vins_mono_torch.utils.synthetic import make_window_problem
    cfg = tw.WindowConfig(window=3, max_feats=16, iters=4, fused_schur=True)
    prob = make_window_problem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                               dtype=torch.float32, device="cpu")
    batch1 = lambda t: t[None]
    from anticipated_vins_mono_torch.utils.tree import tree_map
    st, d = tw.lm_solve(tree_map(batch1, prob.init), tree_map(batch1, prob.meas),
                        cfg, device="cpu")
    assert torch.isfinite(d["cost"]).all() and (d["cost"] < d["cost0"]).all()
    ref, dref = tw.lm_solve(prob.init, prob.meas,
                            cfg._replace(fused_schur=False), device="cpu")
    np.testing.assert_allclose(float(d["cost"][0]), float(dref["cost"]),
                               rtol=1e-2)
    with pytest.raises(TypeError):   # the kernel is f32 only
        p64 = make_window_problem(cfg, seed=0, device="cpu")
        tw.lm_solve(p64.init, p64.meas, cfg, device="cpu")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Runs on a machine with a CUDA card and nvcc (`pytest -m gpu`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    M = torch.from_numpy(_psd_batch(8, 126)).cuda()
    np.testing.assert_allclose(hk.logdet_psd_batched(M).cpu().numpy(),
                               hk.logdet_psd_batched_plain(M).cpu().numpy(),
                               atol=2e-3)
    batch = [torch.from_numpy(b).cuda() for b in _stack(
        [_schur_system(seed=s, lam=10.0 ** -s) for s in (1, 2, 3)])]
    out = hk.schur_solve_fused(*batch)
    ref = hk.schur_solve_fused_plain(*batch)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-3, atol=2e-3)
