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


@pytest.mark.parametrize("nb", [16, 32])
@pytest.mark.parametrize("N", [64, 126, 128])
def test_blocked_ldl_pivots_match_unblocked_and_pallas_interpret(N, nb):
    """The kernel's blocked order (padding to a multiple of nb included)
    against the unblocked plain version pivot by pivot, and its Σ log
    against the Pallas kernel; atol=2e-3 as the Pallas kernel's own test."""
    M = _psd_batch(3, N, seed=N)
    piv, y = hk.blocked_ldl_plain(torch.from_numpy(M), nb)
    assert y is None and tuple(piv.shape) == (3, N)
    # unblocked pivots: the diagonal after a plain elimination
    A = torch.from_numpy(M).clone()
    ref_piv = torch.zeros(3, N)
    for j in range(N):
        ref_piv[:, j] = A[:, j, j]
        lr = A[:, j + 1:, j] / A[:, j, j, None]
        A[:, j + 1:, j + 1:] -= lr[:, :, None] * A[:, None, j + 1:, j]
    np.testing.assert_allclose(piv.numpy(), ref_piv.numpy(), rtol=2e-5)
    blocked = torch.log(piv).sum(-1).numpy()
    plain = hk.logdet_psd_batched_plain(torch.from_numpy(M)).numpy()
    pallas = np.asarray(pk.logdet_psd_batched(jnp.asarray(M), interpret=True))
    np.testing.assert_allclose(blocked, plain, atol=2e-3)
    np.testing.assert_allclose(blocked, pallas, atol=2e-3)


@pytest.mark.parametrize("case", ["zero_pivot", "nan_pivot", "ragged"])
def test_blocked_ldl_edge_cases(case):
    nb = 16
    if case == "ragged":
        # 40 = 2·16 + 8: the last panel is short and padded with identity
        M = torch.from_numpy(_psd_batch(2, 40, seed=5))
        rhs = torch.from_numpy(
            np.random.default_rng(6).normal(size=(2, 40)).astype(np.float32))
        piv, y = hk.blocked_ldl_plain(M, nb, rhs=rhs, guard="abs")
        assert tuple(piv.shape) == (2, 40) and tuple(y.shape) == (2, 40)
        ref = np.linalg.solve(M.numpy().astype(np.float64),
                              rhs.numpy().astype(np.float64)[..., None])[..., 0]
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            torch.log(piv).sum(-1).numpy(),
            np.linalg.slogdet(M.numpy().astype(np.float64))[1], atol=1e-3)
        return
    M = torch.from_numpy(_psd_batch(3, 48, seed=7))
    if case == "zero_pivot":        # the last pivot is exactly 0: floored
        M[1, -1, :] = 0.0
        M[1, :, -1] = 0.0
    else:                           # a NaN pivot stays NaN under "floor"
        M[1, 20, 20] = float("nan")
    piv, _ = hk.blocked_ldl_plain(M, nb)
    out = torch.log(piv).sum(-1)
    ref = hk.logdet_psd_batched_plain(M)
    np.testing.assert_allclose(out[[0, 2]].numpy(), ref[[0, 2]].numpy(),
                               atol=2e-3)
    if case == "zero_pivot":
        assert float(piv[1, -1]) == pytest.approx(1e-30)
        np.testing.assert_allclose(float(out[1]), float(ref[1]), atol=2e-3)
    else:
        assert torch.isnan(out[1]) and torch.isnan(ref[1])
        # the Schur rule replaces a NaN pivot instead
        piv_abs, _ = hk.blocked_ldl_plain(M[1:2, :21, :21], nb, guard="abs")
        assert float(piv_abs[0, 20]) == pytest.approx(1e-30)


def _overflowing_matrix(N=126):
    """Identity of order N whose last four rows and columns hold a dense block
    with a zero pivot above non-zero entries: the floored pivot's 1e30
    multipliers overflow, the remaining pivots end at -inf and take the floor
    too. N = 126 leaves two padding rows in a panel of 16."""
    M = torch.eye(N)
    T = torch.tensor([[0.0, 1e-3, 2e-3, 3e-3], [1e-3, 1.0, 0.5, 0.25],
                      [2e-3, 0.5, 1.0, 0.5], [3e-3, 0.25, 0.5, 1.0]])
    M[-4:, -4:] = T
    return M[None]


def test_blocked_ldl_padding_rows_stay_out_of_the_pivots():
    # the padding rows meet 0·inf = NaN under the overflowed columns; none of
    # that may reach the pivots of the matrix itself
    M = _overflowing_matrix()
    piv, _ = hk.blocked_ldl_plain(M, 16)
    assert tuple(piv.shape) == (1, 126)
    assert torch.isfinite(piv).all()
    np.testing.assert_allclose(piv[0, -4:].numpy(), 1e-30, rtol=1e-6)
    np.testing.assert_allclose(float(torch.log(piv).sum()),
                               float(hk.logdet_psd_batched_plain(M)[0]),
                               atol=2e-3)
    assert float(hk.logdet_psd_batched_plain(M)[0]) == pytest.approx(
        4 * np.log(1e-30), abs=2e-3)


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


def test_logdet_affine_on_cpu_is_the_materialised_sum_and_counts_no_launch():
    rng = np.random.default_rng(11)
    Om = torch.from_numpy(_psd_batch(1, 20, seed=1)[0])
    Deltas = torch.from_numpy(_psd_batch(5, 20, seed=2) - 2.5 * np.eye(
        20, dtype=np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.0, 5).astype(np.float32))
    hk.reset_launch_counts()
    out = hk.logdet_psd_affine_batched(Om, Deltas, scale)
    ref = hk.logdet_psd_batched(Om[None] + scale[:, None, None] * Deltas)
    assert torch.equal(out, ref)
    assert hk.launch_counts["logdet_psd_batched"] == 0


@pytest.mark.parametrize("bad", ["dtype", "om_shape", "deltas_shape",
                                 "scale_shape", "device"])
def test_logdet_affine_wrapper_raises(bad):
    Om = torch.from_numpy(_psd_batch(1, 8)[0])
    Deltas = torch.from_numpy(_psd_batch(3, 8))
    scale = torch.ones(3)
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            hk.logdet_psd_affine_batched(Om, Deltas.double(), scale)
        elif bad == "om_shape":
            hk.logdet_psd_affine_batched(Om[None], Deltas, scale)
        elif bad == "deltas_shape":
            hk.logdet_psd_affine_batched(Om, Deltas[:, :7, :7], scale)
        elif bad == "scale_shape":
            hk.logdet_psd_affine_batched(Om, Deltas, scale[:2])
        else:
            hk.logdet_psd_affine_batched(Om, Deltas.to("meta"), scale)


@pytest.mark.parametrize("nb", [16, 32])
def test_blocked_ldl_solve_matches_schur_plain(nb):
    """The blocked factorization, right-hand side and backward substitution
    in place of the unblocked loops of `schur_solve_fused_plain`, D = 178
    (178 = 5·32 + 18: padded), at the kernel's tolerances."""
    batch = [torch.from_numpy(b) for b in _stack(
        [_schur_system(F=128, seed=s, lam=10.0 ** -s) for s in (1, 2, 3)])]
    A, b, ds, damp, g_red, inv_h = hk._schur_scaled_system(*batch)
    piv, y = hk.blocked_ldl_plain(A, nb, rhs=b, guard="abs")
    assert tuple(y.shape) == (3, 178) and bool((piv > 0).all())
    H, g, H_lp, h_ll, g_l, lam = batch
    dx, dr, pred = hk._schur_outputs(y, ds, damp, g_red, inv_h, H_lp, h_ll,
                                     g_l, lam)
    dx0, dr0, pred0 = hk.schur_solve_fused_plain(*batch)
    scale = max(float(dx0.abs().max()), 1.0)
    np.testing.assert_allclose(dx.numpy(), dx0.numpy(), atol=2e-4 * scale,
                               rtol=2e-3)
    np.testing.assert_allclose(dr.numpy(), dr0.numpy(), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(pred.numpy(), pred0.numpy(), rtol=2e-3)


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
    # logdet: 126 padded to 128 rows of stride 132, one reciprocal per row
    assert hk.logdet_smem_bytes(126) == (128 * 132 + 128) * 4
    assert hk.logdet_smem_bytes(126) == hk.logdet_smem_bytes(128)
    assert hk.logdet_smem_bytes(128) <= hk.MAX_SMEM_BYTES
    # Schur: 178 padded to 192 rows of stride 196, two 32-row stages of
    # H_lp, six vectors, the rhs panel row, two landmark vectors, scratch
    assert hk.schur_smem_bytes(178, 128) == (
        192 * 196 + 2 * 32 * 196 + 6 * 192 + 16 + 2 * 128 + 64) * 4
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


def _launcher_inputs(kernel):
    """Well-formed flat inputs of a launcher, on the CPU: B = 2 pairs of
    N = 8 samples, or B = 2 windows of NF = 4 frames and 12 slots."""
    if kernel == "preint_scan":
        shapes = [(2, 8), (2, 8, 3), (2, 8, 3)] + [(2, 3)] * 4
        return [torch.zeros(s) for s in shapes] + [[1e-4] * 18, 0.005], {}
    shapes = (hk.normal_eq_inputs if kernel == "normal_eq_fused"
              else hk.lm_cost_inputs)(4, 12)
    inputs = {k: torch.zeros((2,) + s, dtype=torch.int64 if k == "anchor"
                             else torch.float32)
              for k, s in shapes.items()}
    if kernel == "lm_cost_fused":
        return [inputs, "evaluate", 1.0, 31.6, 0.01, False, 4.0, 0.5], {}
    return [inputs, 1.0, 31.6, True], {}


@pytest.mark.parametrize("kernel", ["preint_scan", "normal_eq_fused",
                                    "lm_cost_fused"])
def test_launchers_take_cuda_tensors_only(kernel):
    """The launchers of the kernels with no Pallas counterpart have no
    CPU path: well-formed CPU tensors raise before anything is built or
    counted (the op that owns the types takes the plain version there)."""
    args, kw = _launcher_inputs(kernel)
    hk.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(hk, kernel)(*args, **kw)
    assert hk.launch_counts[kernel] == 0


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Runs on a machine with a CUDA card and nvcc (`pytest -m gpu`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    M = torch.from_numpy(_psd_batch(8, 126)).cuda()
    np.testing.assert_allclose(hk.logdet_psd_batched(M).cpu().numpy(),
                               hk.logdet_psd_batched_plain(M).cpu().numpy(),
                               atol=2e-3)
    # overflowing columns above the padding rows: finite, as the plain version
    bad = _overflowing_matrix().cuda()
    np.testing.assert_allclose(hk.logdet_psd_batched(bad).cpu().numpy(),
                               hk.logdet_psd_batched_plain(bad).cpu().numpy(),
                               atol=2e-3)
    # the fused loader: logdet(Om + scale·Deltas) without the temporary
    Om, Deltas = M[0], M[1:] - 2.5 * torch.eye(126, device="cuda")
    scale = torch.linspace(0.5, 1.0, 7, device="cuda")
    hk.reset_launch_counts()
    np.testing.assert_allclose(
        hk.logdet_psd_affine_batched(Om, Deltas, scale).cpu().numpy(),
        hk.logdet_psd_batched_plain(
            Om[None] + scale[:, None, None] * Deltas).cpu().numpy(), atol=2e-3)
    assert hk.launch_counts["logdet_psd_batched"] == 1
    for F in (128, 192):
        batch = [torch.from_numpy(b).cuda() for b in _stack(
            [_schur_system(F=F, seed=s, lam=10.0 ** -s) for s in (1, 2, 3)])]
        out = hk.schur_solve_fused(*batch)
        ref = hk.schur_solve_fused_plain(*batch)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=2e-3, atol=2e-3)
