"""The hand-written Hopper kernels, their wrappers and plain versions.

Counterpart of `anticipated_vins_mono_tpu/ops/pallas_kernels.py`:

- `logdet_psd_batched` — f32 [B,N,N] → [B] log-determinants by unpivoted
  elimination (`csrc/logdet_psd.cu`); `logdet_psd_affine_batched` is the
  same kernel with a loader that forms `Om + scale_f · Deltas_f` while it
  fills shared memory: the anticipation selector scores all candidates with
  it every greedy round and writes no [F,N,N] temporary;
- `schur_solve_fused` — the damped Schur-reduced solve of one LM iteration
  for a whole scenario batch in one launch (`csrc/schur_solve_fused.cu`).

Both kernels factor through one blocked in-shared-memory LDLᵀ
(`csrc/blocked_ldl.cuh`); `blocked_ldl_plain` is that algorithm in plain
PyTorch, in the kernel's order, for the tests.

Three kernels replace no TPU kernel. `preint_scan` runs the IMU
preintegration's whole midpoint scan of a call, and its Cholesky tail, in
one launch (`csrc/preint_scan.cu`), float32 or float64, where the JAX
package has a `lax.scan`. `normal_eq_fused` linearizes every projection and
IMU factor of a window and sums the LM iteration's normal equations in one
launch (`csrc/normal_eq_fused.cu`), float32 or float64, where the JAX
package has XLA's linearization. `lm_cost_fused` takes the LM iteration's
cost phase, the retraction, the robust cost, the decision and the next
iterate, in one launch (`csrc/lm_cost_fused.cu`), float32 or float64, where
the JAX package has XLA inside its `lax.scan`; the two window kernels share
their factors (`csrc/window_factors.cuh`). Each window kernel has a second
instance for a solve that estimates the camera-IMU time offset td under a
global or a rolling shutter (`td_consts`), counted under its own name in
`launch_counts` (`TD_INSTANCES`). All three are launchers of flat
`[B, ...]` tensors and take CUDA tensors only: the op that owns the types
packs them and chooses the route, and holds the plain version
(`preintegration.preintegrate`, `window._lm_route`).

The CUDA sources are compiled with `nvcc` for `sm_90a` at first use, one
compiler process per source started together, into `build/hopper_kernels/`
beside the package, and loaded with `ctypes`. Nothing is compiled when the
module is imported.

The logdet and Schur wrappers take their plain PyTorch version (`*_plain`,
the same arithmetic in the same order) only for tensors that lie on the
CPU. For a CUDA tensor every entry point launches its kernel or raises;
there is no fallback. Each launch adds one to `launch_counts[name]`.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from anticipated_vins_mono_torch.ops import lie

Tensor = torch.Tensor

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hopper_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# shared memory a block may use on an H100: 227 KB
MAX_SMEM_BYTES = 232448

# kernel name → CUDA source under csrc/
KERNEL_SOURCES = {
    "logdet_psd_batched": "logdet_psd.cu",
    "schur_solve_fused": "schur_solve_fused.cu",
    "preint_scan": "preint_scan.cu",
    "normal_eq_fused": "normal_eq_fused.cu",
    "lm_cost_fused": "lm_cost_fused.cu",
}
# flags a source takes besides NVCC_FLAGS: the window's factors round each
# product and sum on its own, as PyTorch's elementwise operations whose
# results and derivatives they follow do
KERNEL_FLAGS = {"normal_eq_fused": ("-fmad=false",),
                "lm_cost_fused": ("-fmad=false",)}

# the window kernels' instances that estimate the time offset, counted under
# names of their own (their sources are the kernels')
TD_INSTANCES = ("normal_eq_fused_td", "lm_cost_fused_td")

# launches since the last reset, per kernel; a wrapper adds one exactly where
# it launches its kernel
launch_counts = {name: 0 for name in (*KERNEL_SOURCES, *TD_INSTANCES)}

_libs: dict = {}
build_logs: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ----------------------------------------------------------------------------
# Build at first use
# ----------------------------------------------------------------------------


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the Hopper kernels are compiled from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    source = CSRC_DIR / KERNEL_SOURCES[name]
    digest = hashlib.sha1(
        source.read_bytes()
        + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
        + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_kernels() -> dict:
    """Compile every kernel source that has no up-to-date library yet (all
    compilers started together), load the libraries and let each raise its
    kernels' dynamic shared-memory limit once. Returns {kernel name: ctypes
    library}. Raises if a source does not compile."""
    missing = [n for n in KERNEL_SOURCES if n not in _libs]
    if not missing:
        return _libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        src = CSRC_DIR / KERNEL_SOURCES[name]
        out = _lib_path(name)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_find_nvcc(), *_flags(name), "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    for name in missing:
        lib = ctypes.CDLL(str(_lib_path(name)))
        _raise_on(_declare(name, lib)(), f"{name}: init")
        _libs[name] = lib
    return _libs


def _declare(name: str, lib):
    """Sets the argument types of the library's functions; returns its init
    function (shared-memory opt-in or an early module load, called once
    after loading)."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if name == "normal_eq_fused":
        # (pointers, batch, nf, nfeat, c2, sqrt_aw, est_ext, f64, td_consts,
        #  stream)
        lib.avm_normal_eq_fused.argtypes = [ptr] + [i32] * 3 + [f64] * 2 + \
            [i32] * 2 + [ptr] * 2
        lib.avm_normal_eq_warps.argtypes = [i32] * 3
        fns = (lib.avm_normal_eq_fused, lib.avm_normal_eq_warps,
               lib.avm_normal_eq_init)
    elif name == "lm_cost_fused":
        # (pointers, batch, nf, nfeat, mode, c2, sqrt_aw, min_inv_depth,
        #  nielsen, lam_up, lam_down, pred_f64, f64, td_consts, stream)
        lib.avm_lm_cost_fused.argtypes = [ptr] + [i32] * 4 + [f64] * 3 + \
            [i32] + [f64] * 2 + [i32] * 2 + [ptr] * 2
        fns = (lib.avm_lm_cost_fused, lib.avm_lm_cost_init)
    elif name == "preint_scan":
        # (dts, accs, gyrs, acc0, gyr0, ba, bg, dp, dq, dv, J, P, dt_sum, S,
        #  batch, n, with_cov, f64, noise_var, dt_ref, stream)
        lib.avm_preint_scan.argtypes = [ptr] * 14 + [i32] * 4 + [ptr, f64,
                                                                 ptr]
        fns = (lib.avm_preint_scan, lib.avm_preint_scan_init)
    elif name == "logdet_psd_batched":
        # (M, out, batch, n, stamps, stream)
        lib.avm_logdet_psd_batched.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
        # (Om, Deltas, scale, out, batch, n, stamps, stream)
        lib.avm_logdet_psd_affine_batched.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, ptr, ptr]
        lib.avm_logdet_psd_smem_bytes.argtypes = [i32]
        fns = (lib.avm_logdet_psd_batched, lib.avm_logdet_psd_affine_batched,
               lib.avm_logdet_psd_smem_bytes, lib.avm_logdet_psd_init)
    else:
        # (H, g, H_lp, h_ll, g_l, lam, dx, d_rho, pred, batch, D, F, stamps,
        #  stream)
        lib.avm_schur_solve_fused.argtypes = [ptr] * 9 + [i32] * 3 + [ptr] * 2
        lib.avm_schur_cluster_size.argtypes = [i32]
        lib.avm_schur_active_clusters.argtypes = [i32]
        lib.avm_schur_set_max_cluster.argtypes = [i32]
        lib.avm_schur_solve_fused_smem_bytes.argtypes = [i32, i32]
        fns = (lib.avm_schur_solve_fused, lib.avm_schur_cluster_size,
               lib.avm_schur_active_clusters, lib.avm_schur_set_max_cluster,
               lib.avm_schur_solve_fused_smem_bytes,
               lib.avm_schur_solve_fused_init)
    for fn in fns:
        fn.restype = i32
    fns[-1].argtypes = []
    return fns[-1]


def _check(x: Tensor, name: str, shape: tuple, device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch refused, CUDA error {err}")


# ----------------------------------------------------------------------------
# The blocked LDLᵀ both kernels factor through, in plain PyTorch
# ----------------------------------------------------------------------------

# panel width of `csrc/blocked_ldl.cuh` as both kernels instantiate it
LDL_NB = 16
# entries of the optional clock64() stamp buffer (int64, on the card); thread
# 0 of block 0 fills it at the phase boundaries
LOGDET_STAMPS = ("start", "load", "factor", "end")
SCHUR_STAMPS = ("start", "load", "schur_product", "scale", "factor", "solve",
                "epilogue")
NE_STAMPS = ("start", "setup", "projection", "merge_prior", "imu_small",
             "write")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _guard_floor(p: Tensor) -> Tensor:
    """The logdet kernel's pivot rule: floor at 1e-30, a NaN stays NaN."""
    return torch.where(p < 1e-30, torch.full_like(p, 1e-30), p)


def _guard_abs(p: Tensor) -> Tensor:
    """The Schur kernel's pivot rule: |p| ≤ 1e-30 (or NaN) → 1e-30."""
    return torch.where(p.abs() > 1e-30, p, torch.full_like(p, 1e-30))


def blocked_ldl_plain(A: Tensor, nb: int, rhs: Tensor = None,
                      guard: str = "floor"):
    """Plain PyTorch of `csrc/blocked_ldl.cuh`, step for step: a blocked
    right-looking LDLᵀ of the lower triangle without pivoting.

    A [B,n,n]; rhs [B,n] or None; guard "floor" (logdet rule) or "abs"
    (Schur rule). The order is padded to a multiple of `nb` with identity
    rows (pivot 1). Per panel: the nb×nb diagonal block is eliminated column
    by column (unscaled columns W = L·D kept in place); every row below, and
    the right-hand side as one more row, forward-solves its nb entries
    against the block (the scaled L stays in the lower triangle, the
    unscaled W goes transposed into the upper triangle); the trailing lower
    triangle takes the rank-nb update L·Wᵀ. With a right-hand side a blocked
    backward substitution follows (diagonal block, then the nb-wide update
    of everything above it, read from the upper triangle).

    Returns (pivots [B,n] after the guard, solution [B,n] or None)."""
    guard_fn = {"floor": _guard_floor, "abs": _guard_abs}[guard]
    B, n, _ = A.shape
    np_ = _round_up(n, nb)
    W = torch.zeros((B, np_, np_), dtype=A.dtype, device=A.device)
    W[:, :n, :n] = A
    pad = torch.arange(n, np_, device=A.device)
    W[:, pad, pad] = 1.0
    z = torch.zeros((B, np_), dtype=A.dtype, device=A.device)
    if rhs is not None:
        z[:, :n] = rhs
    piv = torch.zeros_like(z)
    dinv = torch.zeros_like(z)
    for k0 in range(0, np_, nb):
        k1 = k0 + nb
        blk = W[:, k0:k1, k0:k1]
        for j in range(nb):                     # diagonal block, one warp
            d = guard_fn(blk[:, j, j])
            piv[:, k0 + j] = d
            dinv[:, k0 + j] = 1.0 / d
            col = blk[:, j + 1:, j]
            lr = col * dinv[:, k0 + j, None]
            blk[:, j + 1:, j + 1:] -= lr[:, :, None] * col[:, None, :]
        # panel solve: the rows below the block and the right-hand side
        X = torch.cat([W[:, k1:, k0:k1], z[:, None, k0:k1]], dim=1)
        L = torch.zeros_like(X)
        for k in range(nb):
            L[:, :, k] = X[:, :, k] * dinv[:, k0 + k, None]
            X[:, :, k + 1:] -= L[:, :, k, None] * blk[:, None, k + 1:, k]
        Lm, Xm = L[:, :-1], X[:, :-1]
        W[:, k1:, k0:k1] = Lm
        W[:, k0:k1, k1:] = Xm.mT
        z[:, k0:k1] = X[:, -1]
        # trailing update (the kernel touches the lower triangle only)
        W[:, k1:, k1:] -= Lm @ Xm.mT
        z[:, k1:] -= (Xm @ L[:, -1, :, None])[:, :, 0]
    if rhs is None:
        return piv[:, :n], None
    y = torch.zeros_like(z)
    for k0 in range(np_ - nb, -1, -nb):
        for j in range(nb - 1, -1, -1):         # diagonal block, one warp
            yj = z[:, k0 + j] * dinv[:, k0 + j]
            y[:, k0 + j] = yj
            z[:, k0:k0 + j] -= W[:, k0 + j, k0:k0 + j] * yj[:, None]
        z[:, :k0] -= (W[:, :k0, k0:k0 + nb] @ y[:, k0:k0 + nb, None])[:, :, 0]
    return piv[:, :n], y[:, :n]


def _stamps_ptr(stamps, names: tuple, device) -> int:
    if stamps is None:
        return 0
    if (stamps.dtype != torch.int64 or stamps.device != device
            or not stamps.is_contiguous() or stamps.numel() < len(names)):
        raise ValueError(
            f"stamps: expected a contiguous int64 tensor of {len(names)} "
            f"entries on {device}")
    return stamps.data_ptr()


# ----------------------------------------------------------------------------
# Batched PSD log-determinant
# ----------------------------------------------------------------------------


def logdet_smem_bytes(n: int) -> int:
    """Shared memory one block of the logdet kernel needs for order n: the
    matrix padded to a multiple of the panel width, row stride 4 more (16-byte
    rows, 4 banks apart), and one reciprocal pivot per row."""
    np_ = _round_up(n, LDL_NB)
    return (np_ * (np_ + 4) + np_) * 4


def logdet_psd_batched_plain(M: Tensor) -> Tensor:
    """Plain PyTorch version of the logdet kernel's arithmetic, unblocked:
    right-looking elimination (pivot floored at 1e-30, multiply by the
    reciprocal pivot), one batched rank-1 update per column. M [B,N,N]
    float32 → [B]. (`blocked_ldl_plain` is the kernel's blocked order.)"""
    A = M.clone()
    n = A.shape[-1]
    acc = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    for j in range(n):
        d = torch.clamp(A[:, j, j], min=1e-30)
        acc = acc + torch.log(d)
        col = A[:, j + 1:, j]
        lr = col * (1.0 / d)[:, None]
        A[:, j + 1:, j + 1:] -= lr[:, :, None] * col[:, None, :]
    return acc


def _check_logdet_order(N: int) -> None:
    if logdet_smem_bytes(N) > MAX_SMEM_BYTES:
        raise ValueError(
            f"order {N} needs {logdet_smem_bytes(N)} bytes of shared "
            f"memory, a block has {MAX_SMEM_BYTES}")


def logdet_psd_batched(M: Tensor, stamps: Tensor = None) -> Tensor:
    """Batched PSD log-determinant. M: [B,N,N] float32 → [B] float32.

    On a CUDA tensor: one launch of the blocked elimination kernel (one
    block per matrix, the matrix in shared memory). On a CPU tensor: the
    plain version. `stamps`: optional int64 tensor on the card that takes
    block 0's clock64() at `LOGDET_STAMPS`."""
    if M.dim() != 3 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"M: expected [B,N,N], got {tuple(M.shape)}")
    _check(M, "M", M.shape, M.device)
    if not M.is_cuda:
        return logdet_psd_batched_plain(M)
    B, N, _ = M.shape
    _check_logdet_order(N)
    lib = build_kernels()["logdet_psd_batched"]
    M = M.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=M.device)
    with torch.cuda.device(M.device):
        err = lib.avm_logdet_psd_batched(
            M.data_ptr(), out.data_ptr(), B, N,
            _stamps_ptr(stamps, LOGDET_STAMPS, M.device),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "logdet_psd_batched")
    launch_counts["logdet_psd_batched"] += 1
    return out


def logdet_psd_affine_batched(Om: Tensor, Deltas: Tensor, scale: Tensor,
                              stamps: Tensor = None) -> Tensor:
    """logdet(Om + scale_f · Deltas_f) for every f, float32.

    Om [N,N], Deltas [F,N,N], scale [F] → [F]. On CUDA tensors: one launch
    of the logdet kernel with the loader that forms the sum (product rounded,
    then sum rounded, as the materialised expression) while it fills shared
    memory, so nothing of size [F,N,N] is written. On CPU tensors:
    `logdet_psd_batched` of the materialised sum. Counts as a launch of
    `logdet_psd_batched`."""
    if Om.dim() != 2 or Om.shape[0] != Om.shape[1] or Deltas.dim() != 3:
        raise ValueError(
            f"expected Om [N,N] and Deltas [F,N,N], got {tuple(Om.shape)} "
            f"and {tuple(Deltas.shape)}")
    N, F = Om.shape[0], Deltas.shape[0]
    dev = Om.device
    _check(Om, "Om", (N, N), dev)
    _check(Deltas, "Deltas", (F, N, N), dev)
    _check(scale, "scale", (F,), dev)
    if not Om.is_cuda:
        return logdet_psd_batched(Om[None] + scale[:, None, None] * Deltas)
    _check_logdet_order(N)
    lib = build_kernels()["logdet_psd_batched"]
    Om, Deltas, scale = Om.contiguous(), Deltas.contiguous(), scale.contiguous()
    out = torch.empty(F, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.avm_logdet_psd_affine_batched(
            Om.data_ptr(), Deltas.data_ptr(), scale.data_ptr(),
            out.data_ptr(), F, N, _stamps_ptr(stamps, LOGDET_STAMPS, dev),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "logdet_psd_affine_batched")
    launch_counts["logdet_psd_batched"] += 1
    return out


def logdet_psd(M: Tensor) -> Tensor:
    """[..., N, N] PSD logdet: the elimination kernel for a float32 [B,N,N]
    batch on a CUDA device; `lie.logdet_psd` (Cholesky) for what the kernel
    does not exist for — CPU tensors, other ranks, and float64, which the
    selector needs where float32 cannot resolve the gains."""
    if M.is_cuda and M.dim() == 3 and M.dtype == torch.float32:
        return logdet_psd_batched(M)
    return lie.logdet_psd(M)


# ----------------------------------------------------------------------------
# Fused Schur-reduction + damped solve (the LM hot path)
# ----------------------------------------------------------------------------

_SCHUR_TILE_F = 32


def schur_smem_bytes(D: int, F: int) -> int:
    """Shared memory one block of the fused Schur kernel needs (the layout
    of `csrc/schur_solve_fused.cu`): the working matrix padded to the panel
    width, a two-stage ring of `H_lp` tiles, six vectors of the padded
    order, the right-hand side's panel row, two landmark vectors and the
    reduction scratch."""
    dp = _round_up(D, LDL_NB)
    lda = dp + 4
    fp = _round_up(F, _SCHUR_TILE_F)
    floats = dp * lda + 2 * _SCHUR_TILE_F * lda + 6 * dp + LDL_NB + 2 * fp + 64
    return floats * 4


def schur_work(D: int, F: int):
    """(floats moved, floating-point operations) of one scenario of the
    fused Schur solve: inputs H, g, H_lp, h_ll, g_l, lam read once, dx,
    d_rho, pred written once; symmetric Schur product F·D·(D+1) flop,
    factorization D³/3, two triangular solves 2D², g_red and
    back-substitution 4FD. The elementwise work (landmark inverses, damping,
    scaling, the predicted reduction) is left out."""
    floats = D * D + D + F * D + 2 * F + 1 + D + F + 1
    flops = F * D * (D + 1) + D ** 3 / 3 + 2 * D * D + 4 * F * D
    return floats, flops


def schur_cluster_size(batch: int) -> int:
    """Thread blocks the Schur kernel spends on one scenario of a batch: a
    cluster of 8, 4, 2 or 1, the widest of which the card holds `batch` at
    once (the product phase is split over the cluster). Needs the built
    library, so a CUDA device."""
    return build_kernels()["schur_solve_fused"].avm_schur_cluster_size(batch)


def _schur_scaled_system(H, g, H_lp, h_ll, g_l, lam):
    """Front half of the fused Schur solve: landmark inverses, Schur product,
    damping, Jacobi scaling. Returns (A scaled, b scaled, ds, damp, g_red,
    inv_h)."""
    lam_ = lam[:, None]
    inv_h = torch.where(h_ll > 1e-10, 1.0 / (h_ll * (1.0 + lam_) + 1e-12),
                        torch.zeros_like(h_ll))
    W = H_lp * inv_h[:, :, None]
    H_red = H - W.mT @ H_lp
    g_red = g - (W.mT @ g_l[:, :, None])[:, :, 0]
    diag = torch.diagonal(H_red, dim1=-2, dim2=-1)
    damp = lam_ * torch.clamp(diag, min=1e-8) + 1e-10
    ds = 1.0 / torch.sqrt(torch.clamp(diag + damp, min=1e-20))
    A = (H_red + torch.diag_embed(damp)) * ds[:, :, None] * ds[:, None, :]
    return A, -g_red * ds, ds, damp, g_red, inv_h


def _schur_outputs(y, ds, damp, g_red, inv_h, H_lp, h_ll, g_l, lam):
    """Back half: dx, landmark back-substitution, predicted reduction."""
    dx = y * ds
    d_rho = -inv_h * (g_l + (H_lp @ dx[:, :, None])[:, :, 0])
    pred = 0.5 * torch.sum(dx * (damp * dx - g_red), dim=-1) + \
        0.5 * torch.sum(d_rho * (lam[:, None] * h_ll * d_rho - g_l), dim=-1)
    return dx, d_rho, pred


def schur_solve_fused_plain(H, g, H_lp, h_ll, g_l, lam):
    """Plain PyTorch version of the fused Schur kernel's arithmetic, float32,
    unblocked: landmark inverses, Schur product, damping, Jacobi scaling,
    LDLᵀ elimination with the right-hand side as an extra row, backward
    substitution, landmark back-substitution, predicted reduction. Shapes as
    `schur_solve_fused`. (`blocked_ldl_plain` is the kernel's blocked
    order of the elimination.)"""
    D = H.shape[-1]
    A, b, ds, damp, g_red, inv_h = _schur_scaled_system(
        H, g, H_lp, h_ll, g_l, lam)
    # working array: rows 0..D-1 the matrix, row D the right-hand side
    Wk = torch.cat([A, b[:, None, :]], dim=1)
    for j in range(D):
        inv_d = 1.0 / _guard_abs(Wk[:, j, j])
        col = Wk[:, j + 1:D, j]                       # [B, D-j-1]
        lr = Wk[:, j + 1:, j] * inv_d[:, None]        # rows j+1..D
        Wk[:, j + 1:, j + 1:] -= lr[:, :, None] * col[:, None, :]
    z = Wk[:, D, :].clone()
    y = torch.zeros_like(z)
    for j in range(D - 1, -1, -1):
        yj = z[:, j] / _guard_abs(Wk[:, j, j])
        y[:, j] = yj
        z[:, :j] -= Wk[:, j, :j] * yj[:, None]
    return _schur_outputs(y, ds, damp, g_red, inv_h, H_lp, h_ll, g_l, lam)


def schur_solve_fused(H: Tensor, g: Tensor, H_lp: Tensor, h_ll: Tensor,
                      g_l: Tensor, lam: Tensor, stamps: Tensor = None):
    """One-launch damped Schur solve for a batch of scenarios, float32.

    H [B,D,D], g [B,D], H_lp [B,F,D], h_ll [B,F], g_l [B,F], lam [B] →
    (dx [B,D], d_rho [B,F], pred [B]). The batch is the kernel's grid: one
    block per scenario, or a cluster of `schur_cluster_size(B)` blocks where
    the batch leaves SMs idle. On CPU tensors the plain version runs instead.
    `stamps`: optional int64 tensor on the card that takes block 0's
    clock64() at `SCHUR_STAMPS`."""
    if H.dim() != 3 or H.shape[-1] != H.shape[-2] or H_lp.dim() != 3:
        raise ValueError(
            f"expected H [B,D,D] and H_lp [B,F,D], got {tuple(H.shape)} "
            f"and {tuple(H_lp.shape)}")
    B, D, _ = H.shape
    F = H_lp.shape[1]
    dev = H.device
    _check(H, "H", (B, D, D), dev)
    _check(g, "g", (B, D), dev)
    _check(H_lp, "H_lp", (B, F, D), dev)
    _check(h_ll, "h_ll", (B, F), dev)
    _check(g_l, "g_l", (B, F), dev)
    _check(lam, "lam", (B,), dev)
    if not H.is_cuda:
        return schur_solve_fused_plain(H, g, H_lp, h_ll, g_l, lam)
    if schur_smem_bytes(D, F) > MAX_SMEM_BYTES:
        raise ValueError(
            f"D={D}, F={F} need {schur_smem_bytes(D, F)} bytes of shared "
            f"memory, a block has {MAX_SMEM_BYTES}")
    lib = build_kernels()["schur_solve_fused"]
    H, g, H_lp, h_ll, g_l, lam = (
        x.contiguous() for x in (H, g, H_lp, h_ll, g_l, lam))
    dx = torch.empty((B, D), dtype=torch.float32, device=dev)
    d_rho = torch.empty((B, F), dtype=torch.float32, device=dev)
    pred = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.avm_schur_solve_fused(
            H.data_ptr(), g.data_ptr(), H_lp.data_ptr(), h_ll.data_ptr(),
            g_l.data_ptr(), lam.data_ptr(), dx.data_ptr(), d_rho.data_ptr(),
            pred.data_ptr(), B, D, F, _stamps_ptr(stamps, SCHUR_STAMPS, dev),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "schur_solve_fused")
    launch_counts["schur_solve_fused"] += 1
    return dx, d_rho, pred


# ----------------------------------------------------------------------------
# The launchers of the two kernels with no TPU counterpart
# ----------------------------------------------------------------------------


def flat_batch(x: Tensor, batch: tuple, shape: tuple, dtype=None) -> Tensor:
    """x broadcast to batch + shape as a contiguous [B, *shape] (in `dtype`
    where given): the launchers' layout. None stays None."""
    if x is None:
        return None
    if dtype is not None:
        x = x.to(dtype)
    flat = (math.prod(batch),) + shape
    if x.shape != flat:       # no dispatch for what is already in the layout
        x = x.expand(batch + shape).reshape(flat)
    return x.contiguous()


def unflat_batch(outs, batch: tuple) -> tuple:
    """A launcher's [B, ...] outputs in the caller's batch shape."""
    return tuple(x if x is None or x.shape[:1] == batch
                 else x.reshape(batch + x.shape[1:]) for x in outs)


def _check_inputs(kernel: str, inputs: dict, shapes: dict,
                  optional: tuple = ()) -> tuple:
    """Checks the inputs of `kernel` named in `shapes`: each a contiguous
    tensor of shape [B, *shapes[name]] on the CUDA device of the first, of
    its type (float32 or float64; `anchor` int64); those in `optional` may
    be None. Returns (B, type, device)."""
    first = inputs.get(next(iter(shapes)))
    if first is None or not first.is_cuda:
        raise ValueError(f"{kernel}: the kernel takes CUDA tensors")
    B, dtype, dev = first.shape[:1].numel(), first.dtype, first.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel}: the kernel takes float32 or float64, got "
                        f"{dtype}")
    for name, shape in shapes.items():
        x = inputs.get(name)
        want = torch.int64 if name == "anchor" else dtype
        if x is None and name in optional:
            continue
        if (x is None or x.dtype != want or x.device != dev
                or x.shape != (B, *shape) or not x.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name}: expected a contiguous {want} "
                f"{(B, *shape)} on {dev}, got " + ("nothing" if x is None else
                f"{x.dtype} {tuple(x.shape)} on {x.device}"))
    return B, dtype, dev


def preint_scan(dts: Tensor, accs: Tensor, gyrs: Tensor, acc0: Tensor,
                gyr0: Tensor, ba: Tensor, bg: Tensor, noise_var, dt_ref: float,
                with_cov: bool = True):
    """One launch of the preintegration kernel on B padded IMU pairs, one
    block each: dts [B,N], accs and gyrs [B,N,3], acc0, gyr0, ba and bg
    [B,3], contiguous CUDA tensors of one type, float32 or float64;
    `noise_var` the 18 variances of Q's diagonal, `dt_ref` the sample period
    they assume → (dp [B,3], dq [B,4], dv [B,3], J [B,15,15], P [B,15,15],
    dt_sum [B], S [B,15,15] or None without the covariance). The scan stops
    after each pair's last row whose dt is not 0; the covariance's Cholesky
    inverse is taken in the same launch; nothing is read back to the host."""
    n = accs.shape[1] if accs.dim() == 3 else -1
    B, dtype, dev = _check_inputs(
        "preint_scan", dict(dts=dts, accs=accs, gyrs=gyrs, acc0=acc0,
                            gyr0=gyr0, ba=ba, bg=bg),
        dict(dts=(n,), accs=(n, 3), gyrs=(n, 3), acc0=(3,), gyr0=(3,),
             ba=(3,), bg=(3,)))
    if len(noise_var) != 18:
        raise ValueError(f"preint_scan: {len(noise_var)} variances, not 18")
    var = (ctypes.c_double * 18)(*noise_var)          # passed by value
    empty = lambda *shape: torch.empty((B,) + shape, dtype=dtype, device=dev)
    outs = (empty(3), empty(4), empty(3), empty(15, 15), empty(15, 15),
            empty(), empty(15, 15) if with_cov else None)
    lib = build_kernels()["preint_scan"]
    with torch.cuda.device(dev):
        err = lib.avm_preint_scan(
            *(x.data_ptr() for x in (dts, accs, gyrs, acc0, gyr0, ba, bg)),
            *(0 if x is None else x.data_ptr() for x in outs),
            B, n, int(with_cov), int(dtype == torch.float64),
            ctypes.addressof(var), float(dt_ref),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "preint_scan")
    launch_counts["preint_scan"] += 1
    return outs


def normal_eq_inputs(nf: int, nfeat: int, td: bool = False) -> dict:
    """The inputs of the normal equations' kernel by name, in the order of
    `csrc/normal_eq_fused.cu`'s pointer table, each with its shape after the
    batch, for NF = `nf` frames (W = NF - 1 pairs, D = 15·NF + 13) and F =
    `nfeat` landmark slots (`Args` in the source says what each holds); with
    `td` the time offset's instance, which takes the image velocities and
    td at each frame's capture besides."""
    W, F, D = nf - 1, nfeat, 15 * nf + 13
    td_in = {"vel": (F, nf, 2), "td_obs": (nf,)} if td else {}
    pose = {"p": (nf, 3), "q": (nf, 4), "v": (nf, 3), "ba": (nf, 3),
            "bg": (nf, 3), "tic": (3,), "qic": (4,), "td": ()}
    return {**pose, "inv_depth": (F,),
            "pre_dp": (W, 3), "pre_dq": (W, 4), "pre_dv": (W, 3),
            "pre_J": (W, 15, 15), "pre_dt": (W,), "pre_ba": (W, 3),
            "pre_bg": (W, 3), "pre_S": (W, 15, 15), "pre_valid": (W,),
            "pts": (F, nf, 3), "mask": (F, nf), "feat_valid": (F,),
            "feat_w": (F,), "zupt_w": (nf,), "J0": (D, D), "r0": (D,),
            **{"lin_" + k: s for k, s in pose.items()}, "prior_w": (),
            "p_ref": (3,), "q_ref": (4,), "pin_rp": (), "H0": (D, D),
            **td_in, "anchor": (F,)}


# inputs the kernel takes as null: no feature weights (1), no ZUPT rows, no
# roll/pitch scale (1), no td at the frames' capture (0)
NE_OPTIONAL = ("feat_w", "zupt_w", "pin_rp", "td_obs")


def _td_table(td_consts):
    """The time offset's constants (TR / ROW, fy, cy − ROW / 2) as the
    launch's array of three doubles, or None: the instance without td."""
    if td_consts is None:
        return None, None
    if len(td_consts) != 3:
        raise ValueError(f"td_consts: (tr_over_row, row_fy, row_c0), got "
                         f"{len(td_consts)} numbers")
    table = (ctypes.c_double * 3)(*map(float, td_consts))
    return table, ctypes.addressof(table)


def normal_eq_fused(inputs: dict, c2: float, sqrt_aw: float, est_ext: bool,
                    stamps: Tensor = None, td_consts: tuple = None):
    """One launch of the normal equations' kernel on B scenarios, one block
    each: `inputs` the tensors `normal_eq_inputs` names, contiguous [B, ...]
    CUDA tensors of one type, float32 or float64 (`anchor` int64); `c2` the
    Cauchy scale squared, `sqrt_aw` the square root of the gauge anchor's
    weight → (H [B,D,D], g [B,D], H_lp [B,F,D], h_ll [B,F], g_l [B,F]).
    `stamps`: optional int64 tensor on the card that takes block 0's
    clock64() at `NE_STAMPS`. `td_consts` (TR / ROW, fy, cy − ROW / 2): the
    instance that estimates the time offset, whose inputs are
    `normal_eq_inputs(..., td=True)`; counted as `normal_eq_fused_td`."""
    nf, F = inputs["p"].shape[1], inputs["inv_depth"].shape[1]
    td = td_consts is not None
    shapes = normal_eq_inputs(nf, F, td)
    B, dtype, dev = _check_inputs("normal_eq_fused", inputs, shapes,
                                  NE_OPTIONAL)
    f64 = int(dtype == torch.float64)
    lib = build_kernels()["normal_eq_fused"]
    if lib.avm_normal_eq_warps(nf, f64, int(td)) == 0:
        raise ValueError(f"normal_eq_fused: {nf} frames do not fit a block's "
                         f"shared memory")
    D = 15 * nf + 13
    empty = lambda *shape: torch.empty((B,) + shape, dtype=dtype, device=dev)
    outs = (empty(D, D), empty(D), empty(F, D), empty(F), empty(F))
    ptrs = [0 if inputs.get(k) is None else inputs[k].data_ptr()
            for k in shapes] + [x.data_ptr() for x in outs] + \
        [_stamps_ptr(stamps, NE_STAMPS, dev)]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    consts, consts_ptr = _td_table(td_consts)
    with torch.cuda.device(dev):
        err = lib.avm_normal_eq_fused(
            ctypes.addressof(table), B, nf, F, float(c2), float(sqrt_aw),
            int(est_ext), f64, consts_ptr,
            torch.cuda.current_stream().cuda_stream)
    name = "normal_eq_fused_td" if td else "normal_eq_fused"
    _raise_on(err, name)
    launch_counts[name] += 1
    return outs


def lm_cost_inputs(nf: int, nfeat: int, td: bool = False) -> dict:
    """The inputs of the cost phase's kernel by name, in the order of
    `csrc/lm_cost_fused.cu`'s pointer table, each with its shape after the
    batch: the normal equations' inputs but H0 (`normal_eq_inputs`)."""
    return {k: s for k, s in normal_eq_inputs(nf, nfeat, td).items()
            if k != "H0"}


# the kernel's modes and, for each, the step tensors it takes
LM_COST_MODES = {"evaluate": (0, ()),
                 "step": (1, ("dx", "d_rho", "pred", "lam", "cost")),
                 "retract": (2, ("dx", "d_rho", "pred"))}
# the outputs, in the order of the pointer table after the inputs
LM_COST_OUTPUTS = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "inv_depth",
                   "lam", "cost", "ok", "imu_chi2", "prior_chi2")


def lm_cost_fused(inputs: dict, mode: str, c2: float, sqrt_aw: float,
                  min_inv_depth: float, nielsen: bool, lam_up: float,
                  lam_down: float, step: tuple = (),
                  diagnostics: bool = False, td_consts: tuple = None) -> dict:
    """One launch of the cost phase's kernel on B scenarios, one block each:
    `inputs` the tensors `lm_cost_inputs` names, as `normal_eq_fused` takes
    them (the state's leaves the iterate). `mode`:

    - "evaluate": the cost at the state; with `diagnostics` also `imu_chi2`
      and `prior_chi2` (`window.imu_chi2_mean`, `window.prior_chi2`);
    - "step": `step` = (dx [B,D], d_rho [B,F], pred [B], lam [B], cost [B])
      → the next iterate's leaves (p ... inv_depth), `lam`, `cost` and `ok`;
    - "retract": `step` = (dx, d_rho, pred) → the candidate's leaves, its
      `cost`, and in `ok` whether the step was finite.

    dx, d_rho and lam are of the state's type, pred float32 or float64, cost
    float64. `c2`, `sqrt_aw` as `normal_eq_fused`; `nielsen` the damping rule
    ("halving" by `lam_up` and `lam_down` otherwise). Returns the outputs by
    name: the leaves and lam in the state's type, cost [B] float64, ok [B]
    bool, imu_chi2 and prior_chi2 [B]; nothing is written into the inputs.
    `td_consts` as `normal_eq_fused`'s: the instance that estimates the
    time offset, counted as `lm_cost_fused_td`."""
    nf, F = inputs["p"].shape[1], inputs["inv_depth"].shape[1]
    td = td_consts is not None
    shapes = lm_cost_inputs(nf, F, td)
    B, dtype, dev = _check_inputs("lm_cost_fused", inputs, shapes, NE_OPTIONAL)
    code, names = LM_COST_MODES[mode]
    D = 15 * nf + 13
    want = {"dx": ((D,), (dtype,)), "d_rho": ((F,), (dtype,)),
            "pred": ((), (torch.float32, torch.float64)),
            "lam": ((), (dtype,)), "cost": ((), (torch.float64,))}
    if len(step) != len(names):
        raise ValueError(f"lm_cost_fused: {mode} takes {names}, got "
                         f"{len(step)} tensors")
    for name, x in zip(names, step):
        shape, types = want[name]
        if (x.dtype not in types or x.device != dev
                or x.shape != (B, *shape) or not x.is_contiguous()):
            raise ValueError(
                f"lm_cost_fused: {name}: expected a contiguous {types[0]} "
                f"{(B, *shape)} on {dev}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    empty = lambda *shape, dt=dtype: torch.empty((B,) + shape, dtype=dt,
                                                  device=dev)
    out = {}
    if code:
        out.update({k: empty(*shapes[k]) for k in LM_COST_OUTPUTS[:9]})
    if mode == "step":
        out["lam"] = empty()
    out["cost"] = empty(dt=torch.float64)
    if code:
        out["ok"] = empty(dt=torch.bool)
    if mode == "evaluate" and diagnostics:
        out["imu_chi2"], out["prior_chi2"] = empty(), empty()
    ptrs = [0 if inputs.get(k) is None else inputs[k].data_ptr()
            for k in shapes] + [x.data_ptr() for x in step] + \
        [0] * (5 - len(step)) + \
        [out[k].data_ptr() if k in out else 0 for k in LM_COST_OUTPUTS]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    pred_f64 = int(len(step) > 2 and step[2].dtype == torch.float64)
    lib = build_kernels()["lm_cost_fused"]
    consts, consts_ptr = _td_table(td_consts)
    with torch.cuda.device(dev):
        err = lib.avm_lm_cost_fused(
            ctypes.addressof(table), B, nf, F, code, float(c2),
            float(sqrt_aw), float(min_inv_depth), int(nielsen), float(lam_up),
            float(lam_down), pred_f64, int(dtype == torch.float64),
            consts_ptr, torch.cuda.current_stream().cuda_stream)
    name = "lm_cost_fused_td" if td else "lm_cost_fused"
    _raise_on(err, name)
    launch_counts[name] += 1
    return out
