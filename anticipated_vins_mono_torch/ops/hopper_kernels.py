"""The two hand-written Hopper kernels, their wrappers and plain versions.

Counterpart of `anticipated_vins_mono_tpu/ops/pallas_kernels.py`:

- `logdet_psd_batched` — f32 [B,N,N] → [B] log-determinants by unpivoted
  elimination (`csrc/logdet_psd.cu`); the anticipation selector scores all
  candidates with it every greedy round;
- `schur_solve_fused` — the damped Schur-reduced solve of one LM iteration
  for a whole scenario batch in one launch (`csrc/schur_solve_fused.cu`).

The CUDA sources are compiled with `nvcc` for `sm_90a` at first use, one
compiler process per source started together, into `build/hopper_kernels/`
beside the package, and loaded with `ctypes`. Nothing is compiled when the
module is imported.

Each wrapper takes its plain PyTorch version (`*_plain`, the same arithmetic
in the same order, f32) only for tensors that lie on the CPU. For a CUDA
tensor it launches the kernel or raises; there is no fallback. Each launch
adds one to `launch_counts[name]`.
"""

from __future__ import annotations

import ctypes
import hashlib
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
}

# launches since the last reset, per kernel; a wrapper adds one exactly where
# it launches its kernel
launch_counts = {name: 0 for name in KERNEL_SOURCES}

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


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_kernels() -> dict:
    """Compile every kernel source that has no up-to-date library yet (all
    compilers started together) and load the libraries. Returns
    {kernel name: ctypes library}. Raises if a source does not compile."""
    missing = [n for n in KERNEL_SOURCES if n not in _libs]
    if not missing:
        return _libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        src = CSRC_DIR / KERNEL_SOURCES[name]
        out = _lib_path(src)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
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
        lib = ctypes.CDLL(str(_lib_path(CSRC_DIR / KERNEL_SOURCES[name])))
        _declare(name, lib)
        _libs[name] = lib
    return _libs


def _declare(name: str, lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "logdet_psd_batched":
        lib.avm_logdet_psd_batched.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.avm_logdet_psd_batched.restype = i32
    else:
        lib.avm_schur_solve_fused.argtypes = [ptr] * 9 + [i32] * 3 + [ptr]
        lib.avm_schur_solve_fused.restype = i32


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
# Batched PSD log-determinant
# ----------------------------------------------------------------------------


def logdet_smem_bytes(n: int) -> int:
    """Shared memory one block of the logdet kernel needs for order n."""
    return n * (n | 1) * 4


def logdet_psd_batched_plain(M: Tensor) -> Tensor:
    """Plain PyTorch version of the logdet kernel: the same right-looking
    elimination (pivot floored at 1e-30, multiply by the reciprocal pivot),
    one batched rank-1 update per column. M [B,N,N] float32 → [B]."""
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


def logdet_psd_batched(M: Tensor) -> Tensor:
    """Batched PSD log-determinant. M: [B,N,N] float32 → [B] float32.

    On a CUDA tensor: one launch of the elimination kernel (one block per
    matrix, the matrix in shared memory). On a CPU tensor: the plain
    version."""
    if M.dim() != 3 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"M: expected [B,N,N], got {tuple(M.shape)}")
    _check(M, "M", M.shape, M.device)
    if not M.is_cuda:
        return logdet_psd_batched_plain(M)
    B, N, _ = M.shape
    if logdet_smem_bytes(N) > MAX_SMEM_BYTES:
        raise ValueError(
            f"M: order {N} needs {logdet_smem_bytes(N)} bytes of shared "
            f"memory, a block has {MAX_SMEM_BYTES}")
    lib = build_kernels()["logdet_psd_batched"]
    M = M.contiguous()
    out = torch.empty(B, dtype=torch.float32, device=M.device)
    with torch.cuda.device(M.device):
        err = lib.avm_logdet_psd_batched(
            M.data_ptr(), out.data_ptr(), B, N,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "logdet_psd_batched")
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

_SCHUR_TILE_F = 16


def schur_smem_bytes(D: int, F: int) -> int:
    """Shared memory one block of the fused Schur kernel needs (the layout
    of `csrc/schur_solve_fused.cu`)."""
    dp = (D + 3) & ~3
    floats = 2 * _SCHUR_TILE_F * dp + dp * (dp + 1) + 5 * dp + F + 64
    return floats * 4


def schur_solve_fused_plain(H, g, H_lp, h_ll, g_l, lam):
    """Plain PyTorch version of the fused Schur kernel, float32, the kernel's
    steps in the kernel's order: landmark inverses, Schur product, damping,
    Jacobi scaling, LDLᵀ elimination with the right-hand side as an extra
    row, backward substitution, landmark back-substitution, predicted
    reduction. Shapes as `schur_solve_fused`."""
    D = H.shape[-1]
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
    # working array: rows 0..D-1 the matrix, row D the right-hand side
    Wk = torch.cat([A, (-g_red * ds)[:, None, :]], dim=1)

    def guard(p):
        return torch.where(p.abs() > 1e-30, p, torch.full_like(p, 1e-30))

    for j in range(D):
        inv_d = 1.0 / guard(Wk[:, j, j])
        col = Wk[:, j + 1:D, j]                       # [B, D-j-1]
        lr = Wk[:, j + 1:, j] * inv_d[:, None]        # rows j+1..D
        Wk[:, j + 1:, j + 1:] -= lr[:, :, None] * col[:, None, :]
    z = Wk[:, D, :].clone()
    y = torch.zeros_like(z)
    for j in range(D - 1, -1, -1):
        yj = z[:, j] / guard(Wk[:, j, j])
        y[:, j] = yj
        z[:, :j] -= Wk[:, j, :j] * yj[:, None]
    dx = y * ds
    d_rho = -inv_h * (g_l + (H_lp @ dx[:, :, None])[:, :, 0])
    pred = 0.5 * torch.sum(dx * (damp * dx - g_red), dim=-1) + \
        0.5 * torch.sum(d_rho * (lam_ * h_ll * d_rho - g_l), dim=-1)
    return dx, d_rho, pred


def schur_solve_fused(H: Tensor, g: Tensor, H_lp: Tensor, h_ll: Tensor,
                      g_l: Tensor, lam: Tensor):
    """One-launch damped Schur solve for a batch of scenarios, float32.

    H [B,D,D], g [B,D], H_lp [B,F,D], h_ll [B,F], g_l [B,F], lam [B] →
    (dx [B,D], d_rho [B,F], pred [B]). The batch is the kernel's grid: one
    block per scenario. On CPU tensors the plain version runs instead."""
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
            pred.data_ptr(), B, D, F,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "schur_solve_fused")
    launch_counts["schur_solve_fused"] += 1
    return dx, d_rho, pred
