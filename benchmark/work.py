"""Work functions of the two hand-written kernels, and the card's peaks.

Copies of the port's `ops/hopper_kernels.schur_work` and of the logdet
loader's count in `chip_smoke.logdet_affine_bound`, kept with the benchmark
so that a change to the port cannot change what a roofline share is
measured against. Each input byte is counted read once and each output byte
written once; each floating-point operation once.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
# full 700 W power limit): float32 outside the tensor cores, and HBM3.
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def schur_work(D: int, F: int):
    """(floats moved, flop) of one scenario of the fused Schur solve: H, g,
    H_lp, h_ll, g_l, λ read once; dx, d_rho, pred written once; the
    symmetric Schur product F·D·(D+1), the factorization D³/3, two
    triangular solves 2D², g_red and the back-substitution 4FD. The
    elementwise work is left out."""
    floats = D * D + D + F * D + 2 * F + 1 + D + F + 1
    flops = F * D * (D + 1) + D ** 3 / 3 + 2 * D * D + 4 * F * D
    return floats, flops


def logdet_affine_work(F: int, N: int):
    """(bytes moved, flop) of one launch of the logdet kernel with the
    affine loader, logdet(Ω + p_f·Δ_f) for f < F at order N: Ω, every Δ_f
    and p read once, one float written per f; the loader's F·2N² flop and
    N³/3 flop of elimination per matrix."""
    return (N * N + F * N * N + 2 * F) * 4, F * (2 * N * N + N ** 3 / 3)


def least_seconds(bytes_moved: float, flops: float) -> float:
    """The least time the card could take for the work: the larger of the
    byte bound and the operation bound at the published peaks."""
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)
