"""IMU preintegration — midpoint rule, batched over frame pairs.

Counterpart of `anticipated_vins_mono_tpu/ops/preintegration.py`. The JAX
version is a `lax.scan` over the samples of ONE pair, vmapped over pairs;
here the sample loop is a Python loop and every tensor carries the pairs
(and any scenario batch) as leading dimensions, so a window of W pairs with
N samples each costs N steps, not W·N.

Raw IMU samples live in padded buffers [..., N, ·]; padding rows carry
dt = 0, which makes the midpoint update an exact no-op but for the
renormalisation of δq.

On the card the whole scan of a call is one launch of a hand-written kernel
(`csrc/preint_scan.cu`; `preintegrate` packs its launcher's arguments); the
loop below, `preintegrate_plain`, is its plain version and the CPU path.

State-block layout: [0:3]=δp, [3:6]=δθ, [6:9]=δv, [9:12]=δba, [12:15]=δbg.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from anticipated_vins_mono_torch.ops import hopper_kernels, lie
from anticipated_vins_mono_torch.utils.timing import spanned

Tensor = torch.Tensor


class ImuNoise(NamedTuple):
    """Continuous-time IMU noise densities (EuRoC configuration)."""

    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 0.00004
    gyr_w: float = 2.0e-6
    dt_ref: float = 0.005  # nominal sample period the noise values assume

    def noise_cov18(self, dtype=torch.float64, device=None) -> Tensor:
        """18x18 diagonal noise covariance (na0, ng0, na1, ng1, nba, nbg)."""
        vals = [self.acc_n, self.gyr_n, self.acc_n, self.gyr_n,
                self.acc_w, self.gyr_w]
        d = torch.tensor([v ** 2 for v in vals for _ in range(3)],
                         dtype=torch.float64, device=device).to(dtype)
        return torch.diag(d)


class Preintegrated(NamedTuple):
    """Result of preintegrating one frame-to-frame IMU batch."""

    dp: Tensor        # [...,3]  Δ position
    dq: Tensor        # [...,4]  Δ orientation (wxyz)
    dv: Tensor        # [...,3]  Δ velocity
    J: Tensor         # [...,15,15] first-order Jacobian w.r.t. (state, biases)
    P: Tensor         # [...,15,15] covariance
    dt_sum: Tensor    # [...]    total integration time
    ba: Tensor        # [...,3]  linearization accel bias
    bg: Tensor        # [...,3]  linearization gyro bias
    S: Optional[Tensor] = None  # [...,15,15] whitening sqrt-info (L⁻¹, P=LLᵀ)


def _block(rows) -> Tensor:
    """`jnp.block` for a list of lists of [...,3,3] blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _midpoint_step(carry, inp, noise_cov, with_cov, dt_ref):
    """One midpoint update for every pair at once.

    carry: (dp, dq, dv, J, P, acc_prev, gyr_prev, ba, bg, dt_sum)
    inp:   (dt [...], acc [...,3], gyr [...,3]); dt == 0 rows are no-ops.
    """
    dp, dq, dv, J, P, acc0, gyr0, ba, bg, dt_sum = carry
    dt_s, acc1, gyr1 = inp
    dt = dt_s[..., None]           # broadcasts against [...,3]
    dtm = dt_s[..., None, None]    # broadcasts against [...,3,3]
    dtype = dp.dtype

    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    dq_new = lie.quat_normalize(lie.quat_mul(dq, lie.delta_q(un_gyr * dt)))
    un_acc0 = lie.quat_rotate(dq, acc0 - ba)
    un_acc1 = lie.quat_rotate(dq_new, acc1 - ba)
    un_acc = 0.5 * (un_acc0 + un_acc1)
    dp_new = dp + dv * dt + 0.5 * un_acc * dt * dt
    dv_new = dv + un_acc * dt

    if with_cov:
        batch = dp.shape[:-1]
        I3 = torch.eye(3, dtype=dtype, device=dp.device).expand(batch + (3, 3))
        R0 = lie.quat_to_rot(dq)
        R1 = lie.quat_to_rot(dq_new)
        a0x = lie.skew(acc0 - ba)
        a1x = lie.skew(acc1 - ba)
        wx = lie.skew(un_gyr)

        f_pq = -0.25 * R0 @ a0x * dtm * dtm + \
            -0.25 * R1 @ a1x @ (I3 - wx * dtm) * dtm * dtm
        f_pv = I3 * dtm
        f_pba = -0.25 * (R0 + R1) * dtm * dtm
        f_pbg = 0.25 * R1 @ a1x * dtm * dtm * dtm
        f_qq = I3 - wx * dtm
        f_qbg = -I3 * dtm
        f_vq = -0.5 * R0 @ a0x * dtm + -0.5 * R1 @ a1x @ (I3 - wx * dtm) * dtm
        f_vba = -0.5 * (R0 + R1) * dtm
        f_vbg = 0.5 * R1 @ a1x * dtm * dtm

        Z = torch.zeros_like(I3)
        F = _block([
            [I3, f_pq, f_pv, f_pba, f_pbg],
            [Z, f_qq, Z, Z, f_qbg],
            [Z, f_vq, I3, f_vba, f_vbg],
            [Z, Z, Z, I3, Z],
            [Z, Z, Z, Z, I3],
        ])

        v_p0 = 0.25 * R0 * dtm * dtm
        v_pq = -0.125 * R1 @ a1x * dtm * dtm * dtm
        v_p1 = 0.25 * R1 * dtm * dtm
        v_q = 0.5 * I3 * dtm
        v_v0 = 0.5 * R0 * dtm
        v_vq = -0.25 * R1 @ a1x * dtm * dtm
        v_v1 = 0.5 * R1 * dtm
        V = _block([
            [v_p0, v_pq, v_p1, v_pq, Z, Z],
            [Z, v_q, Z, v_q, Z, Z],
            [v_v0, v_vq, v_v1, v_vq, Z, Z],
            [Z, Z, Z, Z, I3 * dtm, Z],
            [Z, Z, Z, Z, Z, I3 * dtm],
        ])

        J_new = F @ J
        # per-sample noise at the nominal rate; samples spanning longer
        # intervals have their noise inflated by (dt/dt_ref)²
        nscale = torch.clamp(dtm / dt_ref, min=1.0) ** 2
        P_new = F @ P @ F.mT + nscale * (V @ noise_cov @ V.mT)
    else:
        J_new, P_new = J, P

    return (dp_new, dq_new, dv_new, J_new, P_new,
            acc1, gyr1, ba, bg, dt_sum + dt_s)


@spanned("preint")
def preintegrate(dts: Tensor, accs: Tensor, gyrs: Tensor,
                 acc0: Tensor, gyr0: Tensor,
                 ba: Tensor, bg: Tensor,
                 noise: ImuNoise,
                 with_cov: bool = True) -> Preintegrated:
    """Preintegrate (padded) IMU batches between frames.

    Args:
      dts:  [...,N] per-sample dt; 0 for padding rows (exact no-op).
      accs: [...,N,3], gyrs: [...,N,3] raw samples at the *end* of each dt.
      acc0/gyr0: [...,3] the sample at the start of each interval.
      ba/bg: [...,3] linearization-point biases.

    The leading dimensions (frame pairs, scenarios) are integrated together.
    CUDA tensors take one launch of the preintegration kernel, CPU tensors
    the loop over the N samples (`preintegrate_plain`).
    """
    if not accs.is_cuda:
        return preintegrate_plain(dts, accs, gyrs, acc0, gyr0, ba, bg, noise,
                                  with_cov)
    dtype = accs.dtype
    batch, n = accs.shape[:-2], accs.shape[-2]
    flat = lambda x, *shape: hopper_kernels.flat_batch(x, batch, shape, dtype)
    outs = hopper_kernels.preint_scan(
        flat(dts, n), flat(accs, n, 3), flat(gyrs, n, 3),
        *(flat(x, 3) for x in (acc0, gyr0, ba, bg)),
        # Q's diagonal, as the loop builds Q
        noise.noise_cov18(torch.float64).diagonal().tolist(), noise.dt_ref,
        with_cov=with_cov)
    dp, dq, dv, J, P, dt_sum, S = hopper_kernels.unflat_batch(outs, batch)
    return Preintegrated(dp, dq, dv, J, P, dt_sum, ba.to(dtype), bg.to(dtype),
                         S)


def preintegrate_plain(dts: Tensor, accs: Tensor, gyrs: Tensor,
                       acc0: Tensor, gyr0: Tensor,
                       ba: Tensor, bg: Tensor,
                       noise: ImuNoise,
                       with_cov: bool = True) -> Preintegrated:
    """`preintegrate` as a loop over the N samples, every pair at once: the
    plain version of the preintegration kernel. Arguments as
    `preintegrate`."""
    dtype, dev = accs.dtype, accs.device
    batch = accs.shape[:-2]
    ncov = noise.noise_cov18(dtype, dev)
    dts = dts.to(dtype)
    carry = (
        torch.zeros(batch + (3,), dtype=dtype, device=dev),
        lie.quat_identity(dtype, dev).expand(batch + (4,)),
        torch.zeros(batch + (3,), dtype=dtype, device=dev),
        torch.eye(15, dtype=dtype, device=dev).expand(batch + (15, 15)),
        torch.zeros(batch + (15, 15), dtype=dtype, device=dev),
        acc0.to(dtype), gyr0.to(dtype), ba.to(dtype), bg.to(dtype),
        torch.zeros(batch, dtype=dtype, device=dev),
    )
    for k in range(accs.shape[-2]):
        carry = _midpoint_step(
            carry, (dts[..., k], accs[..., k, :], gyrs[..., k, :]),
            ncov, with_cov, noise.dt_ref)
    dp, dq, dv, J, P, _, _, _, _, dt_sum = carry
    S = None
    if with_cov:
        eye = torch.eye(15, dtype=dtype, device=dev)
        L = lie.cholesky_or_nan(P + 1e-11 * eye)
        S = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Preintegrated(dp, dq, dv, J, P, dt_sum, ba.to(dtype), bg.to(dtype), S)


def corrected_deltas(pre: Preintegrated, ba: Tensor, bg: Tensor):
    """First-order bias-corrected deltas (dp, dq, dv) at new biases, using
    the preintegrated Jacobian — the cheap alternative to re-propagation."""
    dba = (ba - pre.ba)[..., None]
    dbg = (bg - pre.bg)[..., None]
    J = pre.J
    dp = pre.dp + (J[..., 0:3, 9:12] @ dba + J[..., 0:3, 12:15] @ dbg)[..., 0]
    dv = pre.dv + (J[..., 6:9, 9:12] @ dba + J[..., 6:9, 12:15] @ dbg)[..., 0]
    dq = lie.quat_mul(pre.dq, lie.delta_q((J[..., 3:6, 12:15] @ dbg)[..., 0]))
    return dp, lie.quat_normalize(dq), dv
