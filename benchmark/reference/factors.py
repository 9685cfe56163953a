"""Factor residuals for the sliding-window VIO backend — pure functions.

Counterpart of `anticipated_vins_mono_tpu/ops/factors.py`: IMU factor,
inverse-depth projection factor (plain, unit-sphere, and with time offset /
rolling shutter), Cauchy reweighting, and tangent-space Jacobians by
forward-mode differentiation of residual∘boxplus at δ=0 (`torch.func.jvp`).

Every residual broadcasts over leading batch dimensions. World gravity is
g = (0,0,+9.81) subtracted inside the residual, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from benchmark.reference import lie
from benchmark.reference.preintegration import (
    Preintegrated, corrected_deltas)
from benchmark.reference.tree import tree_map

Tensor = torch.Tensor

GRAVITY = 9.81007     # EuRoC magnitude
FOCAL_LENGTH = 460.0  # virtual focal length of the whitening


def gravity_vec(dtype=torch.float64, device=None) -> Tensor:
    return torch.tensor([0.0, 0.0, GRAVITY], dtype=dtype, device=device)


# ----------------------------------------------------------------------------
# IMU factor
# ----------------------------------------------------------------------------


def imu_residual_raw(p_i, q_i, v_i, ba_i, bg_i,
                     p_j, q_j, v_j, ba_j, bg_j,
                     pre: Preintegrated) -> Tensor:
    """Unwhitened 15-vector IMU residual, layout (P,R,V,BA,BG) = (0,3,6,9,12):
    bias-corrected preintegrated deltas against the state-implied deltas."""
    g = gravity_vec(p_i.dtype, p_i.device)
    dt = pre.dt_sum[..., None]
    dp, dq, dv = corrected_deltas(pre, ba_i, bg_i)

    q_i_inv = lie.quat_conj(q_i)  # unit quaternions
    r_p = lie.quat_rotate(q_i_inv, 0.5 * g * dt * dt + p_j - p_i - v_i * dt) - dp
    r_q = 2.0 * lie.quat_mul(lie.quat_conj(dq),
                             lie.quat_mul(q_i_inv, q_j))[..., 1:4]
    r_v = lie.quat_rotate(q_i_inv, g * dt + v_j - v_i) - dv
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return torch.cat([r_p, r_q, r_v, r_ba, r_bg], dim=-1)


def sqrt_info_from_cov(P: Tensor, jitter: float = 1e-11) -> Tensor:
    """Lower-triangular S = L⁻¹ with P = LLᵀ, so ‖S r‖² = rᵀP⁻¹r. A P that
    is not positive definite gives NaN (no exception), as the JAX
    counterpart does."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    L = lie.cholesky_or_nan(P + jitter * eye)
    return torch.linalg.solve_triangular(L, eye.expand_as(P), upper=False)


def imu_residual(p_i, q_i, v_i, ba_i, bg_i,
                 p_j, q_j, v_j, ba_j, bg_j,
                 pre: Preintegrated) -> Tensor:
    """Whitened IMU residual (what enters the least-squares objective)."""
    r = imu_residual_raw(p_i, q_i, v_i, ba_i, bg_i,
                         p_j, q_j, v_j, ba_j, bg_j, pre)
    S = pre.S if pre.S is not None else sqrt_info_from_cov(pre.P)
    return torch.einsum("...ij,...j->...i", S, r)


# ----------------------------------------------------------------------------
# Projection factor (inverse depth, between first observation i and frame j)
# ----------------------------------------------------------------------------


def _project_to_cam_j(p_i, q_i, p_j, q_j, tic, qic, inv_dep_i, pt_i):
    pts_cam_i = pt_i / inv_dep_i[..., None]
    pts_imu_i = lie.quat_rotate(qic, pts_cam_i) + tic
    pts_w = lie.quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = lie.quat_rotate(lie.quat_conj(q_j), pts_w - p_j)
    return lie.quat_rotate(lie.quat_conj(qic), pts_imu_j - tic)


def projection_residual_raw(p_i, q_i, p_j, q_j, tic, qic,
                            inv_dep_i, pt_i, pt_j) -> Tensor:
    """Unwhitened 2-vector reprojection residual: the landmark at inverse
    depth `inv_dep_i` along the ray `pt_i` of camera i, carried into camera
    j and perspective-divided against `pt_j`. pt_* are [...,3] with z=1."""
    pts_cam_j = _project_to_cam_j(p_i, q_i, p_j, q_j, tic, qic,
                                  inv_dep_i, pt_i)
    z = pts_cam_j[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return pts_cam_j[..., :2] / z - pt_j[..., :2]


def projection_residual(p_i, q_i, p_j, q_j, tic, qic,
                        inv_dep_i, pt_i, pt_j) -> Tensor:
    r = projection_residual_raw(p_i, q_i, p_j, q_j, tic, qic,
                                inv_dep_i, pt_i, pt_j)
    return (FOCAL_LENGTH / 1.5) * r


def projection_td_residual_raw(p_i, q_i, p_j, q_j, tic, qic,
                               inv_dep_i, td,
                               pt_i, pt_j, vel_i, vel_j,
                               td_i, td_j, row_i, row_j,
                               tr_over_row: float = 0.0) -> Tensor:
    """Projection residual with time offset td + rolling-shutter
    compensation: observations are shifted along their image velocity by
    (td − td_i + TR/ROW·row) before the standard reprojection chain."""
    shift_i = td - td_i + tr_over_row * row_i
    shift_j = td - td_j + tr_over_row * row_j
    pt_i_c = pt_i - shift_i[..., None] * torch.cat(
        [vel_i, torch.zeros_like(vel_i[..., :1])], dim=-1)
    pt_j_c = pt_j - shift_j[..., None] * torch.cat(
        [vel_j, torch.zeros_like(vel_j[..., :1])], dim=-1)
    return projection_residual_raw(p_i, q_i, p_j, q_j, tic, qic,
                                   inv_dep_i, pt_i_c, pt_j_c)


def projection_td_residual(*args, **kw) -> Tensor:
    return (FOCAL_LENGTH / 1.5) * projection_td_residual_raw(*args, **kw)


# ----------------------------------------------------------------------------
# Robust loss (Cauchy) — Triggs-style reweighting for IRLS/GN
# ----------------------------------------------------------------------------


def cauchy_weight(sq_norm: Tensor, scale: float = 1.0) -> Tensor:
    """sqrt-weight w such that r ← w·r in Gauss-Newton approximates the
    Cauchy-robustified problem ρ(s) = c²·log(1 + s/c²)."""
    c2 = scale * scale
    rho_p = 1.0 / (1.0 + sq_norm / c2)
    return torch.sqrt(rho_p)


# ----------------------------------------------------------------------------
# Tangent-space Jacobians via forward-mode autodiff of residual ∘ boxplus
# ----------------------------------------------------------------------------


class PoseTangent(NamedTuple):
    """Helper wrapping a pose (p,q) for tangent-space differentiation."""

    p: Tensor
    q: Tensor


def tangent_jacobian(res_fn, poses: tuple, linear_args: tuple,
                     consts: tuple = ()):
    """Jacobian of `res_fn(poses..., linear..., consts...)` w.r.t. minimal
    coordinates, for a whole batch of factors at once.

    `res_fn` takes len(poses) PoseTangent, the linear (vector or scalar)
    args and the per-factor constants, returns a residual vector, and
    broadcasts over leading dimensions. `poses`, `linear_args` and `consts`
    (tensors or tuples of tensors) all carry the same leading batch
    dimensions, those of `poses[0].p`.

    The derivative is the forward-mode one of residual∘boxplus at δ=0, as in
    the JAX package. All K tangent directions are evaluated in ONE
    `torch.func.jvp` call: they ride as an extra leading dimension of the
    inputs, with one more row that carries the pose as given and no tangent,
    whose primal output is the residual. Like the JAX package's `jacfwd`,
    the Jacobian rows are taken at the boxplus of δ=0: the position as given
    and the quaternion renormalised (q ⊗ deltaQ(0) = q exactly), with the
    tangent of that boxplus written out, q ⊗ [0, δθ/2] through the
    normalisation. In float32 this linearization point decides the rounding
    of a Jacobian column that is zero in exact arithmetic (the extrinsic's
    translation along the rotation axis of a planar run), and with it the
    first solve's step along that unobservable direction.

    Returns (residual [...,R], [J_pose [...,R,6]..., J_linear [...,R,dim]...]),
    a scalar linear arg giving [...,R].
    """
    n_p = len(poses)
    batch = poses[0].p.shape[:-1]
    nb = len(batch)
    ref = poses[0].p
    lin_dims = [a.shape[-1] if a.dim() > nb else 1 for a in linear_args]
    K = 6 * n_p + sum(lin_dims)
    # K direction rows, then the residual's row (no tangent)
    eye = torch.eye(K + 1, K, dtype=ref.dtype, device=ref.device)
    eye = eye.reshape((K + 1,) + (1,) * nb + (K,))       # [K+1,1..,K]

    lead = (K + 1,) + tuple(batch)
    up = lambda x: x[None].expand((K + 1,) + tuple(x.shape))
    primals, tangents = [], []
    for k, pose in enumerate(poses):
        e = eye[..., 6 * k: 6 * k + 6]
        tp = e[..., :3].expand(lead + (3,))
        # d/dδθ of normalize(q ⊗ deltaQ(δθ)) at 0: t = q ⊗ [0, e/2], then
        # the normalisation's tangent t/‖q‖ − q (q·t)/‖q‖³
        half = torch.cat([torch.zeros_like(e[..., :1]), 0.5 * e[..., 3:6]],
                         dim=-1)
        t = lie.quat_mul(pose.q[None], half)              # [K+1,...,4]
        norm = torch.linalg.norm(pose.q, dim=-1, keepdim=True)
        tq = t / norm - pose.q * (torch.sum(pose.q * t, dim=-1, keepdim=True)
                                  / norm ** 3)
        qn = (pose.q / norm)[None].expand((K,) + tuple(pose.q.shape))
        primals += [up(pose.p).contiguous(),
                    torch.cat([qn, pose.q[None]], dim=0)]
        tangents += [tp, tq]
    off = 6 * n_p
    for a, d in zip(linear_args, lin_dims):
        e = eye[..., off: off + d]
        t = e.expand(lead + (d,)) if a.dim() > nb else e[..., 0].expand(lead)
        primals.append(up(a).contiguous())
        tangents.append(t)
        off += d
    consts_up = tree_map(up, tuple(consts))

    def f(*prim):
        ps = [PoseTangent(prim[2 * k], prim[2 * k + 1]) for k in range(n_p)]
        return res_fn(*ps, *prim[2 * n_p:], *consts_up)

    res_k, jac_k = jvp(f, tuple(primals), tuple(tangents))
    jac = jac_k[:K].movedim(0, -1)                        # [...,R,K]
    jacs = [jac[..., 6 * k: 6 * k + 6] for k in range(n_p)]
    off = 6 * n_p
    for a, d in zip(linear_args, lin_dims):
        jacs.append(jac[..., off: off + d] if a.dim() > nb
                    else jac[..., off])
        off += d
    return res_k[K], jacs
