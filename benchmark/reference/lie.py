"""SO(3)/SE(3)/quaternion primitives on torch tensors.

Counterpart of `anticipated_vins_mono_tpu/ops/lie.py`, function for function.
Quaternions are Hamilton, stored `[w, x, y, z]`. Every function broadcasts
over leading batch dimensions and is free of in-place updates, so it can sit
under `torch.func.jvp`.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

# ----------------------------------------------------------------------------
# Quaternion algebra
# ----------------------------------------------------------------------------


def quat_identity(dtype=torch.float32, device=None) -> Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(q: Tensor, p: Tensor) -> Tensor:
    """Hamilton product q ⊗ p, both [..., 4] in wxyz, in scalar/vector form
    (w = q_w p_w − q_v·p_v, v = q_w p_v + p_w q_v + q_v × p_v): a handful of
    launches instead of one per component product."""
    qw, qv = q[..., :1], q[..., 1:]
    pw, pv = p[..., :1], p[..., 1:]
    w = qw * pw - torch.sum(qv * pv, dim=-1, keepdim=True)
    v = qw * pv + pw * qv + _cross(qv, pv)
    return torch.cat([w, v], dim=-1)


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis with broadcasting of the others
    (`torch.linalg.cross` wants equal ranks: the shorter one is padded)."""
    nd = max(a.dim(), b.dim())
    a = a.reshape((1,) * (nd - a.dim()) + tuple(a.shape))
    b = b.reshape((1,) * (nd - b.dim()) + tuple(b.shape))
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v [...,3] by unit quaternion(s) q [...,4]
    (expanded Rodrigues form, no 3x3 matrix)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_rot(q: Tensor) -> Tensor:
    """Unit quaternion [...,4] → rotation matrix [...,3,3]."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rot_to_quat(R: Tensor) -> Tensor:
    """Rotation matrix [...,3,3] → unit quaternion [...,4] (wxyz, w>=0).

    Branch-free Shepperd method: all four candidates are computed and the
    one with the largest pivot is gathered.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5

    c0 = torch.stack([qw[..., 0],
                      (m21 - m12) / (4 * qw[..., 0]),
                      (m02 - m20) / (4 * qw[..., 0]),
                      (m10 - m01) / (4 * qw[..., 0])], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4 * qw[..., 1]),
                      qw[..., 1],
                      (m01 + m10) / (4 * qw[..., 1]),
                      (m02 + m20) / (4 * qw[..., 1])], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4 * qw[..., 2]),
                      (m01 + m10) / (4 * qw[..., 2]),
                      qw[..., 2],
                      (m12 + m21) / (4 * qw[..., 2])], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4 * qw[..., 3]),
                      (m02 + m20) / (4 * qw[..., 3]),
                      (m12 + m21) / (4 * qw[..., 3]),
                      qw[..., 3]], dim=-1)

    pivots = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # [...,4cand,4]
    gather_idx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, gather_idx)[..., 0, :]
    q = q * _sign_nonneg(q[..., :1])
    return quat_normalize(q)


def _sign_nonneg(w: Tensor) -> Tensor:
    """-1 where w < 0, +1 elsewhere (so that w = 0 keeps its sign)."""
    return torch.where(w < 0, -torch.ones_like(w), torch.ones_like(w))


# ----------------------------------------------------------------------------
# so(3) maps and the reference Utility helpers
# ----------------------------------------------------------------------------


def skew(v: Tensor) -> Tensor:
    """Skew-symmetric matrix [...,3,3] of v [...,3]."""
    z = torch.zeros_like(v[..., 0])
    m = torch.stack(
        [z, -v[..., 2], v[..., 1],
         v[..., 2], z, -v[..., 0],
         -v[..., 1], v[..., 0], z],
        dim=-1,
    )
    return m.reshape(v.shape[:-1] + (3, 3))


def delta_q(theta: Tensor) -> Tensor:
    """Small-angle rotation vector [...,3] → quaternion [...,4]:
    q = [1, θ/2], normalized (the reference's Utility::deltaQ)."""
    half = 0.5 * theta
    w = torch.ones_like(half[..., :1])
    return quat_normalize(torch.cat([w, half], dim=-1))


def exp_so3_quat(theta: Tensor) -> Tensor:
    """Exact SO(3) exponential as a quaternion (for larger angles)."""
    angle = torch.linalg.norm(theta, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-7
    k = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / torch.clamp(angle, min=1e-20))
    w = torch.cos(half)
    return torch.cat([w, k * theta], dim=-1)


def log_so3(q: Tensor) -> Tensor:
    """Unit quaternion [...,4] → rotation vector [...,3] (inverse of exp)."""
    q = q * _sign_nonneg(q[..., :1])
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    k = torch.where(vn < 1e-7, 2.0 / torch.clamp(w, min=1e-7),
                    angle / torch.clamp(vn, min=1e-20))
    return k * q[..., 1:]


def rot_to_ypr(R: Tensor) -> Tensor:
    """Rotation matrix → yaw/pitch/roll in degrees (Utility::R2ypr)."""
    n, o, a = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    yaw = torch.atan2(n[..., 1], n[..., 0])
    pitch = torch.atan2(-n[..., 2],
                        n[..., 0] * torch.cos(yaw) + n[..., 1] * torch.sin(yaw))
    roll = torch.atan2(
        a[..., 0] * torch.sin(yaw) - a[..., 1] * torch.cos(yaw),
        -o[..., 0] * torch.sin(yaw) + o[..., 1] * torch.cos(yaw),
    )
    return torch.stack([yaw, pitch, roll], dim=-1) / math.pi * 180.0


def ypr_to_rot(ypr_deg: Tensor) -> Tensor:
    """Yaw/pitch/roll (degrees) → rotation matrix Rz(y)Ry(p)Rx(r)."""
    y, p, r = (ypr_deg / 180.0 * math.pi).unbind(-1)
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    one = torch.ones_like(y)
    zero = torch.zeros_like(y)
    Rz = torch.stack([cy, -sy, zero, sy, cy, zero, zero, zero, one],
                     dim=-1).reshape(y.shape + (3, 3))
    Ry = torch.stack([cp, zero, sp, zero, one, zero, -sp, zero, cp],
                     dim=-1).reshape(y.shape + (3, 3))
    Rx = torch.stack([one, zero, zero, zero, cr, -sr, zero, sr, cr],
                     dim=-1).reshape(y.shape + (3, 3))
    return Rz @ Ry @ Rx


def gravity_to_rot(g: Tensor) -> Tensor:
    """Rotation R0 aligning measured gravity g to +z with zero yaw
    (Utility::g2R): rotate ĝ onto e_z, then remove the induced yaw."""
    ng1 = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    axis = _cross(ng1, ng2.expand_as(ng1))
    s = torch.linalg.norm(axis, dim=-1, keepdim=True)
    c = torch.sum(ng1 * ng2, dim=-1, keepdim=True)
    angle = torch.atan2(s, c)
    axis = axis / torch.clamp(s, min=1e-12)
    R0 = quat_to_rot(exp_so3_quat(axis * angle))
    yaw = rot_to_ypr(R0)[..., 0]
    fix = ypr_to_rot(torch.stack([-yaw, torch.zeros_like(yaw),
                                  torch.zeros_like(yaw)], dim=-1))
    return fix @ R0


# ----------------------------------------------------------------------------
# Pose boxplus (manifold retraction)
# ----------------------------------------------------------------------------


def pose_boxplus(p: Tensor, q: Tensor, dx: Tensor):
    """SE(3)-style retraction: p += δp; q ← q ⊗ deltaQ(δθ). Translation is
    additive, rotation a *right* quaternion perturbation; dx is [...,6]."""
    return p + dx[..., :3], quat_normalize(quat_mul(q, delta_q(dx[..., 3:6])))


# ----------------------------------------------------------------------------
# Linear algebra helpers
# ----------------------------------------------------------------------------


def cholesky_or_nan(A: Tensor) -> Tensor:
    """Lower Cholesky factor of [...,n,n]. Where a matrix is not positive
    definite its factor is NaN (no exception), as `jnp.linalg.cholesky`
    returns."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def eigh_or_nan(A: Tensor):
    """`torch.linalg.eigh` of symmetric [...,n,n] that does not raise:
    where the solver does not converge on a matrix (cuSOLVER's batched
    Jacobi solver can fail on an ill-conditioned small matrix), that matrix
    is taken again alone, and its eigenvalues and eigenvectors are NaN if it
    fails again, as `jnp.linalg.eigh` returns where LAPACK fails."""
    try:
        return torch.linalg.eigh(A)
    except torch.linalg.LinAlgError:
        pass
    flat = A.reshape((-1,) + A.shape[-2:])
    w = torch.full(flat.shape[:-1], float("nan"), dtype=A.dtype,
                   device=A.device)
    V = torch.full_like(flat, float("nan"))
    for i in range(flat.shape[0]):
        try:
            w[i], V[i] = torch.linalg.eigh(flat[i])
        except torch.linalg.LinAlgError:
            pass
    return torch.return_types.linalg_eigh(
        (w.reshape(A.shape[:-1]), V.reshape(A.shape)))


def logdet_psd(M: Tensor) -> Tensor:
    """log-determinant of an SPD matrix [...,n,n] via Cholesky:
    2·Σ log diag(L). A matrix that is not positive definite gives NaN
    (no exception), as the JAX counterpart does."""
    L, info = torch.linalg.cholesky_ex(M)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ld = 2.0 * torch.sum(torch.log(d), dim=-1)
    return torch.where(info > 0, torch.full_like(ld, float("nan")), ld)
