"""Batched multi-view triangulation (inverse depth in the anchor camera).

Counterpart of `anticipated_vins_mono_tpu/ops/triangulation.py`: per
landmark, stack the DLT rows of every (masked) observation relative to the
anchor camera and take the smallest-singular-vector solution; depths < 0.1 m
reset to the 5 m default.

Where the JAX version maps a one-landmark function over the slots with
`vmap`, the landmark axis is written out here: one `[F, 2·NF, 4]` DLT stack,
one batched `eigh` of `[F, 4, 4]`. Rows of invalid observations are zeroed,
so the shapes are static. The depth X[2]/X[3] does not depend on the sign of
the eigenvector, so LAPACK's / cuSOLVER's sign convention does not matter.
"""

from __future__ import annotations

import torch

from benchmark.reference import lie
from benchmark.reference.window import WindowConfig, WindowState

Tensor = torch.Tensor


def _cam_poses(state: WindowState):
    """World→camera (R, t) per frame: T_cw = (T_wb · T_bc)⁻¹."""
    R_wb = lie.quat_to_rot(state.q)                # [NF,3,3]
    R_bc = lie.quat_to_rot(state.qic)              # [3,3]
    R_wc = R_wb @ R_bc
    t_wc = state.p + (R_wb @ state.tic[:, None])[..., 0]
    R_cw = R_wc.mT
    t_cw = -(R_cw @ t_wc[..., None])[..., 0]
    return R_cw, t_cw


def triangulate(state: WindowState, pts: Tensor, mask: Tensor,
                anchor: Tensor, cfg: WindowConfig):
    """Triangulate every landmark slot of one scenario.

    Args: pts [F,NF,3] normalized-plane obs; mask [F,NF]; anchor [F].
    Returns (inv_depth [F], good [F]): good=0 where depth implausible.
    """
    with torch.no_grad():
        R_cw, t_cw = _cam_poses(state)
        a = anchor.long()
        # poses relative to the anchor camera: P_rel = T_j←w · T_w←a
        R_a = R_cw[a].mT                                  # cam_a → world
        t_a = -(R_a @ t_cw[a][..., None])[..., 0]         # cam_a origin in world
        R_rel = R_cw[None] @ R_a[:, None]                 # [F,NF,3,3]
        t_rel = torch.einsum("nij,fj->fni", R_cw, t_a) + t_cw[None]

        # DLT rows: x·P[2] − P[0], y·P[2] − P[1] with P = [R_rel | t_rel]
        P = torch.cat([R_rel, t_rel[..., None]], dim=-1)  # [F,NF,3,4]
        r0 = pts[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = pts[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        A = torch.cat([r0, r1], dim=1) * \
            torch.cat([mask, mask], dim=1)[..., None]     # [F,2NF,4]
        # smallest right singular vector via eigh of AᵀA (4x4)
        _, V = lie.eigh_or_nan(A.mT @ A)
        X = V[..., :, 0]
        x3 = X[..., 3]
        depth = X[..., 2] / torch.where(x3.abs() < 1e-12,
                                        torch.full_like(x3, 1e-12), x3)
        # parallax gate: with ~zero baseline the DLT depth is noise-determined
        # yet positive; require the subtended parallax baseline/depth to
        # exceed cfg.tri_min_parallax
        base = torch.max(torch.linalg.norm(t_rel, dim=-1) * mask, dim=-1).values
        good = ((depth > 0.1) & (mask.sum(-1) >= 2)
                & (base > cfg.tri_min_parallax * depth))
        depth = torch.where(good, depth, torch.full_like(depth, 5.0))
        return 1.0 / depth, good.to(pts.dtype)
