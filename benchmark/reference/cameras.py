"""The EuRoC cam0 model for the tracker's reference: a copy of the port's
pinhole camera with radial-tangential distortion
(`ops/cameras.{PinholeCamera, pinhole_space_to_plane,
pinhole_lift_projective}`), in any floating dtype.

Where the copy departs from the port: only the pinhole model is copied (the
EuRoC rig has no other), and `space_to_plane` / `lift_projective` take it
alone, without the port's dispatch over camera models.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

UNDISTORT_ITERS = 20  # fixed-point iterations for lift_projective


class PinholeCamera(NamedTuple):
    """fx fy cx cy + radial-tangential distortion (k1 k2 p1 p2), each a 0-d
    tensor."""
    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor
    k1: Tensor
    k2: Tensor
    p1: Tensor
    p2: Tensor
    width: int = 752
    height: int = 480

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, width=752,
               height=480, dtype=torch.float64,
               device="cpu") -> "PinholeCamera":
        vals = [torch.as_tensor(v, dtype=dtype, device=device)
                for v in (fx, fy, cx, cy, k1, k2, p1, p2)]
        return PinholeCamera(*vals, width, height)


def _radtan_distort(cam: PinholeCamera, xy: Tensor) -> Tensor:
    """Radial-tangential distortion of normalized coords [...,2]."""
    x, y = xy[..., 0], xy[..., 1]
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2.0 * x * y
    rad = cam.k1 * r2 + cam.k2 * r2 * r2
    dx = x * rad + cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x2)
    dy = y * rad + cam.p1 * (r2 + 2.0 * y2) + cam.p2 * xy2
    return xy + torch.stack([dx, dy], dim=-1)


def _safe_z(z: Tensor) -> Tensor:
    return torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def space_to_plane(cam: PinholeCamera, P: Tensor) -> Tensor:
    """3-D point in the camera frame [...,3] → pixel [...,2]."""
    xy = P[..., :2] / _safe_z(P[..., 2:3])
    d = _radtan_distort(cam, xy)
    return torch.stack([cam.fx * d[..., 0] + cam.cx,
                        cam.fy * d[..., 1] + cam.cy], dim=-1)


def lift_projective(cam: PinholeCamera, uv: Tensor) -> Tensor:
    """Pixel [...,2] → unit-depth ray [...,3]: a fixed UNDISTORT_ITERS-step
    contraction x_{n+1} = x_d − d(x_n)."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    xd = torch.stack([mx, my], dim=-1)
    x = xd
    for _ in range(UNDISTORT_ITERS):
        x = xd - (_radtan_distort(cam, x) - x)
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
