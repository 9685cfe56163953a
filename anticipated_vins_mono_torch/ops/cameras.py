"""Camera-model library — projection / unprojection.

Counterpart of `anticipated_vins_mono_tpu/ops/cameras.py`, function for
function. Capability parity with the reference `camodocal` package: the
abstract interface is `space_to_plane` (3-D ray → pixel) and
`lift_projective` (pixel → normalized ray). Models are NamedTuples whose
parameters are 0-d tensors (the Scaramuzza polynomials 1-d), so every
function broadcasts over any leading shape of points. Undistortion is the
same fixed-iteration contraction as in the JAX package (no data-dependent
loop).

Only PINHOLE is exercised by the EuRoC path in the reference;
KANNALA_BRANDT (`EquidistantCamera`), MEI and Scaramuzza are provided for
model parity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

UNDISTORT_ITERS = 20  # fixed-point iterations for lift_projective


def _scalars(dtype, device, *vals):
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in vals]


class PinholeCamera(NamedTuple):
    """fx fy cx cy + radial-tangential distortion (k1 k2 p1 p2).

    Reference: camera_model/src/camera_models/PinholeCamera.cc.
    """

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
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
               width=752, height=480, dtype=torch.float32,
               device="cuda") -> "PinholeCamera":
        return PinholeCamera(*_scalars(dtype, device, fx, fy, cx, cy,
                                       k1, k2, p1, p2), width, height)


def _radtan_distort(cam: PinholeCamera, xy: Tensor) -> Tensor:
    """Apply radial-tangential distortion to normalized coords [...,2]."""
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


def pinhole_space_to_plane(cam: PinholeCamera, P: Tensor) -> Tensor:
    """3-D point in camera frame [...,3] → pixel [...,2].

    Points behind the camera are still projected (the caller masks on z > 0).
    """
    xy = P[..., :2] / _safe_z(P[..., 2:3])
    d = _radtan_distort(cam, xy)
    u = cam.fx * d[..., 0] + cam.cx
    v = cam.fy * d[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def pinhole_lift_projective(cam: PinholeCamera, uv: Tensor) -> Tensor:
    """Pixel [...,2] → unit-depth ray [...,3] (normalized image plane, z=1):
    a fixed UNDISTORT_ITERS-step contraction x_{n+1} = x_d - d(x_n)."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    xd = torch.stack([mx, my], dim=-1)
    x = xd
    for _ in range(UNDISTORT_ITERS):
        x = xd - (_radtan_distort(cam, x) - x)
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt fisheye: r(θ) = θ + k2 θ³ + k3 θ⁵ + k4 θ⁷ + k5 θ⁹.

    Reference: camera_model/src/camera_models/EquidistantCamera.cc.
    """

    mu: Tensor
    mv: Tensor
    u0: Tensor
    v0: Tensor
    k2: Tensor
    k3: Tensor
    k4: Tensor
    k5: Tensor
    width: int = 752
    height: int = 480

    @staticmethod
    def create(mu, mv, u0, v0, k2=0.0, k3=0.0, k4=0.0, k5=0.0,
               width=752, height=480, dtype=torch.float32,
               device="cuda") -> "EquidistantCamera":
        return EquidistantCamera(*_scalars(dtype, device, mu, mv, u0, v0,
                                           k2, k3, k4, k5), width, height)


def _kb_r(cam: EquidistantCamera, theta: Tensor) -> Tensor:
    t2 = theta * theta
    return theta * (1.0 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * (
        cam.k4 + t2 * cam.k5))))


def equidistant_space_to_plane(cam: EquidistantCamera, P: Tensor) -> Tensor:
    rxy = torch.linalg.norm(P[..., :2], dim=-1)
    theta = torch.atan2(rxy, P[..., 2])
    phi = torch.atan2(P[..., 1], P[..., 0])
    r = _kb_r(cam, theta)
    u = cam.mu * r * torch.cos(phi) + cam.u0
    v = cam.mv * r * torch.sin(phi) + cam.v0
    return torch.stack([u, v], dim=-1)


def equidistant_lift_projective(cam: EquidistantCamera, uv: Tensor) -> Tensor:
    """Pixel → ray; inverts r(θ) with fixed Newton iterations."""
    px = (uv[..., 0] - cam.u0) / cam.mu
    py = (uv[..., 1] - cam.v0) / cam.mv
    r = torch.sqrt(px * px + py * py)
    phi = torch.atan2(py, px)
    theta = r
    for _ in range(UNDISTORT_ITERS):
        t2 = theta * theta
        f = _kb_r(cam, theta) - r
        df = 1.0 + t2 * (3 * cam.k2 + t2 * (5 * cam.k3 + t2 * (
            7 * cam.k4 + t2 * 9 * cam.k5)))
        theta = theta - f / torch.clamp(df, min=1e-9)
    st, ct = torch.sin(theta), torch.cos(theta)
    ray = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    return ray / _safe_z(ray[..., 2:3])  # normalized plane, z = 1


class MeiCamera(NamedTuple):
    """Unified omnidirectional (Mei): mirror ξ + radtan + pinhole.

    Reference: camera_model/src/camera_models/CataCamera.cc.
    """

    xi: Tensor
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
    def create(xi, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
               width=752, height=480, dtype=torch.float32,
               device="cuda") -> "MeiCamera":
        return MeiCamera(*_scalars(dtype, device, xi, fx, fy, cx, cy,
                                   k1, k2, p1, p2), width, height)


def _mei_pinhole(cam: MeiCamera) -> PinholeCamera:
    return PinholeCamera(cam.fx, cam.fy, cam.cx, cam.cy,
                         cam.k1, cam.k2, cam.p1, cam.p2)


def mei_space_to_plane(cam: MeiCamera, P: Tensor) -> Tensor:
    norm = torch.linalg.norm(P, dim=-1, keepdim=True)
    z = _safe_z(P[..., 2:3] + cam.xi * norm)
    d = _radtan_distort(_mei_pinhole(cam), P[..., :2] / z)
    u = cam.fx * d[..., 0] + cam.cx
    v = cam.fy * d[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def mei_lift_projective(cam: MeiCamera, uv: Tensor) -> Tensor:
    """Unified-model unprojection."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    xd = torch.stack([mx, my], dim=-1)
    pin = _mei_pinhole(cam)
    x = xd
    for _ in range(UNDISTORT_ITERS):
        x = xd - (_radtan_distort(pin, x) - x)
    r2 = torch.sum(x * x, dim=-1, keepdim=True)
    xi = cam.xi
    zs = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * r2)) / (1.0 + r2)
    ray = torch.cat([zs * x, zs - xi], dim=-1)
    return ray / _safe_z(ray[..., 2:3])


class ScaramuzzaCamera(NamedTuple):
    """Scaramuzza polynomial omnidirectional model: cam2world polynomial
    `poly` over the image radius, world2cam inverse polynomial `inv_poly`
    over the incidence angle, plus the affine (c,d,e) + center.

    Reference: camera_model/src/camera_models/ScaramuzzaCamera.cc.
    """

    poly: Tensor       # [Np] a0..a_{Np-1}, cam2world: z = Σ a_k ρ^k
    inv_poly: Tensor   # [Ni] world2cam: ρ(θ) = Σ b_k θ^k
    c: Tensor
    d: Tensor
    e: Tensor
    cx: Tensor
    cy: Tensor
    width: int = 752
    height: int = 480

    @staticmethod
    def create(poly, inv_poly, c=1.0, d=0.0, e=0.0, cx=376.0, cy=240.0,
               width=752, height=480, dtype=torch.float32,
               device="cuda") -> "ScaramuzzaCamera":
        return ScaramuzzaCamera(*_scalars(dtype, device, poly, inv_poly,
                                          c, d, e, cx, cy), width, height)


def _polyval(coeffs: Tensor, x: Tensor) -> Tensor:
    """Σ coeffs[k]·x^k (ascending order), Horner."""
    out = torch.zeros_like(x)
    for k in range(coeffs.shape[0] - 1, -1, -1):
        out = out * x + coeffs[k]
    return out


def scaramuzza_space_to_plane(cam: ScaramuzzaCamera, P: Tensor) -> Tensor:
    """Angle of incidence from the optical axis → image radius via the
    inverse polynomial → affine."""
    norm_xy = torch.linalg.norm(P[..., :2], dim=-1)
    # theta measured from the xy-plane toward -z (Scaramuzza convention)
    theta = torch.atan2(-P[..., 2], torch.clamp(norm_xy, min=1e-12))
    rho = _polyval(cam.inv_poly, theta)
    inv_n = 1.0 / torch.clamp(norm_xy, min=1e-12)
    xn = P[..., 0] * inv_n * rho
    yn = P[..., 1] * inv_n * rho
    u = xn * cam.c + yn * cam.d + cam.cx
    v = xn * cam.e + yn + cam.cy
    return torch.stack([u, v], dim=-1)


def scaramuzza_lift_projective(cam: ScaramuzzaCamera, uv: Tensor) -> Tensor:
    """Invert the affine, read z from the forward polynomial at the image
    radius."""
    inv_det = 1.0 / (cam.c - cam.d * cam.e)
    xp = inv_det * ((uv[..., 0] - cam.cx) - cam.d * (uv[..., 1] - cam.cy))
    yp = inv_det * (-cam.e * (uv[..., 0] - cam.cx)
                    + cam.c * (uv[..., 1] - cam.cy))
    rho = torch.sqrt(xp * xp + yp * yp)
    zp = _polyval(cam.poly, rho)
    ray = torch.stack([xp, yp, -zp], dim=-1)   # -z: mirror convention
    return ray / _safe_z(ray[..., 2:3])


def space_to_plane(cam, P: Tensor) -> Tensor:
    """Polymorphic dispatch on the camera type (the reference's virtual
    Camera::spaceToPlane)."""
    if isinstance(cam, PinholeCamera):
        return pinhole_space_to_plane(cam, P)
    if isinstance(cam, EquidistantCamera):
        return equidistant_space_to_plane(cam, P)
    if isinstance(cam, MeiCamera):
        return mei_space_to_plane(cam, P)
    if isinstance(cam, ScaramuzzaCamera):
        return scaramuzza_space_to_plane(cam, P)
    raise TypeError(f"unknown camera type {type(cam)}")


def lift_projective(cam, uv: Tensor) -> Tensor:
    """Polymorphic pixel → normalized ray (z=1)."""
    if isinstance(cam, PinholeCamera):
        return pinhole_lift_projective(cam, uv)
    if isinstance(cam, EquidistantCamera):
        return equidistant_lift_projective(cam, uv)
    if isinstance(cam, MeiCamera):
        return mei_lift_projective(cam, uv)
    if isinstance(cam, ScaramuzzaCamera):
        return scaramuzza_lift_projective(cam, uv)
    raise TypeError(f"unknown camera type {type(cam)}")


def euroc_camera(dtype=torch.float32, device="cuda") -> PinholeCamera:
    """The EuRoC cam0 intrinsics used by the reference
    (config/euroc/euroc_config.yaml:8-19)."""
    return PinholeCamera.create(
        fx=4.616e02, fy=4.603e02, cx=3.630e02, cy=2.481e02,
        k1=-2.917e-01, k2=8.228e-02, p1=5.333e-05, p2=-1.578e-04,
        width=752, height=480, dtype=dtype, device=device)
