"""Textured-world renderer: full-resolution imagery along a trajectory.

Counterpart of `anticipated_vins_mono_tpu/utils/render.py`. The reference's
full-fidelity evaluation path — camera images → CLAHE → LK tracking →
selection → estimation (feature_tracker.cpp:27-138) — needs pixels, and no
camera data ships with the repository. This module renders a deterministic,
richly textured axis-aligned box world around a trajectory and ray-casts
752×480 views through the real EuRoC camera model (radtan distortion
included, inverted per pixel once via `lift_projective`), on the device
that holds the world: per-pixel ray → AABB exit intersection → multi-octave
3-D value noise (hashed lattice gathers + trilinear blends).

Where the two differ: `render_frame` returns a tensor on the world's device
(the JAX function returns numpy), so that frames go to the tracker without a
trip through the host. The lattice hash stays in int32 and wraps exactly as
the JAX one does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from anticipated_vins_mono_torch.ops import cameras

_LATTICE_BITS = 16
_LATTICE_N = 1 << _LATTICE_BITS


class BoxWorld(NamedTuple):
    lo: Tensor        # [3] box min corner
    hi: Tensor        # [3] box max corner
    lattice: Tensor   # [_LATTICE_N] random values in [0,1)
    octaves: Tensor   # [K] spatial frequencies (cycles / meter)
    weights: Tensor   # [K] octave amplitudes


def make_box_world(traj_p: np.ndarray, margin: float = 4.0, seed: int = 0,
                   device="cuda") -> BoxWorld:
    """Box walls `margin` meters beyond the trajectory's bounding box (the
    JAX package's numpy draws, in its order)."""
    rng = np.random.default_rng(seed)
    lo = traj_p.min(0) - margin
    hi = traj_p.max(0) + margin
    octaves = np.array([0.45, 0.9, 1.8, 3.6, 7.2], np.float32)
    weights = np.array([0.42, 0.27, 0.17, 0.09, 0.05], np.float32)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return BoxWorld(lo=f32(lo), hi=f32(hi),
                    lattice=f32(rng.random(_LATTICE_N)),
                    octaves=f32(octaves), weights=f32(weights))


def _hash3(ix: Tensor, iy: Tensor, iz: Tensor) -> Tensor:
    """Integer lattice hash → index into the value table (int32 products
    that wrap, as in the JAX package)."""
    h = (ix * 73856093) ^ (iy * 19349663) ^ (iz * 83492791)
    return h & (_LATTICE_N - 1)


def _value_noise(lattice: Tensor, X: Tensor) -> Tensor:
    """Trilinear 3-D value noise at points X [...,3] (unit lattice)."""
    Xf = torch.floor(X)
    f = X - Xf
    f = f * f * (3.0 - 2.0 * f)          # smoothstep fade
    I = Xf.to(torch.int32)

    def corner(dx, dy, dz):
        idx = _hash3(I[..., 0] + dx, I[..., 1] + dy, I[..., 2] + dz)
        return lattice[idx.long()]

    wx, wy, wz = f[..., 0], f[..., 1], f[..., 2]
    c00 = corner(0, 0, 0) * (1 - wx) + corner(1, 0, 0) * wx
    c10 = corner(0, 1, 0) * (1 - wx) + corner(1, 1, 0) * wx
    c01 = corner(0, 0, 1) * (1 - wx) + corner(1, 0, 1) * wx
    c11 = corner(0, 1, 1) * (1 - wx) + corner(1, 1, 1) * wx
    c0 = c00 * (1 - wy) + c10 * wy
    c1 = c01 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def _texture(world: BoxWorld, X: Tensor) -> Tensor:
    """Multi-octave noise + quantization → corner-rich wall texture."""
    v = torch.zeros(X.shape[:-1], dtype=torch.float32, device=X.device)
    for k in range(world.octaves.shape[0]):
        v = v + world.weights[k] * _value_noise(world.lattice,
                                                X * world.octaves[k])
    # mild posterization sharpens blobs into trackable corner structure
    steps = 7.0
    vq = torch.floor(v * steps) / steps
    return torch.clamp(0.15 + 0.8 * (0.35 * v + 0.65 * vq * 1.18), 0.0, 1.0)


def camera_rays(cam) -> Tensor:
    """Per-pixel unit ray directions [H*W, 3] in the camera frame, on the
    camera's device (inverts the distortion once; reused across frames)."""
    H, W = cam.height, cam.width
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    uv = torch.tensor(np.stack([xx, yy], -1).reshape(-1, 2),
                      dtype=torch.float32, device=cam.fx.device)
    rays = cameras.lift_projective(cam, uv)
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


def render_rays(world: BoxWorld, rays_c: Tensor, p_wc: Tensor,
                R_wc: Tensor) -> Tensor:
    """Ray-cast one frame: camera at (p_wc, R_wc), rays [N,3] → values [N].

    The camera is inside the AABB, so each ray hits the exit face: per axis
    the positive boundary distance, then the minimum across axes.
    """
    d = rays_c @ R_wc.T                                   # [N,3] world dirs
    d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t_axis = torch.where(d > 0, (world.hi[None, :] - p_wc[None, :]) / d,
                         (world.lo[None, :] - p_wc[None, :]) / d)  # [N,3]
    t_hit = torch.min(t_axis, dim=-1).values
    X = p_wc[None, :] + t_hit[:, None] * d
    # slight per-face shading so edges between faces are visible
    face = torch.argmin(t_axis, dim=-1)
    shade = 1.0 - 0.06 * face.to(torch.float32)
    return torch.clamp(_texture(world, X) * shade, 0.0, 1.0)


def render_frame(world: BoxWorld, cam, rays_c: Tensor, p_wc, R_wc) -> Tensor:
    """[H,W] float32 image for one camera pose, on the world's device."""
    dev = world.lo.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    vals = render_rays(world, rays_c, f32(p_wc), f32(R_wc))
    return vals.reshape(cam.height, cam.width)


def backproject(world: BoxWorld, cam, uv: np.ndarray, p_wc: np.ndarray,
                R_wc: np.ndarray) -> np.ndarray:
    """Pixel coords [N,2] → 3-D hit points on the box walls (the renderer's
    exact ray-AABB geometry) for the camera at (p_wc, R_wc): a detected
    texture corner backprojected here is a revisit-consistent wall point.
    The rays come from the camera in float32, the geometry in float64 numpy,
    as in the JAX package."""
    rays = cameras.lift_projective(cam, torch.tensor(
        np.asarray(uv, np.float32), device=cam.fx.device)).cpu().numpy()
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    d = rays @ np.asarray(R_wc).T
    d = np.where(np.abs(d) < 1e-9, 1e-9, d)
    lo, hi = world.lo.cpu().numpy(), world.hi.cpu().numpy()
    t_axis = np.where(d > 0, (hi[None] - p_wc[None]) / d,
                      (lo[None] - p_wc[None]) / d)
    t_hit = t_axis.min(-1)
    return p_wc[None] + t_hit[:, None] * d
