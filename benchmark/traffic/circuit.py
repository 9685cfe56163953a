"""The tracker cells' camera stream: frames of a textured box world seen
from a camera that circles inside it, looking outward.

Copies of the port's `utils/synthetic.loop_trajectory` (its poses: the
radius wobbling at 3θ, the height bobbing at 2θ, the lap rate modulated in
time, the camera's yaw following the circle's tangent) and of
`utils/render` (the box `margin` metres beyond the circuit, its walls
textured with five octaves of hashed 3-D value noise, posterised; each
pixel's ray cast to the wall it leaves the box through), so that a change
to the port cannot move the inputs. The renderer runs over a batch of
frames at once; its arithmetic is the port's, in float32, on the device
given. `backproject` and `project` give the truth a tracked pixel is read
against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from benchmark.reference import cameras

_LATTICE_N = 1 << 16
# the camera (+z of the body) looking radially outward, body y down
_R0 = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


class Circuit(NamedTuple):
    t: np.ndarray         # [T] frame times
    p: np.ndarray         # [T,3] camera positions in the world
    R: np.ndarray         # [T,3,3] camera-to-world rotations


class BoxWorld(NamedTuple):
    lo: Tensor            # [3]
    hi: Tensor            # [3]
    lattice: Tensor       # [65536] values in [0, 1)
    octaves: Tensor       # [5] cycles per metre
    weights: Tensor       # [5]


def _loop(t, duration, laps, radius, bob=0.25, wobble=0.12, rate_mod=0.4,
          rate_mod_freq=2.0):
    """Positions [n,3] and camera-to-world rotations [n,3,3] of
    `loop_trajectory` at times `t`."""
    th_rate = 2.0 * np.pi * laps / duration
    wm = rate_mod_freq
    th = th_rate * (t + (rate_mod / wm) * np.sin(wm * t))
    r = radius + wobble * radius * np.sin(3 * th)
    p = np.stack([r * np.cos(th), r * np.sin(th), bob * np.sin(2 * th)], -1)
    c, s, z, o = np.cos(th), np.sin(th), np.zeros_like(th), np.ones_like(th)
    Rz = np.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(-1, 3, 3)
    return p, Rz @ _R0


def circuit(duration_s: float, laps: float, radius_m: float,
            frame_hz: float, imu_hz: float = 200.0):
    """(the frames' poses, every position at the IMU rate)."""
    n = int(round(duration_s * imu_hz)) + 1
    t_all = np.arange(n) / imu_hz
    p_all, _ = _loop(t_all, duration_s, laps, radius_m)
    stride = int(round(imu_hz / frame_hz))
    t = t_all[:(n - 1) // stride * stride:stride]
    p, R = _loop(t, duration_s, laps, radius_m)
    return Circuit(t, p, R), p_all


def make_box_world(traj_p: np.ndarray, seed: int, margin: float = 4.0,
                   device="cpu") -> BoxWorld:
    """The port's `make_box_world`: walls `margin` metres beyond the
    trajectory's bounding box, the lattice drawn from `seed`."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return BoxWorld(
        lo=f32(traj_p.min(0) - margin), hi=f32(traj_p.max(0) + margin),
        lattice=f32(rng.random(_LATTICE_N)),
        octaves=f32([0.45, 0.9, 1.8, 3.6, 7.2]),
        weights=f32([0.42, 0.27, 0.17, 0.09, 0.05]))


def _hash3(ix, iy, iz):
    h = (ix * 73856093) ^ (iy * 19349663) ^ (iz * 83492791)
    return h & (_LATTICE_N - 1)


def _value_noise(lattice: Tensor, X: Tensor) -> Tensor:
    Xf = torch.floor(X)
    f = X - Xf
    f = f * f * (3.0 - 2.0 * f)
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
    v = torch.zeros(X.shape[:-1], dtype=torch.float32, device=X.device)
    for k in range(world.octaves.shape[0]):
        v = v + world.weights[k] * _value_noise(world.lattice,
                                                X * world.octaves[k])
    vq = torch.floor(v * 7.0) / 7.0
    return torch.clamp(0.15 + 0.8 * (0.35 * v + 0.65 * vq * 1.18), 0.0, 1.0)


def camera_rays(cam) -> Tensor:
    """Unit rays [H·W,3] of every pixel (x, y at integer coordinates), in
    float32 on the camera's device."""
    H, W = cam.height, cam.width
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    uv = torch.tensor(np.stack([xx, yy], -1).reshape(-1, 2),
                      dtype=torch.float32, device=cam.fx.device)
    rays = cameras.lift_projective(cam, uv)
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


def render(world: BoxWorld, rays_c: Tensor, p: np.ndarray,
           R: np.ndarray) -> Tensor:
    """Frames [B,H·W] in [0, 1] for the poses p [B,3], R [B,3,3]."""
    dev = world.lo.device
    p = torch.tensor(np.asarray(p, np.float32), device=dev)
    R = torch.tensor(np.asarray(R, np.float32), device=dev)
    d = torch.einsum("nj,bij->bni", rays_c, R)
    d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    pw = p[:, None, :]
    t_axis = torch.where(d > 0, (world.hi - pw) / d, (world.lo - pw) / d)
    t_hit = torch.min(t_axis, dim=-1).values
    X = pw + t_hit[..., None] * d
    shade = 1.0 - 0.06 * torch.argmin(t_axis, dim=-1).to(torch.float32)
    return torch.clamp(_texture(world, X) * shade, 0.0, 1.0)


def frames_uint8(world: BoxWorld, cam, circ: Circuit, batch: int = 16,
                 pin: bool = False) -> Tensor:
    """Every frame of the circuit rendered on the world's device, rounded to
    8 bits, in one host tensor [T,H,W] (page-locked where `pin`)."""
    rays = camera_rays(cam)
    T = len(circ.t)
    out = torch.empty((T, cam.height, cam.width), dtype=torch.uint8,
                      pin_memory=pin)
    for lo in range(0, T, batch):
        hi = min(lo + batch, T)
        v = render(world, rays, circ.p[lo:hi], circ.R[lo:hi])
        q = torch.round(v * 255.0).to(torch.uint8)
        out[lo:hi] = q.reshape(hi - lo, cam.height, cam.width).cpu()
    return out


def backproject(world: BoxWorld, cam, uv: Tensor, p: np.ndarray,
                R: np.ndarray) -> np.ndarray:
    """The wall points [N,3] that pixels uv [N,2] see from the pose (p, R),
    in float64."""
    rays = cameras.lift_projective(cam, uv.to(cam.fx.dtype)).cpu().numpy()
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    d = rays @ np.asarray(R).T
    d = np.where(np.abs(d) < 1e-9, 1e-9, d)
    lo = world.lo.cpu().numpy().astype(np.float64)
    hi = world.hi.cpu().numpy().astype(np.float64)
    t_axis = np.where(d > 0, (hi[None] - p[None]) / d,
                      (lo[None] - p[None]) / d)
    return p[None] + t_axis.min(-1)[:, None] * d


def project(cam, X: np.ndarray, p: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Pixels [N,2] of the world points X [N,3] from the pose (p, R)."""
    Pc = (np.asarray(X) - p[None]) @ np.asarray(R)
    uv = cameras.space_to_plane(cam, torch.tensor(Pc, dtype=cam.fx.dtype,
                                                  device=cam.fx.device))
    return uv.cpu().numpy()
