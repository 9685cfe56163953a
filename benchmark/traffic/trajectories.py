"""Ground-truth trajectories sampled at the IMU rate.

A copy of the port's `utils/synthetic.{analytic_trajectory,
stopped_trajectory, sample_landmarks, add_imu_noise}` in numpy float64. The
analytic trajectory's orientation integrates the same body rate with the
same four exact-exponential substeps per IMU sample; the product of the
substep rotations is taken as a prefix product (log-step scan) instead of a
sample-by-sample loop, which gives the same orientations to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

GRAVITY = 9.81007
G_W = np.array([0.0, 0.0, -GRAVITY])   # world gravity acceleration


class Trajectory(NamedTuple):
    t: np.ndarray         # [N]
    p: np.ndarray         # [N,3]
    q: np.ndarray         # [N,4] wxyz
    v: np.ndarray         # [N,3]
    acc_body: np.ndarray  # [N,3] accelerometer (specific force)
    gyr_body: np.ndarray  # [N,3] gyro


def quat_mul(q, p):
    qw, qx, qy, qz = np.moveaxis(q, -1, 0)
    pw, px, py, pz = np.moveaxis(p, -1, 0)
    return np.stack([qw * pw - qx * px - qy * py - qz * pz,
                     qw * px + qx * pw + qy * pz - qz * py,
                     qw * py - qx * pz + qy * pw + qz * px,
                     qw * pz + qx * py - qy * px + qz * pw], axis=-1)


def exp_so3_quat(theta):
    angle = np.linalg.norm(theta, axis=-1, keepdims=True)
    k = np.where(angle < 1e-7, 0.5 - angle * angle / 48.0,
                 np.sin(0.5 * angle) / np.maximum(angle, 1e-20))
    return np.concatenate([np.cos(0.5 * angle), k * theta], axis=-1)


def quat_to_rot(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _prefix_products(dq):
    """out[k] = dq[0] ⊗ … ⊗ dq[k] for dq [S,4], by a log-step scan."""
    out = dq.copy()
    shift = 1
    while shift < len(out):
        left = np.concatenate(
            [np.tile([1.0, 0.0, 0.0, 0.0], (shift, 1)), out[:-shift]])
        out = quat_mul(left, out)
        shift *= 2
    return out


def analytic_trajectory(duration: float, imu_rate: float = 200.0,
                        scale: float = 1.0) -> Trajectory:
    """Smooth sinusoidal trajectory with analytic p, v, a (amplitudes 1.2,
    0.8, 0.4 m × `scale`) and an analytic body rate ω(t)."""
    dt = 1.0 / imu_rate
    n = int(round(duration * imu_rate)) + 1
    t = np.arange(n) * dt
    w1, w2, w3 = 0.7, 0.5, 0.9
    A = np.array([1.2, 0.8, 0.4]) * scale
    p = np.stack([A[0] * np.sin(w1 * t), A[1] * np.cos(w2 * t),
                  A[2] * np.sin(w3 * t)], axis=-1)
    v = np.stack([A[0] * w1 * np.cos(w1 * t), -A[1] * w2 * np.sin(w2 * t),
                  A[2] * w3 * np.cos(w3 * t)], axis=-1)
    a = np.stack([-A[0] * w1 * w1 * np.sin(w1 * t),
                  -A[1] * w2 * w2 * np.cos(w2 * t),
                  -A[2] * w3 * w3 * np.sin(w3 * t)], axis=-1)

    def omega(tt):
        return np.stack([0.25 * np.sin(0.9 * tt), 0.2 * np.cos(0.7 * tt),
                         0.3 * np.sin(0.5 * tt) + 0.1], axis=-1)

    sub = 4   # exact-exponential substeps per IMU sample
    tm = t[:-1, None] + (np.arange(sub)[None, :] + 0.5) * dt / sub
    dq = exp_so3_quat(omega(tm.reshape(-1)) * dt / sub)
    prod = _prefix_products(dq)[sub - 1::sub]
    prod = prod / np.linalg.norm(prod, axis=-1, keepdims=True)
    q = np.concatenate([[[1.0, 0.0, 0.0, 0.0]], prod])
    gyr = omega(t)
    R = quat_to_rot(q)
    acc_body = np.einsum("nij,nj->ni", R.transpose(0, 2, 1), a - G_W)
    return Trajectory(t, p, q, v, acc_body, gyr)


def stopped_trajectory(duration: float, stop_after: float,
                       imu_rate: float = 200.0) -> Trajectory:
    """The analytic trajectory stopped dead after `stop_after` seconds: pose
    held, zero velocity and rate, the accelerometer reading gravity alone."""
    tr = analytic_trajectory(duration, imu_rate)
    k = int(stop_after * imu_rate)
    p, q, v = tr.p.copy(), tr.q.copy(), tr.v.copy()
    acc, gyr = tr.acc_body.copy(), tr.gyr_body.copy()
    p[k:], q[k:], v[k:] = p[k], q[k], 0.0
    acc[k:] = quat_to_rot(q[k]).T @ -G_W
    gyr[k:] = 0.0
    return Trajectory(tr.t, p, q, v, acc, gyr)


def trajectory(spec: dict) -> Trajectory:
    """The trajectory a traffic file names: {"kind": "analytic", "duration_s",
    "scale"} or {"kind": "stopped", "duration_s", "stop_after_s"}."""
    kind = spec["kind"]
    if kind == "analytic":
        return analytic_trajectory(spec["duration_s"],
                                   scale=spec.get("scale", 1.0))
    if kind == "stopped":
        return stopped_trajectory(spec["duration_s"], spec["stop_after_s"])
    raise ValueError(f"unknown trajectory kind {kind!r}")


def sample_landmarks(traj: Trajectory, n: int, rng: np.random.Generator,
                     depth_range=(3.0, 12.0)) -> np.ndarray:
    """World landmarks scattered in front of the trajectory's viewing cone."""
    idx = rng.integers(0, len(traj.t), size=n)
    R = quat_to_rot(traj.q[idx])
    depth = rng.uniform(*depth_range, size=n)
    dirs = np.stack([rng.uniform(-0.45, 0.45, n),
                     rng.uniform(-0.35, 0.35, n), np.ones(n)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return traj.p[idx] + np.einsum("nij,nj->ni", R, dirs * depth[:, None])
