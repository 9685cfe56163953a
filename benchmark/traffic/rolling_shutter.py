"""The simulated stream of a rolling-shutter camera whose clock is offset
from the IMU's.

`stream.SequenceSimulator` samples a frame's content at one instant. A
rolling-shutter sensor exposes its rows one after the other over the
readout time, and its clock runs `cam_td` ahead of the IMU's, so that the
observation of a landmark in row v of the frame stamped t is taken from the
pose at

    t + cam_td + readout · (v − ROW/2) / ROW

(the model of VINS-Mono's `ProjectionTdFactor`, with the rows centred as
`projection_td_factor.cpp` centres them). The row of an observation
depends on the pose it is taken from, so it is found by a fixed-point
iteration from the projection at the frame's mid-readout instant. The pose
between the trajectory's samples is interpolated: the position by the cubic
Hermite polynomial of the samples' positions and velocities, the rotation
by spherical interpolation; at a sample it is the sample itself.

Only the projection changes (`_visible`): which landmarks are tracked, the
random draws, the pixel noise and the velocities differenced from the noisy
points, as a tracker gives them, are `SequenceSimulator`'s. With `readout`
0 and `cam_td` 0 the frames are `SequenceSimulator`'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.traffic.stream import SequenceSimulator
from benchmark.traffic.trajectories import quat_to_rot

IMU_RATE = 200.0
# fixed-point steps of the row search: each shrinks a row's error by
# readout / ROW times its image speed in rows per second (~0.02 at 1 m/s),
# so a few reach rounding
ROW_STEPS = 8


def _slerp(q0, q1, s):
    """Spherical interpolation between unit quaternions [N,4] at s [N]."""
    dot = np.sum(q0 * q1, axis=-1)
    q1 = np.where(dot[:, None] < 0.0, -q1, q1)
    dot = np.abs(dot)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    sin = np.sin(theta)
    small = sin < 1e-12
    safe = np.where(small, 1.0, sin)
    w0 = np.where(small, 1.0 - s, np.sin((1.0 - s) * theta) / safe)
    w1 = np.where(small, s, np.sin(s * theta) / safe)
    q = w0[:, None] * q0 + w1[:, None] * q1
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@dataclass
class RollingShutterSimulator(SequenceSimulator):
    readout: float = 0.0        # seconds from the first row to the last
    rows: int = 480             # ROW
    fy: float = 460.0           # pixels per unit of normalized y
    cy: float = 240.0           # principal point's row

    def pose_at(self, k, off):
        """(p [N,3], R [N,3,3]) of the trajectory at time t[k] + off, for
        sample indices k [N] and offsets off [N] in seconds."""
        t = self.traj
        dt = 1.0 / IMU_RATE
        x = np.asarray(off, float) / dt
        n = np.floor(x)
        s = x - n
        base = np.clip(np.asarray(k) + n.astype(np.int64), 0, len(t.t) - 2)
        p0, p1 = t.p[base], t.p[base + 1]
        v0, v1 = t.v[base] * dt, t.v[base + 1] * dt
        s1 = s[:, None]
        h00 = 2 * s1 ** 3 - 3 * s1 ** 2 + 1
        h10 = s1 ** 3 - 2 * s1 ** 2 + s1
        h01 = -2 * s1 ** 3 + 3 * s1 ** 2
        h11 = s1 ** 3 - s1 ** 2
        p = h00 * p0 + h10 * v0 + h01 * p1 + h11 * v1
        q = _slerp(t.q[base], t.q[base + 1], s)
        at = s == 0.0
        p = np.where(at[:, None], p0, p)
        q = np.where(at[:, None], t.q[base], q)
        return p, quat_to_rot(q)

    def _project(self, R, p, lm):
        """Camera-frame rays of landmarks `lm` [N,3] from body poses R
        [N,3,3], p [N,3]."""
        body = np.einsum("nji,nj->ni", R, lm - p)
        return np.einsum("ji,nj->ni", self.R_ic, body - self.tic)

    def _visible(self, k: int):
        """Landmarks in view of the frame whose image content starts at
        sample k (`SequenceSimulator.frames` adds cam_td's whole samples),
        and each one's ray from the pose at its own row's time."""
        dt = 1.0 / IMU_RATE
        # the part of cam_td that `frames` left out of k
        rest = self.cam_td - int(round(self.cam_td * IMU_RATE)) * dt
        if rest == 0.0:
            ok, pts = super()._visible(k)
        else:
            n = len(self.landmarks)
            p, R = self.pose_at(np.full(n, k), np.full(n, rest))
            P_c = self._project(R, p, self.landmarks)
            z = P_c[:, 2]
            ok = (z > self.depth_range[0]) & (z < self.depth_range[1])
            zs = np.where(np.abs(z) < 1e-6, 1e-6, z)
            x, y = P_c[:, 0] / zs, P_c[:, 1] / zs
            ok &= (np.abs(x) < self.fov_x) & (np.abs(y) < self.fov_y)
            pts = np.stack([x, y, np.ones_like(x)], -1)
        if self.readout == 0.0 or not ok.any():
            return ok, pts
        idx = np.nonzero(ok)[0]
        lm = self.landmarks[idx]
        y = pts[idx, 1]
        for _ in range(ROW_STEPS):
            row = self.fy * y + self.cy - 0.5 * self.rows
            p, R = self.pose_at(np.full(len(idx), k),
                                rest + self.readout * row / self.rows)
            P_c = self._project(R, p, lm)
            y_next = P_c[:, 1] / P_c[:, 2]
            done = np.max(np.abs(y_next - y)) < 1e-14
            y = y_next
            if done:
                break
        pts = pts.copy()
        pts[idx, 0] = P_c[:, 0] / P_c[:, 2]
        pts[idx, 1] = P_c[:, 1] / P_c[:, 2]
        return ok, pts
