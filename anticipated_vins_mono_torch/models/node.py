"""Streaming front door — the estimator node's pub/sub surface without ROS.

Counterpart of `anticipated_vins_mono_tpu/models/node.py`. Capability parity
with the reference estimator node's ingest side (estimator_node.cpp):
callers push raw IMU samples and per-frame feature measurements in arrival
order; the node aligns IMU batches to frames (getMeasurements, :100-141),
interpolates the boundary sample at each frame timestamp (:120-139), and
drives the estimator. `latest_state` gives the newest solved frame's output.

Where the two differ: `VioNode(use_native=True)` takes the port's native
aligner (`anticipated_vins_mono_torch.native`) or raises; the JAX node falls
back to `_PyAligner` without a word when its native library is missing.
Here `use_native=False` is the only way to get `_PyAligner`, the aligner's
plain version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.utils.sequence import FrameMeasurement


class _PyAligner:
    """The aligner in plain Python, with the contract of
    `native.MeasurementAligner`."""

    def __init__(self):
        self.t = []
        self.acc = []
        self.gyr = []
        self.last_frame_t = -1.0

    def push_imu(self, t, acc, gyr):
        self.t.append(float(t))
        self.acc.append(np.asarray(acc, float))
        self.gyr.append(np.asarray(gyr, float))

    def frame_batch(self, ft, max_n=256):
        if not self.t or self.t[-1] < ft:
            return None
        t = np.asarray(self.t)
        acc = np.stack(self.acc)
        gyr = np.stack(self.gyr)
        start = self.last_frame_t
        k0 = int(np.searchsorted(t, start, side="right"))
        s0 = max(k0 - 1, 0)
        a0, g0 = acc[s0], gyr[s0]
        tp = max(t[s0], start) if start > 0 else t[s0]
        dts, A, G = [], [], []
        k = s0
        while k + 1 < len(t) and t[k + 1] < ft:
            k += 1
            if t[k] <= tp:
                continue
            dts.append(t[k] - tp)
            A.append(acc[k])
            G.append(gyr[k])
            tp = t[k]
        if ft > tp and k + 1 < len(t):
            u = (ft - t[k]) / max(t[k + 1] - t[k], 1e-12)
            A.append((1 - u) * acc[k] + u * acc[k + 1])
            G.append((1 - u) * gyr[k] + u * gyr[k + 1])
            dts.append(ft - tp)
        self.last_frame_t = ft
        # trim consumed history
        keep = max(k0 - 2, 0)
        self.t = self.t[keep:]
        self.acc = self.acc[keep:]
        self.gyr = self.gyr[keep:]
        return (np.asarray(dts), np.stack(A) if A else np.zeros((0, 3)),
                np.stack(G) if G else np.zeros((0, 3)), a0, g0)


class VioNode:
    """push_imu / push_features streaming wrapper around VioEstimator."""

    def __init__(self, estimator: VioEstimator, use_native: bool = True):
        self.est = estimator
        if use_native:
            from anticipated_vins_mono_torch import native
            self.aligner = native.MeasurementAligner()
        else:
            self.aligner = _PyAligner()
        self._pending = []          # (t, feats) waiting for IMU coverage
        self._first = True

    def push_imu(self, t: float, acc, gyr):
        """imu_callback (:143-167)."""
        self.aligner.push_imu(t, acc, gyr)
        self._drain()

    def push_features(self, t: float, feats: dict):
        """feature_callback → measurement pairing."""
        self._pending.append((float(t), feats))
        self._drain()

    def _drain(self):
        while self._pending:
            t, feats = self._pending[0]
            out = self.aligner.frame_batch(t)
            if out is None:
                return   # wait for IMU to catch up (con.wait analog)
            dts, acc, gyr, a0, g0 = out
            if self._first:
                # first frame consumes no IMU interval
                dts, acc, gyr = np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3))
                self._first = False
            fm = FrameMeasurement(t=t, feats=feats, imu_dts=dts,
                                  imu_acc=acc, imu_gyr=gyr, acc0=a0, gyr0=g0)
            self._pending.pop(0)
            self.est.process_frame(fm)

    @property
    def latest_state(self) -> Optional[tuple]:
        """Most recent (t, p, q, v) output."""
        if not self.est.trajectory:
            return None
        return self.est.trajectory[-1]
