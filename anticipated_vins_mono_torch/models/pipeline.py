"""Sequence runner: feed a measurement stream through the estimator and
evaluate ATE/RTE against ground truth — the analog of the reference's
`roslaunch` + rosbag replay + evo evaluation loop.

Counterpart of `RunResult` and `run_sequence` in
`anticipated_vins_mono_tpu/models/pipeline.py`, and `run_from_images`, the
image path (images → tracker → estimator).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.utils.metrics import ate_rmse, rte
from anticipated_vins_mono_torch.utils.sequence import (FrameMeasurement,
                                                       SequenceSimulator)
from anticipated_vins_mono_torch.utils.synthetic import Trajectory


class RunResult(NamedTuple):
    est_t: np.ndarray
    est_p: np.ndarray
    est_q: np.ndarray
    ate: float
    rte_stats: dict
    diag: object


def run_sequence(est: VioEstimator, sim: SequenceSimulator,
                 n_frames: int | None = None,
                 gt: Trajectory | None = None) -> RunResult:
    for fm in sim.frames(n_frames):
        est.process_frame(fm)
    traj = est.trajectory
    est_t = np.array([x[0] for x in traj])
    est_p = np.stack([x[1] for x in traj])
    est_q = np.stack([x[2] for x in traj])
    gt = gt or sim.traj
    ate = ate_rmse(est_t, est_p, gt.t, gt.p)
    r = rte(est_t, est_p, gt.t, gt.p)
    return RunResult(est_t, est_p, est_q, ate, r, est.diag)


def run_from_images(est: VioEstimator, tracker, images, times,
                    imu_t, imu_acc, imu_gyr,
                    gt: Trajectory | None = None) -> RunResult:
    """Full image pipeline: images → tracker → measurement dicts →
    estimator, with IMU batches aligned per frame (the tracker + estimator
    node composition of the reference launch graph, euroc.launch:12-46).

    images: iterable of [H,W] images (numpy arrays or tensors, handed to
    `tracker.process` as they are); times: frame timestamps; imu_*: the raw
    IMU stream (sorted).
    """
    imu_t = np.asarray(imu_t)
    prev_t = None
    for img, t in zip(images, times):
        feats = tracker.process(img, float(t))
        if prev_t is None:
            k0 = int(np.searchsorted(imu_t, t))
            fm = FrameMeasurement(
                t=float(t), feats=feats, imu_dts=np.zeros(0),
                imu_acc=np.zeros((0, 3)), imu_gyr=np.zeros((0, 3)),
                acc0=imu_acc[min(k0, len(imu_acc) - 1)],
                gyr0=imu_gyr[min(k0, len(imu_gyr) - 1)])
        else:
            s = int(np.searchsorted(imu_t, prev_t, side="right"))
            e = int(np.searchsorted(imu_t, t, side="right"))
            s0 = max(s - 1, 0)
            fm = FrameMeasurement(
                t=float(t), feats=feats,
                imu_dts=np.diff(imu_t[s0:e]),
                imu_acc=np.asarray(imu_acc[s0 + 1:e]),
                imu_gyr=np.asarray(imu_gyr[s0 + 1:e]),
                acc0=np.asarray(imu_acc[s0]), gyr0=np.asarray(imu_gyr[s0]))
        est.process_frame(fm)
        prev_t = t
    traj = est.trajectory
    est_t = np.array([x[0] for x in traj])
    est_p = np.stack([x[1] for x in traj])
    est_q = np.stack([x[2] for x in traj])
    if gt is not None:
        ate = ate_rmse(est_t, est_p, gt.t, gt.p)
        r = rte(est_t, est_p, gt.t, gt.p)
    else:
        ate, r = float("nan"), {"rmse": float("nan"), "median": float("nan"),
                                "mean": float("nan")}
    return RunResult(est_t, est_p, est_q, ate, r, est.diag)
