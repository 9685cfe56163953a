"""Sequence runner: feed a measurement stream through the estimator and
evaluate ATE/RTE against ground truth — the analog of the reference's
`roslaunch` + rosbag replay + evo evaluation loop.

Counterpart of `RunResult` and `run_sequence` in
`anticipated_vins_mono_tpu/models/pipeline.py`. (`run_from_images` needs the
front end, which the port does not have yet.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.utils.metrics import ate_rmse, rte
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator
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
