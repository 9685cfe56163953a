"""Checkpoint / resume — full estimator + pose-graph state serialization.

Counterpart of `anticipated_vins_mono_tpu/utils/checkpoint.py`. The
reference only checkpoints the pose graph (savePoseGraph/loadPoseGraph,
pose_graph.cpp: keyframe poses + loop info + BRIEF descriptors); here the
whole estimator — window states, biases, extrinsics, marginalization prior
(J0/r0/lin), landmark DB, raw IMU pair buffers — and the pose graph
serialize to one compressed npz, enabling batch-mode resume mid-sequence.

The npz keys are exactly the JAX package's, so a checkpoint written by one
package loads in the other. The prior's tensors are saved through
`.detach().cpu().numpy()`; on load they go to `est.device` in `est.dtype`.
"""

from __future__ import annotations

import numpy as np
import torch

from anticipated_vins_mono_torch.ops.window import PriorFactor, WindowState

IMU_KEYS = ("dts", "acc", "gyr", "acc0", "gyr0")
# npz key of each field of the prior's linearization point
_LIN_KEYS = {"p": "prior_lin_p", "q": "prior_lin_q", "v": "prior_lin_v",
             "ba": "prior_lin_ba", "bg": "prior_lin_bg",
             "tic": "prior_lin_tic", "qic": "prior_lin_qic",
             "td": "prior_lin_td", "inv_depth": "prior_lin_invd"}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_estimator(path: str, est) -> None:
    """Serialize a VioEstimator to `<path>` (npz)."""
    db = est.db
    pr = est.prior
    blobs = {
        "p": est.p, "q": est.q, "v": est.v, "ba": est.ba, "bg": est.bg,
        "tic": est.tic, "qic": est.qic, "td": np.float64(est.td),
        "n_frames": np.int64(est.n_frames),
        "initialized": np.int64(est.initialized),
        "frame_times": np.asarray(est.frame_times, float),
        # feature DB
        "db_ids": db.ids, "db_pts": db.pts, "db_vel": db.vel,
        "db_prob": db.prob, "db_mask": db.mask,
        "db_inv_depth": db.inv_depth, "db_solved": db.solved,
        # marginalization prior
        "prior_J0": _np(pr.J0), "prior_r0": _np(pr.r0),
        "prior_weight": _np(pr.weight),
        **{key: _np(getattr(pr.lin, f)) for f, key in _LIN_KEYS.items()},
        "n_imu_pairs": np.int64(len(est.imu_pairs)),
    }
    for i, pair in enumerate(est.imu_pairs):
        for key in IMU_KEYS:
            blobs[f"imu{i}_{key}"] = pair[key]
    np.savez_compressed(path, **blobs)


def load_estimator(path: str, est) -> None:
    """Restore a VioEstimator in place (must be constructed with the same
    WindowConfig)."""
    z = np.load(path)
    est.p = z["p"].copy()
    est.q = z["q"].copy()
    est.v = z["v"].copy()
    est.ba = z["ba"].copy()
    est.bg = z["bg"].copy()
    est.tic = z["tic"].copy()
    est.qic = z["qic"].copy()
    est.td = float(z["td"])
    est.n_frames = int(z["n_frames"])
    est.initialized = bool(z["initialized"])
    est.frame_times = list(z["frame_times"])
    db = est.db
    db.ids = z["db_ids"].copy()
    db.pts = z["db_pts"].copy()
    db.vel = z["db_vel"].copy()
    db.prob = z["db_prob"].copy()
    db.mask = z["db_mask"].copy()
    db.inv_depth = z["db_inv_depth"].copy()
    db.solved = z["db_solved"].copy()
    t = lambda key: torch.as_tensor(z[key], dtype=est.dtype, device=est.device)
    est.prior = PriorFactor(
        J0=t("prior_J0"), r0=t("prior_r0"),
        lin=WindowState(**{f: t(key) for f, key in _LIN_KEYS.items()}),
        weight=t("prior_weight"))
    est.imu_pairs = []
    for i in range(int(z["n_imu_pairs"])):
        est.imu_pairs.append({key: z[f"imu{i}_{key}"].copy()
                              for key in IMU_KEYS})


def save_posegraph(path: str, graph) -> None:
    """savePoseGraph parity (pose_graph.cpp): keyframe poses, loop edges,
    descriptors."""
    np.savez_compressed(
        path, n=np.int64(graph.n), pos=graph.pos, yaw=graph.yaw,
        pitch_roll=graph.pitch_roll, gdesc=graph.gdesc,
        seq_id=graph.seq_id, cur_sequence=np.int64(graph.cur_sequence),
        seq_i=graph.seq_i, seq_j=graph.seq_j, seq_t=graph.seq_t,
        seq_yaw=graph.seq_yaw, seq_valid=graph.seq_valid,
        n_seq=np.int64(graph.n_seq),
        loop_i=graph.loop_i, loop_j=graph.loop_j, loop_t=graph.loop_t,
        loop_yaw=graph.loop_yaw, loop_valid=graph.loop_valid,
        n_loops=np.int64(graph.n_loops),
        t_drift=graph.t_drift, yaw_drift=np.float64(graph.yaw_drift))


def load_posegraph(path: str, graph) -> None:
    z = np.load(path)
    graph.n = int(z["n"])
    # adopt the saved capacity (pose-graph storage grows dynamically)
    graph.cfg = graph.cfg._replace(max_kf=len(z["pos"]),
                                   max_loops=len(z["loop_i"]))
    if "seq_id" in z:
        graph.seq_id = z["seq_id"].copy()
        graph.cur_sequence = int(z["cur_sequence"])
    else:
        graph.seq_id = np.zeros(len(z["pos"]), np.int32)
        graph.cur_sequence = 0
    for key in ("pos", "yaw", "pitch_roll", "gdesc", "seq_i", "seq_j",
                "seq_t", "seq_yaw", "seq_valid", "loop_i", "loop_j",
                "loop_t", "loop_yaw", "loop_valid", "t_drift"):
        setattr(graph, key, z[key].copy())
    graph.n_seq = int(z["n_seq"])
    graph.n_loops = int(z["n_loops"])
    graph.yaw_drift = float(z["yaw_drift"])
