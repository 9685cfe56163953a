"""EuRoC ground-truth state loading + IMU derivation.

Counterpart of `anticipated_vins_mono_tpu/utils/euroc.py`. Parses the EuRoC
`state_groundtruth_estimate0` CSV layout (timestamp[ns], p[3], q[wxyz],
v[3], bg[3], ba[3]) as the reference does in
HorizonGenerator::loadGroundTruth (horizon_generator.cpp) and
benchmark_publisher.

Sequences are replayed as *state* trajectories: body-frame IMU
measurements are derived from the GT states (finite-difference
accelerations + body rates, plus the recorded biases), and feature tracks
are synthesized from a persistent landmark field (utils.sequence).

The CSV goes through the port's own native parser (`native.load_euroc_csv`,
built with `g++` at first use); a CSV it cannot open raises. The rotation
math runs in float64 on the CPU through the port's `ops.lie`.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from anticipated_vins_mono_torch.ops import lie
from anticipated_vins_mono_torch.utils.synthetic import G_W, Trajectory

# the EuRoC ground-truth CSVs (one `<sequence>/data.csv` each, the layout of
# the reference's benchmark_publisher configs), inside this repository; the
# directory is empty until they are added, so `available_sequences()` is [].
# The runners' callers may point it elsewhere
REFERENCE_GT_DIR = str(Path(__file__).resolve().parents[2] / "data" / "euroc")


def available_sequences() -> list:
    if not os.path.isdir(REFERENCE_GT_DIR):
        return []
    return sorted(d for d in os.listdir(REFERENCE_GT_DIR)
                  if os.path.isfile(os.path.join(REFERENCE_GT_DIR, d, "data.csv")))


def load_gt_csv(path: str, max_rows: int | None = None) -> dict:
    """Load a EuRoC GT CSV → dict of arrays (t seconds, p, q wxyz, v, bg, ba)."""
    from anticipated_vins_mono_torch import native
    return native.load_euroc_csv(path, max_rows=max_rows or 400000)


def _np(fn, *args) -> np.ndarray:
    """`fn` of `ops.lie` on float64 CPU tensors, as numpy."""
    return fn(*[torch.as_tensor(np.asarray(a, np.float64))
                for a in args]).numpy()


def gt_to_trajectory(gt: dict, add_bias: bool = True) -> Trajectory:
    """Derive body-frame IMU measurements from GT states.

    gyr_k = log(q_k⁻¹ ⊗ q_{k+1}) / dt           (body rates)
    acc_k = R_kᵀ (dv/dt − g) + ba                 (specific force)

    The gyro stream is the forward difference (the exact average rate over
    [t_k, t_{k+1}], leading its stamps by half a GT sample) unless
    `ANT_GT_GYRO` is set to anything but "forward", which takes the central
    difference (timing-true, half the bandwidth), as in the JAX package.
    """
    t, p, q, v = gt["t"], gt["p"], gt["q"], gt["v"]
    dt = np.gradient(t)
    a_w = np.gradient(v, axis=0) / dt[:, None]

    def rate(q0, q1):
        return _np(lambda a, b: lie.log_so3(lie.quat_mul(lie.quat_conj(a), b)),
                   q0, q1)

    if os.environ.get("ANT_GT_GYRO", "forward") == "forward":
        w_body = rate(q[:-1], q[1:]) / dt[:-1, None]
        w_body = np.vstack([w_body, w_body[-1:]])
    else:
        dt2 = (t[2:] - t[:-2])[:, None]
        w_mid = rate(q[:-2], q[2:]) / dt2
        w_first = rate(q[:1], q[1:2]) / dt[:1, None]
        w_last = rate(q[-2:-1], q[-1:]) / dt[-1:, None]
        w_body = np.vstack([w_first, w_mid, w_last])

    R = _np(lie.quat_to_rot, q)
    acc_body = np.einsum("nij,nj->ni", R.transpose(0, 2, 1), a_w - G_W)
    if add_bias:
        acc_body = acc_body + gt["ba"]
        w_body = w_body + gt["bg"]
    return Trajectory(t, p, q, v, acc_body, w_body)


def load_sequence(name: str, max_seconds: float | None = None) -> Trajectory:
    """Load a named EuRoC sequence's GT as a measurement trajectory."""
    path = os.path.join(REFERENCE_GT_DIR, name, "data.csv")
    max_rows = int(max_seconds * 200) if max_seconds else None
    gt = load_gt_csv(path, max_rows=max_rows)
    return gt_to_trajectory(gt)
