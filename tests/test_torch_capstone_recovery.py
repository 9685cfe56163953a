"""The failure-injection protocol of the port's capstone runner
(`utils/device_vio_bench.main(corrupt_at=...)`), on the CPU at 160×120 over
2.5 s of a slow circuit (0.15 laps: the real re-initialization needs frame
pairs that share tracks), float64, a 3-keyframe window with 48 slots.

Half way, the device carry is corrupted (+30 m/s, +50 m): the device's
failure detector must fire and its reboot keep the outputs finite; the host
then re-runs the real initialization chain from the failure frame and hands
the window back to the device. The result has exactly the JAX runner's keys
(read from the JAX module's source), the recovered segment is finite and
its ATE bounded.
"""

import numpy as np
import torch

from anticipated_vins_mono_torch.utils import device_vio_bench as dvb
from test_torch_jax_runner_keys import jax_row_keys

torch.set_num_threads(1)

SIZE = dict(width=160, height=120, n_feats=64, device="cpu",
            dtype_str="float64", window=3, max_feats=48)


def test_corruption_recovery_returns_the_jax_keys():
    rows = dvb.main(duration=2.5, laps=0.15, corrupt_at=0.5, **SIZE)
    assert set(rows) == jax_row_keys(
        "device_vio_bench.py")["corruption_recovery"]
    assert rows["mode"] == "corruption_recovery"
    assert rows["corrupt_frame"] == 12 and rows["device_fail_flags"] >= 1
    assert rows["fail_frame"] >= rows["corrupt_frame"]
    assert rows["reinit_frames"] >= 4 and rows["recovered_frames"] >= 1
    assert rows["post_corruption_finite"] is True
    assert np.isfinite(rows["ate_recovered_m"]) \
        and rows["ate_recovered_m"] < 1.0
