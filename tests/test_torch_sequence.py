"""Port vs JAX: utils/sequence.py and utils/metrics.py (numpy on both
sides). The simulator draws its random streams in the JAX package's order,
so a seed gives the same frames: same ids in the same dict order, values
equal to 1e-12 (the only arithmetic that differs is the quaternion →
rotation conversion, torch against XLA)."""

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.utils import metrics as jmet
from anticipated_vins_mono_tpu.utils import sequence as jseq
from anticipated_vins_mono_tpu.utils import synthetic as jsyn
from anticipated_vins_mono_torch.utils import metrics as tmet
from anticipated_vins_mono_torch.utils import sequence as tseq
from anticipated_vins_mono_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

NOISY = dict(pixel_noise=0.3, track_loss_rate=0.2, quality_noise_scale=1.0,
             slip_rate=0.1, imu_acc_sigma=0.05, imu_gyr_sigma=0.005,
             imu_acc_bias=0.02, imu_gyr_bias=0.002, max_features=40)


@pytest.mark.parametrize("seed,kw", [
    (0, dict(pixel_noise=0.3, max_features=40)),
    (0, NOISY),
    (3, NOISY),
    (3, dict(NOISY, quality_mode="iid", cam_td=0.01, clean_velocity=True)),
])
def test_simulator_yields_the_jax_frames(seed, kw):
    jtraj = jsyn.analytic_trajectory(2.0)
    ttraj = tsyn.analytic_trajectory(2.0)
    jsim = jseq.SequenceSimulator(jtraj, seed=seed, **kw)
    tsim = tseq.SequenceSimulator(ttraj, seed=seed, **kw)
    np.testing.assert_allclose(tsim.lm_quality, jsim.lm_quality, atol=1e-12)
    jframes, tframes = list(jsim.frames()), list(tsim.frames())
    assert len(jframes) == len(tframes) == 20
    assert tseq.FrameMeasurement._fields == jseq.FrameMeasurement._fields
    for jf, tf_ in zip(jframes, tframes):
        assert tf_.t == jf.t
        assert list(tf_.feats) == list(jf.feats)        # ids, dict order
        for fid in jf.feats:
            for a, b in zip(tf_.feats[fid], jf.feats[fid]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        for name in ("imu_dts", "imu_acc", "imu_gyr", "acc0", "gyr0"):
            np.testing.assert_allclose(getattr(tf_, name), getattr(jf, name),
                                       rtol=0, atol=1e-12, err_msg=name)
    assert len(tframes[-1].feats) > 10


@pytest.mark.parametrize("with_scale", [False, True])
def test_metrics_equal_the_jax_package(with_scale, tmp_path):
    rng = np.random.default_rng(5)
    t = np.arange(60) * 0.1
    gt = np.cumsum(rng.normal(size=(60, 3)) * 0.1, axis=0)
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    est = 1.1 * (gt @ R.T) + np.array([1.0, -2.0, 0.5]) \
        + rng.normal(size=(60, 3)) * 0.01
    for a, b in zip(tmet.align_umeyama(est, gt, with_scale),
                    jmet.align_umeyama(est, gt, with_scale)):
        np.testing.assert_array_equal(a, b)
    assert tmet.ate_rmse(t, est, t, gt, with_scale=with_scale) == \
        jmet.ate_rmse(t, est, t, gt, with_scale=with_scale)
    assert tmet.rte(t, est, t, gt, delta_s=2.0) == \
        jmet.rte(t, est, t, gt, delta_s=2.0)
    if with_scale:
        assert tmet.ate_rmse(t, est, t, gt, with_scale=True) < 0.03
    q = np.tile([1.0, 0, 0, 0], (60, 1))
    tmet.write_tum(str(tmp_path / "a.tum"), t, est, q)
    jmet.write_tum(str(tmp_path / "b.tum"), t, est, q)
    assert (tmp_path / "a.tum").read_text() == (tmp_path / "b.tum").read_text()
