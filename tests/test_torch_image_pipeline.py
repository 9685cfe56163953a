"""Port vs JAX: the image path as a whole (models/pipeline.run_from_images),
CPU.

The scene of `tests/test_image_pipeline.py`: a textured plane 8 m below a
camera at 160×120 translating at constant velocity, 24 frames at 10 Hz,
200 Hz IMU; the host `FeatureTracker` (60 features, min-distance 10, no
equalization) feeding `VioEstimator` (window 10, 96 slots, float64, oracle
start, no ZUPT). The same images go through the JAX `run_from_images` (a
module-scoped fixture) and the port's.

Tolerances: per-frame feature ids exact, rays within 2e-5 (float32
tracking on both sides); positions within 1e-3 m (the float32 tracker's
rounding enters the float64 estimator); no failure and ATE < 0.15 m, as the
JAX test asks. Measured: rays 8.9e-8, positions 3.2e-5 m, ATE 0.0011510 m
(JAX 0.0011513 m).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.models import frontend as jfe
from anticipated_vins_mono_tpu.models.estimator import VioEstimator as JEst
from anticipated_vins_mono_tpu.models.pipeline import \
    run_from_images as jrun
from anticipated_vins_mono_tpu.ops import cameras as jcam
from anticipated_vins_mono_tpu.ops.factors import GRAVITY
from anticipated_vins_mono_tpu.ops.window import WindowConfig as JCfg
from anticipated_vins_mono_tpu.utils.synthetic import Trajectory as JTraj
from anticipated_vins_mono_torch.models import frontend as tfe
from anticipated_vins_mono_torch.models.estimator import VioEstimator as TEst
from anticipated_vins_mono_torch.models.pipeline import \
    run_from_images as trun
from anticipated_vins_mono_torch.ops.window import WindowConfig as TCfg
from anticipated_vins_mono_torch.utils import convert
from anticipated_vins_mono_torch.utils.synthetic import Trajectory as TTraj

torch.set_num_threads(1)

CFG = dict(window=10, max_feats=96, iters=8)
TRACKER = dict(max_features=60, min_dist=10, equalize=False)


class _Recording:
    """A tracker wrapper that keeps each frame's measurement dict."""

    def __init__(self, tracker):
        self.tracker, self.out = tracker, []

    def process(self, img, t):
        self.out.append(self.tracker.process(img, t))
        return self.out[-1]


def _render_plane(cam, tex, p, R, z_plane=8.0):
    """A textured plane at z=z_plane (world) seen from the camera pose."""
    H, W = cam.height, cam.width
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.asarray(jcam.lift_projective(
        cam, jnp.asarray(np.stack([xx, yy], -1).reshape(-1, 2),
                         jnp.float32)))
    d_w = rays @ R.T
    lam = (z_plane - p[2]) / np.maximum(d_w[:, 2], 1e-6)
    X = p[None] + lam[:, None] * d_w
    ui = (X[:, 0] * 12.0) % tex.shape[1]
    vi = (X[:, 1] * 12.0) % tex.shape[0]
    vals = np.asarray(jfe._bilinear(
        jnp.asarray(tex, jnp.float32),
        jnp.asarray(np.stack([ui, vi], -1), jnp.float32)))
    return vals.reshape(H, W)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    cam = jcam.PinholeCamera.create(110.0, 110.0, 80.0, 60.0,
                                    width=160, height=120)
    tex = np.kron(rng.random((60, 60)), np.ones((3, 3)))
    dur, hz_img, hz_imu = 2.4, 10, 200
    n_imu = int(dur * hz_imu)
    t_imu = np.arange(n_imu) / hz_imu
    v = np.array([0.4, 0.15, 0.0])
    arrays = (t_imu, t_imu[:, None] * v, np.tile([1.0, 0, 0, 0], (n_imu, 1)),
              t_imu[:, None] * 0 + v, np.tile([0.0, 0.0, GRAVITY], (n_imu, 1)),
              np.zeros((n_imu, 3)))
    frames_t = np.arange(0, dur - 0.05, 1.0 / hz_img)
    images = [_render_plane(cam, tex, v * t, np.eye(3)) for t in frames_t]
    init = {"p": np.zeros(3), "q": np.array([1.0, 0, 0, 0]), "v": v}
    return cam, arrays, frames_t, images, init


@pytest.fixture(scope="module")
def jax_run(scene):
    cam, arrays, frames_t, images, init = scene
    tracker = _Recording(jfe.FeatureTracker(cam, jfe.TrackerParams(**TRACKER)))
    est = JEst(JCfg(**CFG), init_state=init, zupt=False)
    res = jrun(est, tracker, images, frames_t, arrays[0], arrays[4],
               arrays[5], gt=JTraj(*arrays))
    return res, tracker.out


def test_run_from_images_equals_jax(scene, jax_run):
    cam, arrays, frames_t, images, init = scene
    ref, ref_feats = jax_run
    tcam = convert.camera_from_numpy(jax.tree_util.tree_map(np.asarray, cam),
                                     device="cpu")
    tracker = _Recording(tfe.FeatureTracker(tcam, tfe.TrackerParams(**TRACKER)))
    est = TEst(TCfg(**CFG), init_state=init, zupt=False, device="cpu")
    res = trun(est, tracker, images, frames_t, arrays[0], arrays[4],
               arrays[5], gt=TTraj(*arrays))
    assert len(tracker.out) == len(ref_feats) == len(frames_t)
    for k, (out, want) in enumerate(zip(tracker.out, ref_feats)):
        assert sorted(out) == sorted(want), k
        for fid, (ray, vel, prob) in want.items():
            np.testing.assert_allclose(out[fid][0], ray, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(res.est_t, ref.est_t)
    np.testing.assert_allclose(res.est_p, ref.est_p, rtol=0, atol=1e-3)
    assert res.diag.failures == 0 and ref.diag.failures == 0
    assert len(res.est_t) == len(frames_t)
    assert res.ate < 0.15, res.ate
