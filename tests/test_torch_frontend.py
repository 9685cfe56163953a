"""Port vs JAX: the image front end (models/frontend.py), float32, CPU.

The textures are those of `tests/test_frontend.py` (a 4×4-block random
image, blurred once, 160×120) and a sub-pixel shift of it; the tracker runs
on five frames of the textured box world rendered at 160×120 along the
circuit of `tests/test_tracker_device.py`, 10 Hz.

Tolerances (float32 on both sides, sums in another order): `clahe`,
`build_pyramid`, `equalize` and `_bilinear` 1e-6; `gftt_response` 1e-5
relative to its largest value; `detect_features` the same pixels and
validity, scores 1e-5 relative; `lk_track` the same `ok`, points within
1e-3 px. The host `FeatureTracker`: the same ids every frame, rays 1e-5,
velocities 1e-3, probabilities 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.models import frontend as jfe
from anticipated_vins_mono_tpu.ops import cameras as jcam
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.utils import render as jrender
from anticipated_vins_mono_tpu.utils.synthetic import loop_trajectory
from anticipated_vins_mono_torch.models import frontend as tfe
from anticipated_vins_mono_torch.utils import convert

torch.set_num_threads(1)


def _texture(H=120, W=160, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((H // 4, W // 4))
    img = np.kron(base, np.ones((4, 4)))
    return np.asarray(jfe._blur3(jnp.asarray(img, jnp.float32)))


def _shifted(img, dx, dy):
    """Subpixel shift via bilinear sampling."""
    H, W = img.shape
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pts = jnp.asarray(np.stack([xx - dx, yy - dy], -1).reshape(-1, 2),
                      jnp.float32)
    return np.asarray(jfe._bilinear(jnp.asarray(img, jnp.float32),
                                    pts)).reshape(H, W)


def _t(x):
    return torch.tensor(np.asarray(x), device="cpu")


def _close(out, ref, tol):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=tol)


@pytest.fixture(scope="module")
def rendered():
    """Five 160×120 frames of the box world along the circuit, the JAX
    renderer's pixels, and the camera."""
    W, H = 160, 120
    fx = 0.6 * W
    cam = jcam.PinholeCamera.create(fx, fx, W / 2, H / 2, width=W, height=H)
    traj = loop_trajectory(20.0, laps=2.0, radius=3.0)
    world = jrender.make_box_world(traj.p, margin=5.0, seed=0)
    rays = jrender.camera_rays(cam)
    R_all = np.asarray(jlie.quat_to_rot(jnp.asarray(traj.q)))
    ks = [0, 20, 40, 60, 80]
    imgs = [jrender.render_frame(world, cam, rays, traj.p[k], R_all[k])
            for k in ks]
    return cam, imgs, [float(traj.t[k]) for k in ks]


@pytest.mark.parametrize("seed,clip,tiles", [(0, 3.0, 8), (3, 3.0, 8),
                                             (1, 4.0, 4), (2, 1.0, 5)])
def test_clahe_equals_jax(seed, clip, tiles):
    img = _texture(seed=seed)
    ref = jfe.clahe(jnp.asarray(img), clip_limit=clip, tiles=tiles,
                    impl="gather")
    _close(tfe.clahe(_t(img), clip_limit=clip, tiles=tiles), ref, 1e-6)


def test_clahe_odd_size_equals_jax():
    img = _texture()[:117, :151]
    _close(tfe.clahe(_t(img)), jfe.clahe(jnp.asarray(img), impl="gather"),
           1e-6)


@pytest.mark.parametrize("bins", [16, 64])
def test_equalize_equals_jax(bins):
    img = _texture(seed=1).copy()
    img[0, :4] = [0.0, 1.0, 0.5, 0.25]     # values on bin edges
    _close(tfe.equalize(_t(img), bins), jfe.equalize(jnp.asarray(img), bins),
           1e-6)


@pytest.mark.parametrize("levels", [3, 4])
def test_build_pyramid_equals_jax(levels):
    img = tfe.clahe(_t(_texture(seed=2)))
    ref = jfe.build_pyramid(jnp.asarray(img.numpy()), levels)
    out = tfe.build_pyramid(img, levels)
    assert len(out) == len(ref) == levels
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        _close(o, r, 1e-6)


def test_gftt_response_equals_jax():
    img = _texture(seed=3)
    ref = np.asarray(jfe.gftt_response(jnp.asarray(img)))
    _close(tfe.gftt_response(_t(img)), ref, 1e-5 * ref.max())


@pytest.mark.parametrize("min_dist,occupied", [(16, False), (30, True),
                                               (9, True), (10, False)])
def test_detect_features_equals_jax(min_dist, occupied):
    """Even windows pad asymmetrically ((k-1)//2 before, k//2 after), and
    the zero scores of the padding slots come out in index order."""
    img = _texture(seed=4)
    occ = np.zeros_like(img)
    if occupied:
        occ[30:70, 40:100] = 1.0
    uv, sc, val = jfe.detect_features(jnp.asarray(img), jnp.asarray(occ),
                                      400, min_dist)
    tuv, tsc, tval = tfe.detect_features(_t(img), _t(occ), 400, min_dist)
    np.testing.assert_array_equal(tval.numpy(), np.asarray(val))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(uv))
    _close(tsc, sc, 1e-5 * float(np.max(sc)))
    assert 5 < int(tval.sum()) < 400     # padding slots exercised


def test_bilinear_equals_jax():
    img = _texture(seed=5)
    uv = np.random.default_rng(0).uniform(-3, 165, (300, 2)).astype(
        np.float32)
    _close(tfe._bilinear(_t(img), _t(uv)),
           jfe._bilinear(jnp.asarray(img), jnp.asarray(uv)), 1e-6)


@pytest.mark.parametrize("shift,levels", [((3.3, -2.1), 3), ((-1.7, 0.6), 4)])
def test_lk_track_equals_jax_on_a_known_shift(shift, levels):
    img = _texture()
    img2 = _shifted(img, *shift)
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform([20, 20], [140, 100], (12, 2)),
                          [[1.0, 1.0], [158.0, 60.0]]]).astype(np.float32)
    val = np.ones(len(pts), np.float32)
    val[3] = 0.0
    jp1 = tuple(jfe.build_pyramid(jnp.asarray(img), levels))
    jp2 = tuple(jfe.build_pyramid(jnp.asarray(img2), levels))
    ref_pts, ref_ok = jfe.lk_track(jp1, jp2, jnp.asarray(pts),
                                   jnp.asarray(val), levels=levels,
                                   impl="gather")
    tp1 = tuple(tfe.build_pyramid(_t(img), levels))
    tp2 = tuple(tfe.build_pyramid(_t(img2), levels))
    out_pts, out_ok = tfe.lk_track(tp1, tp2, _t(pts), _t(val), levels=levels)
    np.testing.assert_array_equal(out_ok.numpy(), np.asarray(ref_ok))
    _close(out_pts, ref_pts, 1e-3)
    ok = out_ok.numpy()
    assert 8 <= ok.sum() < len(pts)
    np.testing.assert_allclose(out_pts.numpy()[ok] - pts[ok],
                               np.tile(shift, (ok.sum(), 1)), atol=0.25)


def _carry(jt, tt):
    """The JAX host tracker's state copied into the port's."""
    tt.prev_pyr = None if jt.prev_pyr is None else tuple(
        torch.tensor(np.asarray(x), device="cpu") for x in jt.prev_pyr)
    for name in ("prev_pts", "ids", "life", "scores"):
        setattr(tt, name, getattr(jt, name).copy())
    tt.next_id, tt.prev_t = jt.next_id, jt.prev_t
    tt.prev_norm = {k: v.copy() for k, v in jt.prev_norm.items()}


def _trackers(cam):
    params = dict(max_features=40, min_dist=10)
    jt = jfe.FeatureTracker(cam, jfe.TrackerParams(**params))
    tt = tfe.FeatureTracker(
        convert.camera_from_numpy(jax.tree_util.tree_map(np.asarray, cam),
                                  device="cpu"),
        tfe.TrackerParams(**params))
    return jt, tt


def _same_measurements(out, ref, ray_tol):
    assert sorted(out) == sorted(ref)
    dev = 0.0
    for fid, (ray, vel, prob) in ref.items():
        np.testing.assert_allclose(out[fid][0], ray, atol=ray_tol, rtol=0)
        np.testing.assert_allclose(out[fid][1], vel, atol=1e-3, rtol=0)
        assert abs(out[fid][2] - prob) < 1e-5
        dev = max(dev, float(np.abs(out[fid][0] - ray).max()))
    return dev


def test_host_feature_tracker_equals_jax(rendered):
    """Both packages' host `FeatureTracker` (CLAHE on, RANSAC through each
    package's `relative_pose_ransac`) over five rendered frames, the port
    started from the JAX tracker's state before every frame."""
    cam, imgs, ts = rendered
    jt, tt = _trackers(cam)
    prev, kept = set(), []
    for img, t in zip(imgs, ts):
        _carry(jt, tt)
        ref = jt.process(img, t)
        _same_measurements(tt.process(img, t), ref, 1e-5)
        kept.append(len(set(ref) & prev))
        prev = set(ref)
    assert len(ref) >= 30 and min(kept[1:]) >= 10      # tracks persist


def test_host_feature_tracker_free_running_stays_with_jax(rendered):
    """The same five frames with each tracker on its own state: the ids
    stay equal; the points part by rounding that LK amplifies from frame to
    frame on the posterized texture (0.0104 px at the fourth frame here),
    held to 0.05 px, the card-vs-CPU bound of `chip_smoke.py`."""
    cam, imgs, ts = rendered
    jt, tt = _trackers(cam)
    fx = float(cam.fx)
    for img, t in zip(imgs, ts):
        _same_measurements(tt.process(img, t), jt.process(img, t),
                           0.05 / fx)


@pytest.mark.parametrize("shift", [(10, 0), (0, 10), (-12, 5)])
def test_lk_track_equals_jax_past_its_window(shift):
    """A whole-pixel shift past the finest level's ±8 px window (`pad`).
    Both packages cut the current frame's patch around the previous corner,
    not around the flow the coarser levels found, so at the finest level
    the window cannot follow a shift of more than 8 px and LK returns a
    wrong flow that passes its residual check: a reference defect the port
    reproduces (ROADMAP queue C 15). Held: `ok` exact, points 1e-3 px, as
    JAX; and the tracked points are off by more than 4 px."""
    img = _texture()
    img2 = np.roll(img, (shift[1], shift[0]), axis=(0, 1))
    rng = np.random.default_rng(2)
    pts = rng.uniform([40, 40], [120, 80], (16, 2)).astype(np.float32)
    val = np.ones(len(pts), np.float32)
    jp1 = tuple(jfe.build_pyramid(jnp.asarray(img), 3))
    jp2 = tuple(jfe.build_pyramid(jnp.asarray(img2), 3))
    ref_pts, ref_ok = jfe.lk_track(jp1, jp2, jnp.asarray(pts),
                                   jnp.asarray(val), impl="gather")
    out_pts, out_ok = tfe.lk_track(
        tuple(tfe.build_pyramid(_t(img), 3)),
        tuple(tfe.build_pyramid(_t(img2), 3)), _t(pts), _t(val))
    np.testing.assert_array_equal(out_ok.numpy(), np.asarray(ref_ok))
    _close(out_pts, ref_pts, 1e-3)
    ok = out_ok.numpy()
    err = np.abs(out_pts.numpy()[ok] - pts[ok] - np.array(shift)).max(-1)
    assert ok.sum() >= 8 and (err > 4.0).all(), err


def _smooth_texture(H=320, W=384, seed=1, blocks=(32, 64)):
    """Random blocks of 32 and 64 px, each blurred in proportion to its
    size: structure at the scale of the coarsest level of a 4-level
    pyramid (a 48 px shift is 6 px there), where the 4×4 blocks of
    `_texture` are averaged away."""
    rng = np.random.default_rng(seed)
    img = torch.zeros((H, W))
    for block in blocks:
        base = rng.random((-(-H // block), -(-W // block)))
        t = torch.tensor(np.kron(base, np.ones((block, block)))[:H, :W]
                         .astype(np.float32))
        for _ in range(block // 4):
            t = tfe._blur3(t)
        img += t / len(blocks)
    return img.numpy()


@pytest.mark.parametrize("shift", [(10, 0), (0, -25), (-48, 0)])
def test_lk_track_follow_flow_tracks_past_its_window(shift):
    """`follow_flow=True` cuts each level's patch around the flow carried
    down from the coarser level (calcOpticalFlowPyrLK's form, ROADMAP queue
    C 15), so a whole-pixel shift of 10, 25 or 48 px is followed: every
    point within 0.25 px of the truth, as on a shift inside the window
    (`test_lk_track_equals_jax_on_a_known_shift`). The JAX form on the
    same frames is more than 4 px off on most of them. Four levels, as the `euroc_tracker`
    configuration has: the coarsest sees a 48 px shift as 6 px, inside
    its ±8 px window, where the texture has structure at that scale (on
    finer textures some points of a 48 px shift do not converge there in
    10 iterations, in either form)."""
    img = _smooth_texture()
    img2 = np.roll(img, (shift[1], shift[0]), axis=(0, 1))
    rng = np.random.default_rng(1)
    pts = rng.uniform([130, 110], [250, 210], (32, 2)).astype(np.float32)
    val = np.ones(len(pts), np.float32)
    p1 = tuple(tfe.build_pyramid(_t(img), 4))
    p2 = tuple(tfe.build_pyramid(_t(img2), 4))
    errs = {}
    for follow in (True, False):
        out, ok = tfe.lk_track(p1, p2, _t(pts), _t(val), levels=4,
                               follow_flow=follow)
        errs[follow] = np.abs(out.numpy() - pts - np.array(shift)).max(-1)
        if follow:
            assert ok.numpy().all()
    np.testing.assert_array_less(errs[True], 0.25)
    assert np.median(errs[False]) > 4.0, errs[False]


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_as_image_of_uint8_equals_the_scaled_float(kind):
    """An 8-bit frame goes to the device as uint8 and is divided by 255
    there: exactly the float32 image of `img / 255`, every value 0-255
    included."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (120, 160), dtype=np.uint8)
    img[0, :256 - 160] = np.arange(160, 256)
    img[1, :160] = np.arange(160)
    src = img if kind == "numpy" else torch.from_numpy(img)
    out = tfe.as_image(src, "cpu")
    ref = tfe.as_image(img / 255, "cpu")
    assert out.dtype == torch.float32
    assert torch.equal(out, ref)
    assert src is not out and int(img[5, 5]) == int(src[5, 5])
