"""The port's calibration tooling (`utils/calibration.py`) against the JAX
package's, stage by stage from the same inputs, CPU.

- `render_chessboard`: the same image from the same pose (float64 camera)
  within 1e-12;
- `_saddle_response` on the same JAX-rendered 752×480 image: every corner
  within 1e-4 px and the scores within rtol 1e-4 (float32; the convolution
  sums in another order). A board near the image border leaves fewer
  saddle peaks than asked for, so the tail of the top-k is zero scores
  taken in index order from pixel (0, 0) on — `lax.top_k`'s tie order —
  and their 3×3 fit reads the clamped window `lax.dynamic_slice` reads
  there;
- `_order_grid`, `_homography_dlt`, `zhang_intrinsics`: numpy in both,
  equal;
- `_lm_refine` from the same start in float64 for the three camera models,
  6 iterations: parameters within 1e-8, cost within rtol 1e-9. Run on, the
  equidistant model's θ³..θ⁹ coefficients are near-collinear over the
  observed angles (`tests/test_calibration.py` says so too), LM walks the
  flat valley and the two packages' rounding parts them: after 12
  iterations by 4.5e-7 (relative 1.5e-7) while the cost agrees to 1e-9,
  the intrinsics to rtol 1e-9 and the distortion curve mu·r(θ) to 2.3e-6
  px — held at 1e-5 px.

The JAX package's full calibration is not rerun here
(`tests/test_calibration.py` holds it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.ops import cameras as jcameras
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.utils import calibration as jcal
from anticipated_vins_mono_torch.ops import cameras
from anticipated_vins_mono_torch.utils import calibration as cal

torch.set_num_threads(1)

NX, NY, SQ = 8, 6, 0.06
CENTER = np.array([-(NX - 1) * SQ / 2, -(NY - 1) * SQ / 2, 0.0])


def _pose(ypr, tc):
    R = np.asarray(jlie.ypr_to_rot(jnp.asarray(ypr, jnp.float64)))
    return R, np.asarray(tc) + R @ CENTER


# a board in the middle of the view, and one pushed to the image's left edge
VIEWS = {"center": ([15.0, -10.0, 8.0], [0.03, -0.02, 0.6]),
         "border": ([5.0, 8.0, -4.0], [-0.33, 0.05, 0.55])}


@pytest.fixture(scope="module")
def jax_images():
    cam = jcameras.euroc_camera(dtype=jnp.float64)
    out = {}
    for name, (ypr, tc) in VIEWS.items():
        R, t = _pose(ypr, tc)
        out[name] = np.asarray(jcal.render_chessboard(
            cam, jnp.asarray(R), jnp.asarray(t), NX, NY, SQ, ss=2))
    return out


def test_render_chessboard_equals_jax():
    kw = dict(fx=200.0, fy=190.0, cx=80.0, cy=62.0, k1=-0.2, k2=0.05,
              p1=1e-4, p2=-2e-4, width=160, height=120)
    R, t = _pose([10.0, 5.0, -3.0], [0.0, 0.0, 0.9])
    j = np.asarray(jcal.render_chessboard(
        jcameras.PinholeCamera.create(**kw, dtype=jnp.float64),
        jnp.asarray(R), jnp.asarray(t), NX, NY, SQ, ss=2))
    tcam = cameras.PinholeCamera.create(**kw, dtype=torch.float64,
                                        device="cpu")
    t_img = cal.render_chessboard(tcam, R, t, NX, NY, SQ, ss=2)
    assert t_img.dtype == torch.float64 and t_img.shape == (120, 160)
    np.testing.assert_allclose(t_img.numpy(), j, rtol=0, atol=1e-12)


def _corner_checker():
    """A flat 120×160 image with an axis-aligned checker in its top-left
    corner, touching the image border. Flat areas and straight edges have
    (next to) zero response, so the few saddles leave zero scores in the
    top-k, taken from pixel (0, 0) along row 0. Their 3×3 windows are the
    ones `lax.dynamic_slice` moves: a start of -1 has the size added and is
    clamped, so row 0 reads the last three rows, where the finite
    differences' wrap (row H-1 next to row 0) puts the checker's response.
    Square sizes (8-14 px) and contrasts vary, and every edge sits off the
    pixel grid (4×4 supersampling), so that no two saddles and no two
    neighbours of one saddle tie."""
    rng = np.random.default_rng(2)
    ss = 4
    ys = ss * np.concatenate([[0], np.cumsum(rng.integers(8, 15, 4))]) + 3
    xs = ss * np.concatenate([[0], np.cumsum(rng.integers(8, 15, 6))]) + 1
    ys[0] = xs[0] = 0
    img = np.full((120 * ss, 160 * ss), 0.5)
    for i in range(len(ys) - 1):
        for j in range(len(xs) - 1):
            sign = 1.0 if (i + j) % 2 else -1.0
            img[ys[i]:ys[i + 1], xs[j]:xs[j + 1]] = \
                0.5 + sign * rng.uniform(0.2, 0.45)
    return img.reshape(120, ss, 160, ss).mean(axis=(1, 3)).astype(np.float32)


@pytest.mark.parametrize("view", ["center", "border", "corner_checker"])
def test_saddle_response_equals_jax(jax_images, view):
    img = _corner_checker() if view == "corner_checker" else jax_images[view]
    n = NX * NY
    juv, jvals = jcal._saddle_response(jnp.asarray(img, jnp.float32), n)
    juv, jvals = np.asarray(juv), np.asarray(jvals)
    uv, vals = cal._saddle_response(torch.as_tensor(img), n)
    uv, vals = uv.numpy(), vals.numpy()
    assert uv.dtype == np.float32 and uv.shape == (n, 2)
    np.testing.assert_allclose(vals, jvals, rtol=1e-4,
                               atol=1e-4 * float(jvals.max()))
    np.testing.assert_allclose(uv, juv, rtol=0, atol=1e-4)
    peaks = jvals > 0
    if view != "corner_checker":
        assert peaks.all()
        return
    # fewer peaks than asked for: the zero scores come in index order, row 0
    # from x = 0 on, and their fits read the moved windows' response
    zeros = np.flatnonzero(~peaks)
    assert len(zeros) >= 10 and np.all(vals[zeros] == 0)
    np.testing.assert_array_equal(np.round(juv[zeros, 1]), 0)
    assert np.any(np.abs(juv[zeros, 0] - np.arange(len(zeros))) > 0.05)


def test_detect_chessboard_equals_jax(jax_images):
    img = jax_images["center"]
    got = cal.detect_chessboard(img, NX, NY, device="cpu")
    ref = jcal.detect_chessboard(img, NX, NY)
    assert got is not None and got.shape == (NX * NY, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    got = cal.detect_chessboard(jax_images["border"], NX, NY, device="cpu")
    ref = jcal.detect_chessboard(jax_images["border"], NX, NY)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    flat = np.full((120, 160), 0.5)
    assert cal.detect_chessboard(flat, NX, NY, device="cpu") is None
    assert jcal.detect_chessboard(flat, NX, NY) is None


@pytest.mark.parametrize("deg", [0, 30, 44, 90])
def test_order_grid_equals_jax(deg):
    board = cal.board_points(NX, NY, 20.0)[:, :2] + 100.0
    th = np.radians(deg)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    uv = board @ R.T + np.random.default_rng(deg).normal(0, 0.1, board.shape)
    perm = np.random.default_rng(deg + 1).permutation(len(uv))
    got, ref = cal._order_grid(uv[perm], NX, NY), jcal._order_grid(uv[perm],
                                                                   NX, NY)
    assert got is not None
    np.testing.assert_array_equal(got, ref)
    assert cal._order_grid(uv[:-1], NX, NY) is None


def _synthetic_views(gt_j, n_views, seed):
    board = cal.board_points(NX, NY, SQ)
    rng = np.random.default_rng(seed)
    dets, poses = [], []
    for _ in range(n_views):
        R, t = _pose(rng.uniform([-25, -25, -20], [25, 25, 20]),
                     [rng.uniform(-0.1, 0.1), rng.uniform(-0.07, 0.07),
                      rng.uniform(0.5, 0.9)])
        uv = np.asarray(jcameras.space_to_plane(gt_j, jnp.asarray(
            board @ R.T + t)))
        dets.append(uv + rng.normal(0, 0.05, uv.shape))
        poses.append((R, t))
    return board, dets, poses


def test_zhang_bootstrap_equals_jax():
    gt = jcameras.euroc_camera(dtype=jnp.float64)
    board, dets, _ = _synthetic_views(gt, 6, seed=3)
    Hs_t = [cal._homography_dlt(board[:, :2], d) for d in dets]
    Hs_j = [jcal._homography_dlt(board[:, :2], d) for d in dets]
    for a, b in zip(Hs_t, Hs_j):
        np.testing.assert_array_equal(a, b)
    K = cal.zhang_intrinsics(Hs_t, 752, 480)
    assert K == jcal.zhang_intrinsics(Hs_j, 752, 480)
    assert abs(K[0] - 461.6) / 461.6 < 0.05
    Kmat = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1.0]])
    for a, b in zip(cal._extrinsics_from_H(Kmat, Hs_t[0]),
                    jcal._extrinsics_from_H(Kmat, Hs_j[0])):
        np.testing.assert_array_equal(a, b)
    # a degenerate system falls back to the centered guess in both
    assert cal.zhang_intrinsics([np.eye(3)] * 3, 752, 480) == \
        jcal.zhang_intrinsics([np.eye(3)] * 3, 752, 480)


MODELS = {
    "pinhole": ("PinholeCamera",
                dict(fx=461.6, fy=460.3, cx=363.0, cy=248.1, k1=-0.29,
                     k2=0.08, p1=5e-5, p2=-1.6e-4),
                [430.0, 430.0, 370.0, 240.0, 0.0, 0.0, 0.0, 0.0]),
    "equidistant": ("EquidistantCamera",
                    dict(mu=380.0, mv=379.0, u0=370.0, v0=242.0, k2=0.02,
                         k3=-0.005, k4=0.001, k5=0.0),
                    [360.0, 360.0, 376.0, 240.0, 0.0, 0.0, 0.0, 0.0]),
    "mei": ("MeiCamera",
            dict(xi=0.9, fx=700.0, fy=698.0, cx=370.0, cy=244.0, k1=-0.1,
                 k2=0.02, p1=0.0, p2=0.0),
            [1.0, 680.0, 680.0, 376.0, 240.0, 0.0, 0.0, 0.0, 0.0]),
}


def _lm_both(model, iters):
    cls_name, true, start = MODELS[model]
    jcls, tcls = getattr(jcameras, cls_name), getattr(cameras, cls_name)
    gt = jcls.create(**true, width=752, height=480, dtype=jnp.float64)
    board, dets, poses = _synthetic_views(gt, 5, seed=7)
    rng = np.random.default_rng(11)
    rv0 = np.stack([np.asarray(jlie.log_so3(jlie.rot_to_quat(jnp.asarray(R))))
                    for R, _ in poses]) + rng.normal(0, 0.01, (5, 3))
    tv0 = np.stack([t for _, t in poses]) + rng.normal(0, 0.005, (5, 3))
    args = (np.asarray(start), rv0, tv0, board, np.stack(dets))
    jz, jcost = jcal._lm_refine(*[jnp.asarray(a, jnp.float64) for a in args],
                                (jcls, 752, 480), iters)
    tz, tcost = cal._lm_refine(*[torch.as_tensor(a, dtype=torch.float64)
                                 for a in args], (tcls, 752, 480), iters)
    assert tz.dtype == torch.float64
    return tz.numpy(), float(tcost), np.asarray(jz), float(jcost), len(start)


@pytest.mark.parametrize("model", list(MODELS))
def test_lm_refine_equals_jax(model):
    tz, tcost, jz, jcost, _ = _lm_both(model, 6)
    np.testing.assert_allclose(tz, jz, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tcost, jcost, rtol=1e-9)
    assert tcost < 1.0


def test_lm_refine_equidistant_in_its_flat_valley():
    tz, tcost, jz, jcost, P = _lm_both("equidistant", 12)
    np.testing.assert_allclose(tcost, jcost, rtol=1e-9)
    np.testing.assert_allclose(tz[:4], jz[:4], rtol=1e-9)
    theta = torch.linspace(0.0, 0.7, 64, dtype=torch.float64)
    curve = lambda z: cameras._kb_r(cameras.EquidistantCamera.create(
        *z[:P], dtype=torch.float64, device="cpu"), theta).numpy() * z[0]
    np.testing.assert_allclose(curve(tz), curve(jz), rtol=0, atol=1e-5)


def test_calibrate_camera_runs_in_the_templates_dtype_and_device():
    """Zhang bootstrap + refinement end to end in the port on synthetic
    detections: the refined intrinsics within 0.5 % of the truth (the JAX
    test's bar), the camera's parameters on the template's device in its
    dtype."""
    gt = jcameras.euroc_camera(dtype=jnp.float64)
    board, dets, _ = _synthetic_views(gt, 6, seed=5)
    tmpl = cameras.PinholeCamera.create(400., 400., 376., 240., width=752,
                                        height=480, dtype=torch.float64,
                                        device="cpu")
    res = cal.calibrate_camera(dets, board, tmpl, iters=30)
    assert res.camera.fx.dtype == torch.float64
    assert res.rms_px < 0.1 and res.n_views == 6
    for f in ("fx", "fy", "cx", "cy"):
        est, true = float(getattr(res.camera, f)), float(getattr(gt, f))
        assert abs(est - true) / true < 0.005, (f, est, true)
