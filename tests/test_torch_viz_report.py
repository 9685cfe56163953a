"""The port's PPM drawing and results table against the JAX package's
(`utils/viz.py`, `utils/report.py`), CPU.

Same inputs into both: the PPM files are byte-equal (markers and AR boxes
projected through each package's `cameras.space_to_plane`, the port's on
the CPU in float64), and `render_results` gives the JAX text on a written
grid except the line naming the runner module. The port's copy takes both
paths as required arguments and writes only the file it is given.
"""

import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.ops import cameras as jcameras
from anticipated_vins_mono_tpu.utils import report as jreport
from anticipated_vins_mono_tpu.utils import viz as jviz
from anticipated_vins_mono_torch.ops import cameras
from anticipated_vins_mono_torch.utils import report, viz

torch.set_num_threads(1)

CAM = dict(fx=100.0, fy=100.0, cx=80.0, cy=60.0, k1=-0.1, k2=0.01,
           width=160, height=120)


@pytest.fixture(scope="module")
def cams():
    return (cameras.PinholeCamera.create(**CAM, dtype=torch.float64,
                                         device="cpu"),
            jcameras.PinholeCamera.create(**CAM, dtype=jnp.float64))


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(1).random((120, 160)) * 0.5



def _both_ppm(tmp_path, t_rgb, j_rgb):
    viz.write_ppm(str(tmp_path / "t.ppm"), t_rgb)
    jviz.write_ppm(str(tmp_path / "j.ppm"), j_rgb)
    return (tmp_path / "t.ppm").read_bytes(), (tmp_path / "j.ppm").read_bytes()


@pytest.mark.parametrize("kind", ["float", "uint8_rgb"])
def test_write_ppm_byte_equal(tmp_path, img, kind):
    x = img if kind == "float" else (np.stack([img] * 3, -1) * 255).astype(
        np.uint8)
    t, j = _both_ppm(tmp_path, x, x)
    assert t == j and t.startswith(b"P6\n160 120\n255\n")


def test_attention_overlay_byte_equal(tmp_path, cams, img):
    rng = np.random.default_rng(2)
    feats = []
    for _ in range(3):
        xy = rng.uniform(-0.6, 0.6, size=(6, 2))
        feats.append({i: np.array([x, y, 1.0]) for i, (x, y) in enumerate(xy)})
    # the selected dict carries (pt3, velocity, prob) tuples, as the
    # tracker's measurement dict does
    feats[1] = {k: (v, np.zeros(2), 0.9) for k, v in feats[1].items()}
    t = viz.attention_overlay(img, cams[0], *feats)
    j = jviz.attention_overlay(img, cams[1], *feats)
    assert (t == viz.COLORS["selected"]).all(-1).any()
    tb, jb = _both_ppm(tmp_path, t, j)
    assert tb == jb


@pytest.mark.parametrize("q", [[1.0, 0, 0, 0], [0.9848, 0.0, 0.1736, 0.0]],
                         ids=["identity", "yaw20"])
def test_ar_boxes_byte_equal(tmp_path, cams, img, q):
    q = np.asarray(q) / np.linalg.norm(q)
    centers = [[0.0, 0.0, 3.0], [0.6, -0.2, 2.5], [0.0, 0.0, -2.0]]
    t = viz.ar_boxes(img, cams[0], np.array([0.05, 0.0, 0.1]), q, centers)
    j = jviz.ar_boxes(img, cams[1], np.array([0.05, 0.0, 0.1]), q, centers)
    assert (t == viz.COLORS["box"]).all(-1).any()
    tb, jb = _both_ppm(tmp_path, t, j)
    assert tb == jb


@pytest.mark.parametrize("with_gt", [True, False])
def test_trajectory_topdown_equal(with_gt):
    rng = np.random.default_rng(3)
    est = np.cumsum(rng.normal(size=(50, 3)) * 0.1, axis=0)
    gt = est + rng.normal(size=est.shape) * 0.05 if with_gt else None
    np.testing.assert_array_equal(viz.trajectory_topdown(est, gt, size=120),
                                  jviz.trajectory_topdown(est, gt, size=120))


GRID = [
    {"sequence": "MH_01_easy", "policy": "anticipate", "ate_rmse": 0.1234},
    {"sequence": "MH_01_easy", "policy": "quality", "ate_rmse": 0.2},
    {"sequence": "MH_01_easy", "policy": None, "ate_rmse": 0.15},
    {"sequence": "V1_02_medium", "policy": "random", "error": "boom"},
    {"sequence": "V1_02_medium", "policy": "anticipate", "ate_rmse": 1.5},
]


def test_render_results_equals_jax_text(tmp_path):
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps(GRID))
    out_t, out_j = tmp_path / "t.md", tmp_path / "j.md"
    text_t = report.render_results(str(grid), str(out_t), kappa=10,
                                   seconds=30.0)
    text_j = jreport.render_results(str(grid), str(out_j), kappa=10,
                                    seconds=30.0)
    # the one line naming the runner module differs
    assert text_t == text_j.replace("anticipated_vins_mono_tpu.utils.benchmark",
                                    "anticipated_vins_mono_torch.utils.benchmark")
    assert out_t.read_text() == text_t
    assert "| MH_01_easy | 0.123 m | 0.200 m | — | 0.150 m |" in text_t
    assert "| V1_02_medium | 1.500 m | — | err | — |" in text_t
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["grid.json", "j.md", "t.md"]


def test_render_results_takes_both_paths():
    params = inspect.signature(report.render_results).parameters
    for name in ("grid_path", "out_path"):
        assert params[name].default is inspect.Parameter.empty


def test_aggregate_separation_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    for k in range(2):
        rows = [{"sequence": s, "policy": p, "hgen": h,
                 "ate_rmse": float(rng.choice([0.1, 0.3, 2.5]) + k * 0.01)}
                for s in ("MH_02", "MH_05") for p in ("anticipate", "random")
                for h in ("imu", "gt")]
        path = tmp_path / f"sep{k}.json"
        path.write_text(json.dumps(rows))
        paths.append(str(path))
    assert report.aggregate_separation(paths) == \
        jreport.aggregate_separation(paths)
