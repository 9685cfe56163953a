"""The port's pixels-in benchmark runner (`utils/image_benchmark.py`)
against the JAX package's, CPU, at 160×120.

A module fixture writes 2.5 s of `analytic_trajectory` as a ground-truth
CSV and points both packages' `euroc.REFERENCE_GT_DIR` at it; it swaps
both runners' `WindowConfig` for the test size (window 3, 48 slots) and
both packages' `cameras.euroc_camera` for the EuRoC cam0 scaled to
160×120, for the fixture's lifetime. Each runner then renders the box
world along 1.2 s of the sequence, tracks (60 features, 2 pyramid levels),
and runs its estimator from its real initialization with no selector.

The rows have the same keys and the same frame count. The ATE is chaotic
in the rounding of the float32 image path (ROADMAP queue C 7: the XLA
thread count alone moves the JAX reading), so the port's is held to 1.5 ×
the JAX runner's reading in the same fixture, the rule of the earlier
image checks. The JAX runner takes ~30 s of the file, most of it XLA
compiles.
"""

import os

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.ops import cameras as jcameras
from anticipated_vins_mono_tpu.ops import window as jwindow
from anticipated_vins_mono_tpu.utils import euroc as jeuroc
from anticipated_vins_mono_tpu.utils import image_benchmark as jimage
from anticipated_vins_mono_torch.ops import cameras, window
from anticipated_vins_mono_torch.utils import euroc, image_benchmark
from anticipated_vins_mono_torch.utils.synthetic import (
    analytic_trajectory, write_euroc_csv)

torch.set_num_threads(1)

SEQ, GT_SECONDS = "SIM", 2.5
W, H = 160, 120
_S = W / 752.0
CAM = dict(fx=4.616e02 * _S, fy=4.603e02 * _S, cx=3.630e02 * _S,
           cy=2.481e02 * _S, k1=-2.917e-01, k2=8.228e-02, p1=5.333e-05,
           p2=-1.578e-04, width=W, height=H)
WINDOW = dict(window=3, max_feats=48)
RUN = dict(max_seconds=1.2, max_features=60, levels=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc"))
    os.makedirs(os.path.join(root, SEQ))
    write_euroc_csv(os.path.join(root, SEQ, "data.csv"),
                    analytic_trajectory(GT_SECONDS))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (euroc, jeuroc):
            mp.setattr(mod, "REFERENCE_GT_DIR", root)
        for mod, cfg in ((image_benchmark, window.WindowConfig),
                         (jimage, jwindow.WindowConfig)):
            mp.setattr(mod, "WindowConfig",
                       lambda _cfg=cfg, **kw: _cfg(**{**kw, **WINDOW}))
        mp.setattr(cameras, "euroc_camera",
                   lambda dtype=torch.float32, device="cuda":
                   cameras.PinholeCamera.create(**CAM, dtype=dtype,
                                                device=device))
        mp.setattr(jcameras, "euroc_camera",
                   lambda dtype=np.float32:
                   jcameras.PinholeCamera.create(**CAM, dtype=dtype))
        port = image_benchmark.run_image_benchmark(
            SEQ, device="cpu", out_tum=os.path.join(root, "port.tum"), **RUN)
        jax_row = jimage.run_image_benchmark(
            SEQ, out_tum=os.path.join(root, "jax.tum"), **RUN)
    return port, jax_row, root


def test_frames_and_ate_against_jax(runs):
    port, jax_row, root = runs
    assert set(port) == set(jax_row)
    for key in ("benchmark", "sequence", "policy", "kappa", "frames",
                "failures", "initialized"):
        assert port[key] == jax_row[key], key
    assert port["initialized"] and port["failures"] == 0
    assert port["frames"] >= 5
    assert np.isfinite(port["ate_rmse"])
    assert port["ate_rmse"] <= 1.5 * jax_row["ate_rmse"], \
        (port["ate_rmse"], jax_row["ate_rmse"])
    tum = np.loadtxt(os.path.join(root, "port.tum"))
    jtum = np.loadtxt(os.path.join(root, "jax.tum"))
    assert tum.shape == jtum.shape == (jax_row["frames"], 8)
    np.testing.assert_allclose(tum[:, 0], jtum[:, 0], rtol=0, atol=1e-9)


def test_stage_times_are_read(runs):
    row = runs[0]
    for key in ("tracker_ms_mean", "tracker_ms_p50", "render_ms_mean",
                "wall_s"):
        assert row[key] > 0, key
