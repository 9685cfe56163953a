"""The port's EuRoC loader and pose-graph checkpoints against the JAX
package's (`utils/euroc.py`, `utils/checkpoint.py`), CPU, float64.

EuRoC: a ground-truth CSV written from `analytic_trajectory` (the EuRoC
files are not in the repository) goes through both packages'
`load_gt_csv` / `gt_to_trajectory` / `load_sequence`, with
`REFERENCE_GT_DIR` redirected on both modules; states, IMU and poses agree
within 1e-12.

Pose-graph checkpoints carry the same npz keys in both packages: one
package loads the other's with every array equal, both ways (the
estimator's checkpoints: `test_torch_checkpoint.py`).
"""

import os

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models.posegraph import PGOConfig as JPGOCfg
from anticipated_vins_mono_tpu.models.posegraph import PoseGraph as JGraph
from anticipated_vins_mono_tpu.utils import checkpoint as jckpt
from anticipated_vins_mono_tpu.utils import euroc as jeuroc
from anticipated_vins_mono_torch.models.posegraph import PGOConfig, PoseGraph
from anticipated_vins_mono_torch.utils import checkpoint, euroc
from anticipated_vins_mono_torch.utils.synthetic import (
    analytic_trajectory, write_euroc_csv)

torch.set_num_threads(1)


def _assert_npz_equal(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


# ---------------------------------------------------------------------------
# EuRoC ground truth
# ---------------------------------------------------------------------------


@pytest.fixture
def gt_dir(tmp_path, monkeypatch):
    """A written `MH_TEST/data.csv` (4 s of the analytic trajectory), both
    packages' REFERENCE_GT_DIR pointed at it."""
    os.makedirs(tmp_path / "MH_TEST")
    os.makedirs(tmp_path / "EMPTY")
    write_euroc_csv(str(tmp_path / "MH_TEST" / "data.csv"),
                    analytic_trajectory(4.0))
    for mod in (euroc, jeuroc):
        monkeypatch.setattr(mod, "REFERENCE_GT_DIR", str(tmp_path))
    return tmp_path


def test_available_sequences_equal_jax(gt_dir, monkeypatch):
    assert euroc.available_sequences() == jeuroc.available_sequences() == \
        ["MH_TEST"]
    for mod in (euroc, jeuroc):
        monkeypatch.setattr(mod, "REFERENCE_GT_DIR", str(gt_dir / "absent"))
    assert euroc.available_sequences() == jeuroc.available_sequences() == []


def test_default_gt_dir_is_inside_the_checkout():
    """The runners look for sequences in the repository's `data/euroc`
    unless a caller points them elsewhere; nothing around the checkout is
    read."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    gt = os.path.abspath(euroc.REFERENCE_GT_DIR)
    assert gt == os.path.join(repo, "data", "euroc")
    assert os.path.commonpath([gt, repo]) == repo
    want = sorted(d for d in os.listdir(gt)
                  if os.path.isfile(os.path.join(gt, d, "data.csv"))) \
        if os.path.isdir(gt) else []
    assert euroc.available_sequences() == want


@pytest.mark.parametrize("max_rows", [None, 300])
def test_load_gt_csv_equals_jax(gt_dir, max_rows):
    path = str(gt_dir / "MH_TEST" / "data.csv")
    t, j = euroc.load_gt_csv(path, max_rows), jeuroc.load_gt_csv(path, max_rows)
    assert set(t) == set(j) == {"t", "p", "q", "v", "bg", "ba"}
    for k in t:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-12, err_msg=k)
    assert len(t["t"]) == (max_rows or 801)
    ref = analytic_trajectory(4.0)
    np.testing.assert_allclose(t["t"], ref.t[:len(t["t"])], atol=1e-12)
    np.testing.assert_allclose(t["p"], ref.p[:len(t["t"])], atol=0)


def test_load_gt_csv_raises_on_a_missing_file(gt_dir):
    with pytest.raises(FileNotFoundError):
        euroc.load_gt_csv(str(gt_dir / "EMPTY" / "data.csv"))


@pytest.mark.parametrize("gyro,add_bias", [("forward", True),
                                           ("central", False)])
def test_gt_to_trajectory_equals_jax(gt_dir, monkeypatch, gyro, add_bias):
    monkeypatch.setenv("ANT_GT_GYRO", gyro)
    gt = euroc.load_gt_csv(str(gt_dir / "MH_TEST" / "data.csv"))
    t = euroc.gt_to_trajectory(gt, add_bias=add_bias)
    j = jeuroc.gt_to_trajectory(gt, add_bias=add_bias)
    for name in t._fields:
        np.testing.assert_allclose(getattr(t, name), np.asarray(getattr(j, name)),
                                   rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("max_seconds", [None, 2.5])
def test_load_sequence_equals_jax(gt_dir, max_seconds):
    t = euroc.load_sequence("MH_TEST", max_seconds=max_seconds)
    j = jeuroc.load_sequence("MH_TEST", max_seconds=max_seconds)
    assert len(t.t) == len(j.t) == (500 if max_seconds else 801)
    for name in t._fields:
        np.testing.assert_allclose(getattr(t, name), np.asarray(getattr(j, name)),
                                   rtol=0, atol=1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# Pose-graph checkpoints, both ways
# ---------------------------------------------------------------------------


def _fill(graph):
    """Eight keyframes with yaw, one loop edge, drift set by hand."""
    for k in range(8):
        yaw = 0.1 * k
        q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
        graph.add_keyframe(np.array([k, 0.5 * k, 0.1]), q)
    graph.loop_i[0], graph.loop_j[0] = 1, 7
    graph.loop_t[0] = [0.1, -0.2, 0.0]
    graph.loop_yaw[0], graph.loop_valid[0], graph.n_loops = 0.05, 1.0, 1
    graph.t_drift = np.array([0.01, 0.02, 0.0])
    graph.yaw_drift = 0.003
    return graph


POSEGRAPH_KEYS = ("pos", "yaw", "pitch_roll", "gdesc", "seq_id", "seq_i",
                  "seq_j", "seq_t", "seq_yaw", "seq_valid", "loop_i",
                  "loop_j", "loop_t", "loop_yaw", "loop_valid", "t_drift")


def _assert_graphs_equal(a, b):
    for k in POSEGRAPH_KEYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    for k in ("n", "n_seq", "n_loops", "cur_sequence", "yaw_drift"):
        assert getattr(a, k) == getattr(b, k), k
    assert a.cfg.max_kf == b.cfg.max_kf and a.cfg.max_loops == b.cfg.max_loops


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_posegraph_checkpoint_both_ways(tmp_path, direction):
    # capacity 4 < 8 keyframes: both graphs grow, and the loader adopts the
    # saved capacity
    jg = _fill(JGraph(JPGOCfg(max_kf=4, max_loops=2)))
    tg = _fill(PoseGraph(PGOConfig(max_kf=4, max_loops=2), device="cpu"))
    _assert_graphs_equal(tg, jg)
    path = str(tmp_path / "pg.npz")
    if direction == "jax_to_port":
        jckpt.save_posegraph(path, jg)
        out = PoseGraph(PGOConfig(max_kf=32, max_loops=4), device="cpu")
        checkpoint.load_posegraph(path, out)
    else:
        checkpoint.save_posegraph(path, tg)
        out = JGraph(JPGOCfg(max_kf=32, max_loops=4))
        jckpt.load_posegraph(path, out)
    _assert_graphs_equal(out, jg)
    again = str(tmp_path / "again.npz")
    (checkpoint if direction == "jax_to_port" else jckpt).save_posegraph(
        again, out)
    _assert_npz_equal(path, again)


def test_posegraph_without_sequence_ids_loads_as_one_sequence(tmp_path):
    """An older checkpoint without `seq_id` loads as sequence 0 in both."""
    tg = _fill(PoseGraph(PGOConfig(max_kf=16, max_loops=2), device="cpu"))
    path = str(tmp_path / "pg.npz")
    checkpoint.save_posegraph(path, tg)
    z = dict(np.load(path))
    del z["seq_id"], z["cur_sequence"]
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **z)
    t = PoseGraph(device="cpu")
    j = JGraph()
    checkpoint.load_posegraph(old, t)
    jckpt.load_posegraph(old, j)
    np.testing.assert_array_equal(t.seq_id, j.seq_id)
    assert t.cur_sequence == j.cur_sequence == 0
    assert t.pos.shape == (16, 3)
