"""The port's EuRoC benchmark runner (`utils/benchmark.py`) against the JAX
package's, CPU, float64, on a written ground-truth CSV.

The EuRoC files are not in the repository: a module fixture writes 3 s
of `analytic_trajectory` as `MH_TEST/data.csv` (biases included) and points
both packages' `euroc.REFERENCE_GT_DIR` at it, and swaps the `WindowConfig`
both runners build (10 keyframes, 192 slots) for the test size (window 4,
48 slots), as `tests/test_torch_loop_benchmark.py` swaps the loop runner's.
The same `run_one` arguments go to both runners — 1.6 s of the sequence,
the anticipation selector at κ̄ = 10 over 40 detections, real
initialization, seed 0 — at 0.3 px, the host chain's fixture noise:

- the frame count, the failures and `initialized` equal, ATE and RTE
  within 1e-4 m;
- the per-frame positions of the TUM trajectories both write within 1e-4
  m (the host chain's bound);
- the row's keys: `tests/test_torch_jax_runner_keys.py`.

At the runner's default 0.5 px the counts are equal too, and so is the
initialization solve, to 1e-9 m. From the first marginalization on, the
runs part as the port parts from itself at another thread count
(`python tests/benchmark_reference.py parting`, ROADMAP queue C 4(b)): the
reference's absolute eigenvalue cut (1e-8) falls inside the f64 rounding
of the dropped block (largest eigenvalue ~1e11), so which near-null
directions the prior keeps is rounding. Over seeds 0–4 the runs part by
up to 1.7e-4 m at 0.5 px, and by 2.8e-2 m on seed 1 even at 0.3 px (the
port against itself: 8.4e-2 m there); the initialization solve agrees to
6.1e-14 m on every one. Seed 0 at 0.3 px stays under 1.4e-6 m, which is
why the 1e-4 m bound is held there.

`run_benchmark` over two policies runs the same cells; `euroc_extrinsics`
and `make_gt_provider` are numpy-equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.ops import window as jwindow
from anticipated_vins_mono_tpu.utils import benchmark as jbench
from anticipated_vins_mono_tpu.utils import euroc as jeuroc
from anticipated_vins_mono_torch.ops import window as twindow
from anticipated_vins_mono_torch.utils import benchmark, euroc
from anticipated_vins_mono_torch.utils.synthetic import (
    analytic_trajectory, write_euroc_csv)

torch.set_num_threads(1)

SEQ, SECONDS = "MH_TEST", 1.6
WINDOW = dict(window=4, max_feats=48)
RUN = dict(policy="anticipate", kappa=10, max_seconds=SECONDS,
           detect_count=40, pixel_noise=0.3, n_landmarks=3000, dtype="f64")


@pytest.fixture(scope="module")
def gt_dir(tmp_path_factory):
    """The written sequence, both packages pointed at it, both runners'
    window at the test size."""
    root = tmp_path_factory.mktemp("euroc")
    os.makedirs(root / SEQ)
    write_euroc_csv(str(root / SEQ / "data.csv"), analytic_trajectory(3.0))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (euroc, jeuroc):
            mp.setattr(mod, "REFERENCE_GT_DIR", str(root))
        for mod, cfg in ((benchmark, twindow.WindowConfig),
                         (jbench, jwindow.WindowConfig)):
            mp.setattr(mod, "WindowConfig",
                       lambda _cfg=cfg, **kw: _cfg(**{**kw, **WINDOW}))
        yield root


@pytest.fixture(scope="module")
def runs(gt_dir):
    out = {}
    for name, mod, kw in (("port", benchmark, dict(device="cpu")),
                          ("jax", jbench, {})):
        out[name] = mod.run_one(SEQ, out_dir=str(gt_dir / name), **RUN, **kw)
    return out


@pytest.fixture(scope="module")
def default_noise_runs(gt_dir):
    """Both runners at their default pixel noise (0.5 px), each estimate's
    positions at full precision (the TUM file holds 6 decimals)."""
    run = {k: v for k, v in RUN.items() if k != "pixel_noise"}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod, kw in (("port", benchmark, dict(device="cpu")),
                              ("jax", jbench, {})):
            mp.setattr(mod, "write_tum", lambda path, t, p, q, _n=name:
                       out.__setitem__(_n + "_p", np.asarray(p, float)))
            out[name] = mod.run_one(SEQ, out_dir=str(gt_dir / "default"),
                                    **run, **kw)
    return out


def _tum(path):
    return np.loadtxt(path)


def test_run_one_equals_jax(runs):
    t, j = runs["port"], runs["jax"]
    for key in ("sequence", "policy", "kappa", "dtype", "accum", "hgen",
                "seed", "frames", "failures", "initialized",
                "real_extrinsics", "track_loss_rate"):
        assert t[key] == j[key], key
    assert t["initialized"] and t["frames"] >= 10
    for key in ("ate_rmse", "rte_rmse", "rte_median"):
        assert abs(t[key] - j[key]) <= 1e-4, (key, t[key], j[key])


def test_run_one_trajectories_equal_jax(gt_dir, runs):
    name = f"{SEQ}_anticipate_k10.tum"
    t, j = _tum(gt_dir / "port" / name), _tum(gt_dir / "jax" / name)
    assert t.shape == j.shape and len(t) == runs["port"]["frames"]
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], rtol=0, atol=1e-4)


def test_run_one_at_the_default_noise(default_noise_runs):
    """0.5 px: the counts equal and the initialization solve, the first
    estimate, before any marginalization prior enters a solve, to 1e-9 m."""
    t, j = default_noise_runs["port"], default_noise_runs["jax"]
    for key in ("frames", "failures", "initialized"):
        assert t[key] == j[key], key
    assert t["initialized"] and t["frames"] >= 10 and t["failures"] == 0
    tp, jp = default_noise_runs["port_p"], default_noise_runs["jax_p"]
    assert tp.shape == jp.shape == (t["frames"], 3)
    np.testing.assert_allclose(tp[0], jp[0], rtol=0, atol=1e-9)


def test_run_benchmark_runs_every_cell(gt_dir, monkeypatch):
    """The grid over the written sequence (found by `available_sequences`),
    two policies, in the calling process: one row per cell, in order."""
    calls = []
    monkeypatch.setattr(benchmark, "run_one",
                        lambda **kw: calls.append(kw) or {"cell": len(calls)})
    rows = benchmark.run_benchmark(policies=("quality", "random"),
                                   kappas=(10, 30), max_seconds=1.0,
                                   device="cpu")
    assert [r["cell"] for r in rows] == [1, 2, 3, 4]
    assert [(c["sequence"], c["kappa"], c["policy"]) for c in calls] == [
        (SEQ, 10, "quality"), (SEQ, 10, "random"), (SEQ, 30, "quality"),
        (SEQ, 30, "random")]
    assert all(c["device"] == "cpu" for c in calls)


def test_euroc_extrinsics_equal_jax():
    t, j = benchmark.euroc_extrinsics(), jbench.euroc_extrinsics()
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], np.asarray(j[1]), rtol=0, atol=1e-15)


def test_gt_provider_equals_jax(gt_dir):
    traj = euroc.load_sequence(SEQ)
    pt, pj = benchmark.make_gt_provider(traj, 6), \
        jbench.make_gt_provider(traj, 6)
    for t in (0.0, 0.37, 2.0):
        (a, b), (c, d) = pt(t), pj(t)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert pt(2.9) is None and pj(2.9) is None


def test_rows_serialize(runs):
    json.dumps(runs["port"])
