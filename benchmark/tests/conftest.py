"""Fixtures of the benchmark's own tests: a temporary checkout holding
`BENCHMARK.json`, a copy of `benchmark/` and two cells at a size the CPU
holds (window 4, 32 landmark slots, 2 LM iterations), added as files and
entries only, as a later change would add them."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_VIO = dict(WINDOW_SIZE=4, max_feats=32, max_cnt=40, max_features=8,
                max_num_iterations=2)
TINY_BA = dict(window=4, max_feats=32, lm_iters=2, distinct_problems=2)
# The tiny cells' limits: float32 on the CPU at this size reads the prior
# 1e-4-2e-3 from the float64 reference and the positions ~1e-5 m, so the
# cells' own limits (set on the card at their sizes) are widened for the
# prior; every planted fault reads 1e-2 or more.
TINY_LIMITS = {"prior_rgap_p75": 5e-3, "pos_gap_problem_m": 1e-3}


def _json(path: Path):
    return json.loads(path.read_text())


def make_checkout(root: Path) -> Path:
    """A checkout at `root` with the tiny cells `tiny_vio.moving` and
    `tiny_ba.b4` added as new files and new entries."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = _json(REPO / "BENCHMARK.json")
    cfgs, wls = root / "benchmark" / "configs", root / "benchmark" / "workloads"
    vio = dict(_json(cfgs / "euroc_vio.json"), name="tiny_vio", **TINY_VIO)
    ba = dict(_json(cfgs / "euroc_window_ba.json"), name="tiny_ba", **TINY_BA)
    (cfgs / "tiny_vio.json").write_text(json.dumps(vio))
    (cfgs / "tiny_ba.json").write_text(json.dumps(ba))
    mv = _json(wls / "euroc_vio.moving.json")
    mv["trajectory"] = dict(mv["trajectory"], duration_s=3.0)
    mv.update(warmup_frames=1, trace_frames=2, check_frames=6,
              limits={"prior_rgap_p75": TINY_LIMITS["prior_rgap_p75"]})
    (wls / "tiny_vio.moving.json").write_text(json.dumps(mv))
    b4 = dict(_json(wls / "euroc_window_ba.b64.json"), batch=4,
              trace_solves=2, check_block=3,
              limits={"pos_gap_problem_m": TINY_LIMITS["pos_gap_problem_m"]})
    (wls / "tiny_ba.b4.json").write_text(json.dumps(b4))
    spec["configs"] += [
        dict(spec["configs"][0], name="tiny_vio",
             file="benchmark/configs/tiny_vio.json"),
        dict(spec["configs"][1], name="tiny_ba",
             file="benchmark/configs/tiny_ba.json")]
    spec["workloads"] += [
        {"name": "tiny_vio.moving", "config": "tiny_vio", "traffic": "moving",
         "chips": 1, "why": "the streaming step at a size the CPU holds"},
        {"name": "tiny_ba.b4", "config": "tiny_ba", "traffic": "b4",
         "chips": 1, "why": "the batched solve at a size the CPU holds"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            vio_metric = any(w.startswith("euroc_vio") for w in m["workloads"])
            m["workloads"].append("tiny_vio.moving" if vio_metric
                                  else "tiny_ba.b4")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run_cell(root: Path, cell: str, *extra, seconds=1.0, trace=0, seed=7):
    """Run `benchmark/run.py` of the checkout at `root` on the CPU; the port
    is imported from this repository. Returns (exit code, result or None,
    standard error)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    p = subprocess.run(
        [sys.executable, str(root / "benchmark" / "run.py"), "--workload",
         cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--device", "cpu", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, res, p.stderr


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
