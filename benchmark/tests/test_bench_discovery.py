"""The harness finds a configuration, a cell and a per-layer metric that
were added as files and entries only, and runs the cell."""

from __future__ import annotations

import json
import sys

from benchmark.tests.conftest import REPO, run_cell

sys.path.insert(0, str(REPO))


def test_parts_found_by_name(checkout):
    from benchmark import harness
    spec = harness.load_spec(checkout)
    wl, cfg, config, traffic, e2e, per_layer = harness.cell_parts(
        spec, "tiny_ba.b4", checkout / "benchmark")
    assert (wl["config"], cfg["name"], config["runner"]) == \
        ("tiny_ba", "tiny_ba", "window_ba")
    assert traffic["batch"] == 4
    assert {m["name"] for m in e2e} == {"solve_iters_per_s", "setup_s"}
    assert "solver.launches_per_iter" in {m["name"] for m in per_layer}


def test_added_metric_is_read(checkout):
    """A new reader file and entry reach the traced run's result."""
    root = checkout.parent / "with_metric"
    if not root.exists():
        import shutil
        shutil.copytree(checkout, root)
        (root / "benchmark" / "metrics" / "solver.spans_traced.py").write_text(
            "def read(ctx):\n    return float(ctx.trace.spans)\n")
        spec = json.loads((root / "BENCHMARK.json").read_text())
        spec["per_layer"].append(
            {"name": "solver.spans_traced", "unit": "solves", "better": "higher",
             "source": "program_span", "layer": "solver",
             "moves": "solve_iters_per_s", "workloads": ["tiny_ba.b4"]})
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res, err = run_cell(root, "tiny_ba.b4", trace=1, seconds=0.5)
    assert rc == 0, err
    assert res["metrics"]["solver.spans_traced"]["value"] == 2.0
    assert res["correct"] is True


def test_vio_cell_runs(checkout):
    rc, res, err = run_cell(checkout, "tiny_vio.moving", seconds=1.0)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p80", "setup_s"}
    assert list(res)[-1] == "checks"


def test_no_result_without_the_card(checkout):
    """Without `--device cpu` the run looks for a card: none here."""
    import subprocess
    import torch
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "tiny_ba.b4", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=checkout, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_without_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, the
    run fails and prints no result."""
    import shutil
    import subprocess
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "euroc_window_ba.b64", "--seed", "1", "--seconds",
                        "1", "--trace", "0", "--device", "cpu"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""
