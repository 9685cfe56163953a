"""The tracker cell's runner at a size the CPU holds: 160×120 frames of the
same circuit (two laps in 10 s, four times the cell's speed, so that a
frame shifts past LK's 8 px window as the cell's 752 px frames do), a
camera with the EuRoC distortion scaled to that width, 40 slots,
min-distance 10 px, three pyramid levels; the cell and its configuration
added as files and entries only, as a later change would add them. The
sound run is `correct` and reads its span metrics when traced; each
planted fault and the bfloat16 control are not `correct`."""

from __future__ import annotations

import json

import pytest

from benchmark.tests.conftest import make_checkout, run_cell

CELL = "tiny_tracker.circuit"
SCALE = 160 / 752
TINY_CAMERA = dict(width=160, height=120, fx=461.6 * SCALE,
                   fy=460.3 * SCALE, cx=363.0 * SCALE, cy=248.1 * 0.25,
                   k1=-0.2917, k2=0.08228, p1=5.333e-05, p2=-0.0001578)
# The tiny cell's limits (PERF.md §2): the cell's, but for the rays' (the
# position gap over this camera's focal length, 98 px) and the kept or
# dropped decisions, exact here: with the hypotheses fitted in float64 no
# sound run on the CPU flips one of 40 slots × 6 frames (three seeds); no
# RANSAC reads 12-24, a tilted hypothesis 1-9, LK in the JAX form 74 or
# more.
TINY_LIMITS = {"kept_gap_px_p95": 1e-3, "kept_diff": 0,
               "refill_unmatched_share": 0.03, "ray_gap_p95": 2e-5,
               "vel_gap_p95": 2e-4, "refill_score_rgap_p95": 3e-4,
               "prob_gap_max": 1e-5}
TRACKER_METRICS = ("tracker.launches", "tracker.host_syncs",
                   "tracker.lk_ms", "tracker.detect_ms", "tracker.prep_ms")


@pytest.fixture(scope="module")
def tracker_checkout(tmp_path_factory):
    root = make_checkout(tmp_path_factory.mktemp("checkout"))
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "euroc_tracker.json").read_text())
    cfg.update(name="tiny_tracker", camera=dict(cfg["camera"], **TINY_CAMERA),
               max_features=40, min_dist=10, levels=3)
    (bench / "configs" / "tiny_tracker.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "euroc_tracker.circuit.json")
                    .read_text())
    wl["circuit"] = dict(wl["circuit"], duration_s=10.0, laps=2.0)
    wl.update(warmup_frames=1, trace_frames=2, check_frames=6,
              limits=TINY_LIMITS)
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        next(c for c in spec["configs"] if c["name"] == "euroc_tracker"),
        name="tiny_tracker", file="benchmark/configs/tiny_tracker.json"))
    spec["workloads"].append(
        {"name": CELL, "config": "tiny_tracker", "traffic": "circuit",
         "chips": 1, "why": "the tracker cell at a size the CPU holds"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "euroc_tracker.circuit" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("control,fault,correct", [
    (None, None, True), (None, "jax_lk", False), (None, "moved", False),
    (None, "no_clahe", False), (None, "no_ransac", False),
    (None, "ransac_hypothesis", False), ("bf16", None, False)])
def test_tracker_cell_check(tracker_checkout, control, fault, correct):
    extra = (("--control", control) if control else ()) + \
        (("--fault", fault) if fault else ())
    rc, res, err = run_cell(tracker_checkout, CELL, *extra, seconds=1.0,
                            seed=2**31 + 17)
    assert rc == 0, err
    assert res["correct"] is correct, err
    if correct:
        assert set(res["metrics"]) == {"frame_ms", "frame_ms_p80", "setup_s"}


def test_traced_tracker_cell_reads_its_metrics(tracker_checkout):
    rc, res, err = run_cell(tracker_checkout, CELL, trace=1, seconds=2.0,
                            seed=5)
    assert rc == 0, err
    assert res["correct"] is True, err
    got = res["metrics"]
    assert set(TRACKER_METRICS) <= set(got), (sorted(got), err)
    assert got["tracker.host_syncs"]["value"] == 0.0      # no card, no sync
    assert got["tracker.launches"]["value"] == 0.0        # nor a launch
    assert all(got[n]["value"] > 0 for n in TRACKER_METRICS[2:])
