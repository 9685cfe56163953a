"""The rolling-shutter cell (`realsense_vio.moving`, runner
`vio_stream_rs`) at a size the CPU holds, added as files and entries only:
a sound run is `correct` and reads `td_gap_s`; both planted faults of the
time offset's model fail it."""

from __future__ import annotations

import json

import pytest

from benchmark.tests.conftest import TINY_LIMITS, TINY_VIO, make_checkout, \
    run_cell


@pytest.fixture(scope="module")
def rs_checkout(tmp_path_factory):
    root = make_checkout(tmp_path_factory.mktemp("rs"))
    cfgs, wls = root / "benchmark" / "configs", root / "benchmark" / "workloads"
    rs = json.loads((cfgs / "realsense_vio.json").read_text())
    (cfgs / "tiny_rs.json").write_text(
        json.dumps(dict(rs, name="tiny_rs", **TINY_VIO)))
    mv = json.loads((wls / "realsense_vio.moving.json").read_text())
    mv["trajectory"] = dict(mv["trajectory"], duration_s=3.0)
    mv.update(warmup_frames=1, trace_frames=2, check_frames=6)
    mv["limits"]["prior_rgap_p75"] = TINY_LIMITS["prior_rgap_p75"]
    (wls / "tiny_rs.moving.json").write_text(json.dumps(mv))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    base = next(c for c in spec["configs"] if c["name"] == "realsense_vio")
    spec["configs"].append(dict(base, name="tiny_rs",
                                file="benchmark/configs/tiny_rs.json"))
    spec["workloads"].append(
        {"name": "tiny_rs.moving", "config": "tiny_rs", "traffic": "moving",
         "chips": 1, "why": "the rolling-shutter step at a size the CPU holds"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "realsense_vio.moving" in m.get("workloads", []):
            m["workloads"].append("tiny_rs.moving")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_rs_cell_runs_correct(rs_checkout):
    rc, res, err = run_cell(rs_checkout, "tiny_rs.moving", seconds=1.0)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p80", "setup_s"}
    assert res["checks"]["td_gap_s"]["value"] < \
        res["checks"]["td_gap_s"]["limit"]


@pytest.mark.parametrize("fault", ["no_rs", "td_held"])
def test_rs_faults_fail(rs_checkout, fault):
    rc, res, err = run_cell(rs_checkout, "tiny_rs.moving", "--fault", fault,
                            seconds=1.0)
    assert rc == 0, err
    assert res["correct"] is False
    assert not all(c["value"] <= c["limit"] for c in res["checks"].values())
