"""The readers of the port's program spans (`benchmark/spans.py` and the
metrics that use it): on a synthetic trace they return the expected
milliseconds, sync count and idle share, and nothing where the recorder's
units are not the trace's; a traced run of the tiny CPU cells reports
every span metric but the idle share, which needs the card's kernels."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from benchmark.tests.conftest import BENCH, REPO, run_cell

sys.path.insert(0, str(REPO))

from anticipated_vins_mono_torch.utils import timing  # noqa: E402
from benchmark import harness  # noqa: E402

MS = 1_000_000
VIO = ("frame.host_syncs", "frame.preint_ms", "selector.ms_per_frame",
       "solver.ms_per_frame", "frame.margin_ms")
BA = ("solver.normal_eq_ms_per_iter", "solver.cost_ms_per_iter")
IDLE = "solver.normal_eq_idle_pct"


def _spans(rows):
    """`timing.Span`s from (name, parent index or None, start ms, end ms,
    syncs) rows; the unit is the outermost ancestor's index."""
    out = []
    for i, (name, parent, a, b, syncs) in enumerate(rows):
        unit = i if parent is None else out[parent].unit
        out.append(timing.Span(name, i, parent, unit, a * MS, b * MS, syncs))
    return out


def _frame(at, select, solve, margin, pre, syncs):
    """The rows of one frame starting at `at` ms, its parent at index 0."""
    return [("vio.step", None, at, at + 100, syncs[0]),
            ("vio.select", 0, at + 1, at + 1 + select, 0),
            ("vio.measurements", 0, at + 30, at + 40, 0),
            ("preint", 2, at + 31, at + 31 + pre[0], 0),
            ("vio.solve", 0, at + 40, at + 40 + solve, syncs[1]),
            ("vio.margin", 0, at + 90, at + 90 + margin, syncs[2]),
            ("preint", 5, at + 91, at + 91 + pre[1], 0)]


def _shift(rows, by):
    return [(n, None if p is None else p + by, a, b, s)
            for n, p, a, b, s in rows]


def _solve(at):
    """One solve of two iterations starting at `at` ms: normal equations
    10 ms, Schur 1 ms, cost 4 ms each."""
    rows = [("lm.solve", None, at, at + 40, 0)]
    t = at + 2
    for _ in range(2):
        rows += [("lm.normal_equations", 0, t, t + 10, 0),
                 ("lm.schur", 0, t + 10, t + 11, 0),
                 ("lm.cost", 0, t + 11, t + 15, 1)]
        t += 15
    return rows


@pytest.fixture
def fake(monkeypatch):
    """Sets what the recorder returns; yields the setter."""
    def put(rows):
        spans = _spans(rows)
        monkeypatch.setattr(timing, "recorded", lambda: spans)
    return put


def _ctx(units, kernels=(), iters=2):
    return SimpleNamespace(
        trace=SimpleNamespace(spans=units, kernels=list(kernels)),
        counters={"iters": iters})


def _read(name, ctx):
    return harness.reader(name, BENCH)(ctx)


def test_readers_on_a_synthetic_trace(fake):
    # two frames: selector 20 and 10 ms, solve 30 and 50, margin 8 and 6,
    # preintegration 2 + 3 and 4 + 1, syncs 1 + 0 + 2 and 3 + 1 + 0
    rows = _frame(0, 20, 30, 8, (2, 3), (1, 0, 2))
    rows += _shift(_frame(200, 10, 50, 6, (4, 1), (3, 1, 0)), len(rows))
    fake(rows)
    got = {n: _read(n, _ctx(2)) for n in VIO}
    assert got == pytest.approx({
        "frame.host_syncs": 3.5, "frame.preint_ms": 5.0,
        "selector.ms_per_frame": 15.0, "solver.ms_per_frame": 40.0,
        "frame.margin_ms": 7.0})
    # the solve readers find no `lm.solve` unit in a frame's trace
    assert all(_read(n, _ctx(2)) is None for n in BA + (IDLE,))
    # a unit count that is not the trace's reads nothing
    assert all(_read(n, _ctx(3)) is None for n in VIO)


def test_solve_readers_and_the_idle_share(fake):
    rows = _solve(0)
    rows += _shift(_solve(100), len(rows))
    fake(rows)
    # normal equations of the first solve at 2-12 and 17-27 ms, of the
    # second at 102-112 and 117-127: kernels cover 2-7 (5 ms), 20-22 and
    # 21-24 (4 ms of union), 110-130 (2 + 10 ms) and one outside (50-60)
    kernels = [("k", a * MS, (b - a) * MS) for a, b in
               ((0, 7), (20, 22), (21, 24), (50, 60), (110, 130))]
    ctx = _ctx(2, kernels)
    assert _read("solver.normal_eq_ms_per_iter", ctx) == pytest.approx(10.0)
    assert _read("solver.cost_ms_per_iter", ctx) == pytest.approx(4.0)
    assert _read(IDLE, ctx) == pytest.approx(100.0 * (1 - 21.0 / 40.0))
    # no kernel in the trace (the CPU), or units that disagree: nothing
    assert _read(IDLE, _ctx(2)) is None
    assert all(_read(n, _ctx(1, kernels)) is None for n in BA + (IDLE,))
    assert all(_read(n, ctx) is None for n in VIO)


def test_nothing_read_without_the_recorder(monkeypatch):
    """A port without `timing.recorded` (an older checkout): no value, no
    error."""
    monkeypatch.delattr(timing, "recorded")
    assert all(_read(n, _ctx(2)) is None for n in VIO + BA + (IDLE,))


@pytest.mark.parametrize("cell, names, seconds", [
    ("tiny_vio.moving", VIO, 3.0), ("tiny_ba.b4", BA, 0.5)])
def test_traced_tiny_cells_report_the_span_metrics(checkout, cell, names,
                                                   seconds):
    # the window has to hold the profiler's warm-up unit and the traced
    # ones: three frames of about half a second each on the CPU
    rc, res, err = run_cell(checkout, cell, trace=1, seconds=seconds)
    assert rc == 0, err
    assert res["correct"] is True, err
    got = res["metrics"]
    assert set(names) <= set(got), (sorted(got), err)
    assert all(got[n]["value"] >= 0 for n in names)
    if cell.startswith("tiny_vio"):
        assert got["frame.host_syncs"]["value"] == 0.0   # no card, no sync
        assert got["solver.ms_per_frame"]["value"] > 0
    else:
        assert IDLE not in got                           # no kernel traced
        assert got["solver.normal_eq_ms_per_iter"]["value"] > 0
