"""The port's program spans and host-sync counter (`utils/timing.span`),
CPU, float64.

Without a profiler a span is one shared no-op and nothing is recorded.
Under `torch.profiler` a tiny `lm_solve` records one `lm.solve` unit with
one `lm.normal_equations`, `lm.schur` and `lm.cost` per iteration, and a
tiny `vio_step` records its stages nested in one `vio.step`; each span's
stamps lie within 100 µs of the profiler's annotation of the same name,
and the outputs are bit for bit those of the same call without the
profiler. The sync counter is held on the warning torch raises at a
synchronising CUDA operation, emitted here by hand (no card on the CPU),
and by the line that raised it.
"""

import inspect
import os
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anticipated_vins_mono_torch.models import anticipation as ant
from anticipated_vins_mono_torch.models import estimator_device as ed
from anticipated_vins_mono_torch.ops import window as win
from anticipated_vins_mono_torch.utils import profile_slice, timing
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator
from anticipated_vins_mono_torch.utils.synthetic import (
    analytic_trajectory, batched, make_window_problem)
from anticipated_vins_mono_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

WCFG = win.WindowConfig(window=4, max_feats=32, iters=2)
PR = ed.DeviceVioParams(wcfg=WCFG,
                        sel_cfg=ant.SelectorConfig(max_features=8),
                        sel_impl="chol")
N_IN = 40
PHASES = ("lm.normal_equations", "lm.schur", "lm.cost")
STAGES = ("vio.enter", "vio.select", "vio.db", "vio.triangulate",
          "vio.measurements", "vio.solve", "vio.demote", "vio.margin")


def _solve_call():
    prob = make_window_problem(WCFG, seed=3, perturb=0.3, pixel_noise=0.5,
                               device="cpu")
    st, ms = batched(prob.init, 2), batched(prob.meas, 2)
    return lambda: win.lm_solve(st, ms, WCFG, device="cpu")


def _step_call():
    traj = analytic_trajectory(1.0)
    sim = SequenceSimulator(traj, seed=0, pixel_noise=0.3,
                            max_features=N_IN)
    packed = [ed.pack_frame(fm, N_IN, device="cpu") for fm in sim.frames()]
    nf = WCFG.nf
    st = ed.vio_init_oracle(PR, {"p": traj.p[0], "q": traj.q[0],
                                 "v": traj.v[0]}, packed[:nf - 1],
                            device="cpu")
    return lambda: ed.vio_step(PR, st, *packed[nf - 1], device="cpu")


def _traced(call):
    """(output, recorded spans, the profiler's user annotations as
    (name, start_ns, end_ns)) of `call()` under a CPU profiler; a first
    profiled call warms `record_function`."""
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    timing.reset_recorded()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    spans = timing.recorded()
    timing.reset_recorded()
    notes = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() in {s.name for s in spans}]
    return out, spans, notes


@pytest.fixture(scope="module")
def runs():
    """For the solve and the step: the output without a profiler, the
    spans recorded without one, and `_traced`'s three values."""
    out = {}
    for name, make in (("solve", _solve_call), ("step", _step_call)):
        call = make()
        timing.reset_recorded()
        plain = call()
        untraced = timing.recorded()
        out[name] = (plain, untraced) + _traced(call)
    return out


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_span_is_the_shared_noop_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = timing.span("vio.step"), timing.span("lm.cost")
    assert a is b
    timing.reset_recorded()
    with a:
        with b:
            pass
    assert timing.recorded() == []


@pytest.mark.parametrize("call", ["solve", "step"])
def test_nothing_recorded_without_a_profiler(runs, call):
    assert runs[call][1] == []


def test_lm_solve_records_one_unit_with_each_phase_per_iteration(runs):
    _, _, _, spans, _ = runs["solve"]
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["lm.solve"]
    (solve,) = top
    assert solve.unit == solve.id
    kids = _children(spans, solve)
    assert [s.name for s in kids] == list(PHASES) * WCFG.iters
    assert len(spans) == 1 + len(kids)
    for s in spans:
        assert s.unit == solve.id
        assert solve.start_ns <= s.start_ns <= s.end_ns <= solve.end_ns
    # the phases follow each other
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert all(s.syncs == 0 for s in spans)


def test_vio_step_records_the_stages_in_one_step(runs):
    _, _, _, spans, _ = runs["step"]
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["vio.step"]
    (step,) = top
    kids = _children(spans, step)
    assert [s.name for s in kids] == list(STAGES)
    assert all(s.unit == step.id for s in spans)
    # the solve inside `vio.solve`; preintegration inside the measurements
    # and, on a keyframe, inside the marginalization
    by = {s.name: s for s in kids}
    (solve,) = [s for s in spans if s.name == "lm.solve"]
    assert solve.parent == by["vio.solve"].id
    assert [s.name for s in _children(spans, solve)] == \
        list(PHASES) * WCFG.iters
    pre = [s for s in spans if s.name == "preint"]
    assert pre and pre[0].parent == by["vio.measurements"].id
    assert all(s.parent in (by["vio.measurements"].id, by["vio.margin"].id)
               for s in pre)


@pytest.mark.parametrize("call", ["solve", "step"])
def test_spans_lie_on_the_profiler_annotations(runs, call):
    _, _, _, spans, notes = runs[call]
    assert len(notes) == len(spans)
    for s in spans:
        match = [(a, b) for n, a, b in notes if n == s.name]
        near = min(max(abs(s.start_ns - a), abs(s.end_ns - b))
                   for a, b in match)
        assert near < 100_000, (s.name, near)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
    return a == b


@pytest.mark.parametrize("call", ["solve", "step"])
def test_outputs_bit_identical_with_the_profiler(runs, call):
    plain, _, traced, _, _ = runs[call]
    la, lb = tree_leaves(plain), tree_leaves(traced)
    assert len(la) == len(lb) > 0
    assert all(_equal(a, b) for a, b in zip(la, lb))


def test_profile_slice_splits_whole_solves_by_their_spans():
    call = _solve_call()
    got = profile_slice.span_split(call, 2, "lm.solve")
    split = got["split"]
    assert got["calls"] == 2
    assert set(split) == {"lm.solve"} | set(PHASES)
    assert all(split[p]["spans"] == WCFG.iters for p in PHASES)
    assert split["lm.solve"]["spans"] == 1
    inside = sum(split[p]["host_ms"] for p in PHASES)
    assert 0 < inside < split["lm.solve"]["host_ms"]
    assert got["uncovered_share"] == pytest.approx(
        1 - inside / split["lm.solve"]["host_ms"])
    # no card: nothing busy, no sync, no launch
    assert all(r["device_busy_ms"] == r["syncs"] == r["profiler_syncs"]
               == r["launches"] == 0 for r in split.values())
    assert timing.recorded() == []


def test_syncs_counted_against_the_innermost_span():
    seen = []
    timing.reset_recorded()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda m, *a, **k: seen.append(str(m))
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span("outer"):
                warnings.warn(timing.SYNC_WARNING)
                with timing.span("inner"):
                    for _ in range(3):
                        warnings.warn(timing.SYNC_WARNING)
                warnings.warn("not a sync")
        # outside an outermost span the warning is shown again
        warnings.warn(timing.SYNC_WARNING)
    outer, inner = timing.recorded()
    timing.reset_recorded()
    assert (outer.name, outer.syncs, inner.name, inner.syncs) == \
        ("outer", 1, "inner", 3)
    assert seen == ["not a sync", timing.SYNC_WARNING]


def test_sync_sites_counted_by_line():
    timing.reset_recorded()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span("outer"):
                line = inspect.currentframe().f_lineno + 1
                warnings.warn(timing.SYNC_WARNING)
                with timing.span("inner"):
                    for _ in range(2):
                        warnings.warn(timing.SYNC_WARNING)
    here = __file__.replace(os.sep, "/")
    assert timing.sync_sites() == {f"{here}:{line}": 1,
                                   f"{here}:{line + 3}": 2}
    timing.reset_recorded()
    assert timing.sync_sites() == {}
