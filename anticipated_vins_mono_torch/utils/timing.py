"""Timing/tracing — TicToc parity + structured per-stage metrics.

Counterpart of `anticipated_vins_mono_tpu/utils/timing.py`. The reference
scopes everything with TicToc stopwatches and streams named samples to
`<name>.bin` for offline MATLAB analysis (tic_toc.h), plus aggregate
printStatistics (visualization.cpp).

Here: a `TicToc` context manager with the same named-binary-log behavior
(float64 seconds appended to <name>.bin — MATLAB `timing.m` compatible),
an aggregating registry, and `torch_profile`, a `torch.profiler` capture of
host and CUDA activity exported as a Chrome trace (the counterpart of the
JAX package's `jax_profile`).

`span(name)` names a stage of the estimator's step or a phase of the LM
solve. While no `torch.profiler` is recording it is one shared no-op
context: no allocation, no launch, no synchronisation. While one records,
it opens a `record_function` range of the same name (so the stage shows in
the exported trace) and keeps `(name, id, parent id, unit id, start, end,
syncs)` in memory, stamped on the clock of the profiler's events
(Unix-epoch nanoseconds), so that a reader can lay the spans over the
device's kernel intervals. The outermost span of a call starts a unit
(one frame, one solve); nested spans carry its id. While an outermost
span is open, every host synchronisation that torch's sync check sees
(`torch.cuda.set_sync_debug_mode`) is counted against the innermost open
span instead of being shown, and by the line that made it
(`sync_sites()`). `recorded()` returns the spans, `reset_recorded()`
clears them and the sites; nothing is written to disk.

`TicToc` times the host clock. Around asynchronous CUDA work it measures
the time to launch that work unless the caller synchronises the device
inside the timed block (the JAX version has the same property around
asynchronous dispatch); no synchronisation is added here.
"""

from __future__ import annotations

import contextlib
import functools
import os
import struct
import time
import warnings
from collections import Counter, defaultdict
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_STATS = defaultdict(lambda: [0, 0.0, 0.0])  # name -> [count, total, max]


class TicToc:
    """Host stopwatch; optionally streams each sample to `<dir>/<name>.bin`.

    with TicToc("fsel_cost", log_dir="timing"):
        ... work ...
    """

    def __init__(self, name: Optional[str] = None,
                 log_dir: Optional[str] = None):
        self.name = name
        self.log_dir = log_dir
        self.t0 = time.perf_counter()

    def tic(self):
        self.t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self.t0
        if self.name:
            s = _STATS[self.name]
            s[0] += 1
            s[1] += dt
            s[2] = max(s[2], dt)
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                with open(os.path.join(self.log_dir, f"{self.name}.bin"),
                          "ab") as f:
                    f.write(struct.pack("<d", dt))
        return dt

    def __enter__(self):
        self.tic()
        return self

    def __exit__(self, *exc):
        self.toc()
        return False


def stats() -> dict:
    """Aggregate timing table (printStatistics analog)."""
    return {k: {"count": v[0], "mean": v[1] / max(v[0], 1), "max": v[2]}
            for k, v in _STATS.items()}


def reset_stats():
    _STATS.clear()


def read_bin_log(path: str):
    """Read a `<name>.bin` sample stream (timing.m post-processing analog)."""
    import numpy as np
    raw = open(path, "rb").read()
    return np.frombuffer(raw, dtype="<f8")


@contextlib.contextmanager
def torch_profile(log_dir: str):
    """Capture host and CUDA activity of the block with `torch.profiler` and
    write it to `<log_dir>/trace.json` (Chrome trace format, viewable in
    chrome://tracing or Perfetto). CUDA activity is recorded only when a
    CUDA device is present. Yields the profiler, whose `key_averages()`
    tables the same events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# program spans and the host-sync counter
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span. `parent` is None for the outermost span of a call,
    whose `id` is the `unit` of every span nested in it; `start_ns` and
    `end_ns` are on the profiler's clock; `syncs` counts the host
    synchronisations made while this span was the innermost one open."""
    name: str
    id: int
    parent: Optional[int]
    unit: int
    start_ns: int
    end_ns: int
    syncs: int


# a sync site's file is named from this package's directory
_PACKAGE = "anticipated_vins_mono_torch/"
# torch's warning at a synchronising CUDA operation, in sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"

_NO_SPAN = contextlib.nullcontext()
_RECORDED: list = []     # Span, in order of opening; None while open
_OPEN: list = []         # the open _Span objects, innermost last
_SITES: Counter = Counter()   # "file:line" of each counted sync


def span(name: str):
    """A context naming one stage of the program (see the module's
    docstring): the shared no-op unless a profiler is recording."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return run
    return wrap


def recorded() -> list:
    """The spans recorded since the last `reset_recorded()` (a list of
    `Span`, in order of opening; spans still open are left out)."""
    return [s for s in _RECORDED if s is not None]


def sync_sites() -> dict:
    """{"file:line": count} of the host synchronisations counted since the
    last `reset_recorded()`; a file of this package is named from it."""
    return dict(_SITES)


def reset_recorded() -> None:
    """Forget the recorded spans and sync sites. Call it between units, not
    inside one."""
    _RECORDED.clear()
    _SITES.clear()


class _Span:
    __slots__ = ("name", "id", "parent", "unit", "syncs", "start", "range",
                 "counting")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        outer = _OPEN[-1] if _OPEN else None
        self.id = len(_RECORDED)
        _RECORDED.append(None)
        self.parent = outer.id if outer is not None else None
        self.unit = outer.unit if outer is not None else self.id
        self.syncs = 0
        self.counting = _SyncCount() if outer is None else None
        if self.counting is not None:
            self.counting.__enter__()
        _OPEN.append(self)
        # stamped outside the range, so that the span holds its annotation
        self.start = time.time_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        _OPEN.pop()
        if self.counting is not None:
            self.counting.__exit__(*exc)
        _RECORDED[self.id] = Span(self.name, self.id, self.parent, self.unit,
                                  self.start, end, self.syncs)
        return False


class _SyncCount:
    """While open, torch's sync check warns at each synchronising CUDA
    operation (where a CUDA device is present), and the warning is counted
    against the innermost open span instead of being shown. Other warnings
    pass through; the sync debug mode and the warning filters are restored
    on exit."""

    def __enter__(self):
        self.filters = warnings.catch_warnings()
        self.filters.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING) and _OPEN:
                _OPEN[-1].syncs += 1
                name = filename.replace(os.sep, "/").split(_PACKAGE)[-1]
                _SITES[f"{name}:{lineno}"] += 1
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = show
        # torch says once that the check is a prototype
        warnings.filterwarnings("ignore", message="Synchronization debug")
        self.mode = None
        if torch.cuda.is_available():
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.mode is not None:
            torch.cuda.set_sync_debug_mode(self.mode)
        self.filters.__exit__(*exc)
        return False
