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

`TicToc` times the host clock. Around asynchronous CUDA work it measures
the time to launch that work unless the caller synchronises the device
inside the timed block (the JAX version has the same property around
asynchronous dispatch); no synchronisation is added here.
"""

from __future__ import annotations

import contextlib
import os
import struct
import time
from collections import defaultdict
from typing import Optional

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
