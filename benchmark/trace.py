"""Reduction of a `torch.profiler` trace to what the per-layer readers need.

The benchmark brackets each traced unit of work (a frame, a solve) in a
span of its own (`torch.profiler.record_function("bench.<unit>")`). From the
profiler's events `Trace.from_profile` keeps:

- the traced window: from the first bench span's start to the last one's
  end, in the profiler's clock;
- the device's operations (kernels, copies, sets) and the union of their
  intervals inside the window, `busy_s`;
- the launch calls the host made (CUDA runtime or low-level API calls that launch a
  kernel or a graph), `launches`;
- the longest idle gaps of the device, each named by the innermost host
  operation that was running at its middle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SPAN_PREFIX = "bench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    spans: int                 # bench spans in the window
    launches: int              # host launch calls in the window
    kernels: list              # (name, start_ns, duration_ns) in the window
    device_ops: list           # [name, seconds] most time first, ≤ 10
    idle_gaps: list            # [host op, seconds] longest first, ≤ 10

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    @staticmethod
    def from_events(events) -> "Trace":
        """`events`: (activity kind, name, start_ns, duration_ns) tuples."""
        spans = [(s, s + d) for k, n, s, d in events
                 if k == "user_annotation" and n.startswith(SPAN_PREFIX)]
        if not spans:
            raise ValueError("the trace holds no bench span")
        lo = min(s for s, _ in spans)
        hi = max(e for _, e in spans)
        dev = [(n, max(s, lo), min(s + d, hi)) for k, n, s, d in events
               if k in DEVICE_KINDS and s + d > lo and s < hi]
        kernels = [(n, s, d) for k, n, s, d in events
                   if k == "kernel" and lo <= s < hi]
        launches = sum(1 for k, n, s, d in events
                       if k in ("cuda_runtime", "cuda_driver")
                       and n in LAUNCH_NAMES and lo <= s < hi)
        # union of the device intervals, and the gaps between them
        busy, gaps, end = 0, [], lo
        for _, s, e in sorted(dev, key=lambda x: x[1]):
            if s > end:
                gaps.append((end, s))
            if e > end:
                busy += e - max(s, end)
                end = e
        if hi > end:
            gaps.append((end, hi))
        by_name: dict = {}
        for n, s, e in dev:
            by_name[n] = by_name.get(n, 0) + (e - s)
        device_ops = [[n, t * 1e-9] for n, t in
                      sorted(by_name.items(), key=lambda x: -x[1])[:10]]
        host = [(n, s, s + d) for k, n, s, d in events if k in HOST_KINDS]
        hs = np.array([s for _, s, _ in host], dtype=np.int64)
        he = np.array([e for _, _, e in host], dtype=np.int64)
        idle = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (s + e) // 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0] if len(hs) \
                else np.zeros(0, dtype=np.int64)
            name = host[cover[np.argmax(hs[cover])]][0] if len(cover) \
                else "(no host operation)"
            idle.append([name, (e - s) * 1e-9])
        return Trace(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                     spans=len(spans), launches=launches, kernels=kernels,
                     device_ops=device_ops, idle_gaps=idle)

    @staticmethod
    def from_profile(prof) -> "Trace":
        return Trace.from_events(
            [(_kind(e), e.name(), e.start_ns(), e.duration_ns())
             for e in prof.profiler.kineto_results.events()])


def _kind(e) -> str:
    """The activity kind of a profiler event, as the chrome trace's `cat`
    names it. Older releases of PyTorch have no `activity_type`; there the
    kind follows from the device, the annotation flag and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    annotation = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                  else False) or name.startswith(SPAN_PREFIX)
    if str(e.device_type()).endswith("CUDA"):
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    if name.startswith("cuda"):
        return "cuda_runtime"
    if name.startswith("cu"):
        return "cuda_driver"
    return "cpu_op"


def profiler(active: int):
    """A profiler of the host and the card whose first step is a warm-up and
    whose next `active` steps are kept; call `.step()` after each unit."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   schedule=schedule(wait=0, warmup=1, active=active,
                                     repeat=1))
