"""The port's program spans over the traced units, for the per-layer
readers.

The port records a span around each stage of its per-frame step and each
phase of its LM solve while a profiler records
(`anticipated_vins_mono_torch.utils.timing.recorded()`): name, id, parent,
unit (the id of the outermost span: `vio.step` for a frame, `lm.solve` for
a solve), start and end on the profiler's clock, and the host
synchronisations counted while the span was the innermost one open. A
reader takes the spans only where the recorder saw exactly the traced
units: as many outermost spans of the unit's name as the trace has bench
spans. Where the port records no spans, nothing is read.
"""

from __future__ import annotations


def units(ctx, top: str):
    """(outermost spans named `top`, every span of their units), or None
    where the port has no recorder or its units are not the trace's."""
    if ctx.trace is None or not ctx.trace.spans:
        return None
    try:
        from anticipated_vins_mono_torch.utils.timing import recorded
    except ImportError:
        return None
    spans = recorded()
    outer = [s for s in spans if s.parent is None and s.name == top]
    if len(outer) != ctx.trace.spans:
        return None
    ids = {s.id for s in outer}
    return outer, [s for s in spans if s.unit in ids]


def ms_per_unit(ctx, top: str, name: str):
    """Host milliseconds of the spans named `name`, summed, per unit."""
    got = units(ctx, top)
    if got is None:
        return None
    outer, spans = got
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == name) * 1e-6 / len(outer)


def ms_per_iter(ctx, name: str):
    """As `ms_per_unit` over the solves' LM iterations."""
    per_solve = ms_per_unit(ctx, "lm.solve", name)
    if per_solve is None:
        return None
    return per_solve / ctx.counters["iters"]


def syncs_per_unit(ctx, top: str):
    """Host synchronisations counted in the units, per unit."""
    got = units(ctx, top)
    if got is None:
        return None
    outer, spans = got
    return sum(s.syncs for s in spans) / len(outer)


def idle_pct(ctx, top: str, name: str):
    """100 × (1 − the time the union of the trace's kernel intervals
    covers inside the spans named `name` / those spans' time); None where
    the trace holds no kernel."""
    got = units(ctx, top)
    if got is None or not ctx.trace.kernels:
        return None
    windows = sorted((s.start_ns, s.end_ns) for s in got[1] if s.name == name)
    total = sum(e - s for s, e in windows)
    if total <= 0:
        return None
    kernels = sorted((s, s + d) for _, s, d in ctx.trace.kernels)
    busy, k = 0, 0
    for lo, hi in windows:
        # the union of the kernel intervals clipped to [lo, hi]
        while k < len(kernels) and kernels[k][1] <= lo:
            k += 1
        end = lo
        for s, e in kernels[k:]:
            if s >= hi:
                break
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
    return 100.0 * (1.0 - busy / total)
