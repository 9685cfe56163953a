"""Share of the roofline of the normal equations' kernel that estimates the
time offset over the traced frames: the least time of a launch at B = 1,
D = 178, F = 128 (`work_window.ne_td_work`, at the published peaks of
`work.least_seconds`) over the device time the trace gives its launches.
None where no such kernel ran."""

from benchmark import work, work_window

KERNEL = "normal_eq_fused_td"


def read(ctx):
    if ctx.trace is None:
        return None
    times = [d for name, _, d in ctx.trace.kernels if KERNEL in name]
    if not times:
        return None
    least = work.least_seconds(*work_window.ne_td_work(
        1, ctx.config["WINDOW_SIZE"], ctx.config["max_feats"]))
    return 100.0 * least * len(times) / (sum(times) * 1e-9)
