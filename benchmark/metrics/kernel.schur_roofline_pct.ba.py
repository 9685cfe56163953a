"""Share of the fused Schur kernel's roofline over the traced solves: the
least time of a launch over the batch (`work.schur_work(D, F)` × B, at the
published peaks) over the device time the trace gives its launches."""

from benchmark import work

KERNEL = "schur_solve_fused_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    times = [d for name, _, d in ctx.trace.kernels if KERNEL in name]
    if not times:
        return None
    nf = ctx.config["window"] + 1
    D, F = 15 * nf + 13, ctx.config["max_feats"]
    floats, flops = work.schur_work(D, F)
    B = ctx.traffic["batch"]
    least = work.least_seconds(B * floats * 4, B * flops)
    return 100.0 * least * len(times) / (sum(times) * 1e-9)
