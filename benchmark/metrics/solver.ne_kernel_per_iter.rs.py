"""Launches of the normal equations' kernel that estimates the time offset
(trace kernels whose name holds `normal_eq_fused_td`) per LM iteration of
the traced frames' window solves (one solve of `max_num_iterations` a
frame): 1 where each iteration's normal equations are one launch of it, 0
where the program builds them otherwise."""

KERNEL = "normal_eq_fused_td"


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans:
        return None
    n = sum(1 for name, _, _ in ctx.trace.kernels if KERNEL in name)
    return n / (ctx.trace.spans * ctx.config["max_num_iterations"])
