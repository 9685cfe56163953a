"""Launches of the cost phase's kernel that estimates the time offset
(trace kernels whose name holds `lm_cost_fused_td`) per LM iteration of the
traced frames' window solves (one solve of `max_num_iterations` a frame):
1.25 where each iteration's cost phase is one launch and the solve's cost
at the start and diagnostics at the end one each ((8 + 2) / 8), 0 where
the program takes the cost phase otherwise."""

KERNEL = "lm_cost_fused_td"


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans:
        return None
    n = sum(1 for name, _, _ in ctx.trace.kernels if KERNEL in name)
    return n / (ctx.trace.spans * ctx.config["max_num_iterations"])
