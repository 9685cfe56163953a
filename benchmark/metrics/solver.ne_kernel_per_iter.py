"""Launches of the normal equations' kernel (trace kernels whose name holds
`normal_eq_fused`) per LM iteration of the traced batched `lm_solve`s: 1
where each iteration's normal equations are one launch, 0 where the program
builds them otherwise."""

KERNEL = "normal_eq_fused"


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans:
        return None
    n = sum(1 for name, _, _ in ctx.trace.kernels if KERNEL in name)
    return n / (ctx.trace.spans * ctx.counters["iters"])
