"""Launch calls the host made per LM iteration of the traced batched
`lm_solve`s (as `frame.launches`, over solves × iterations)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans:
        return None
    return ctx.trace.launches / (ctx.trace.spans * ctx.counters["iters"])
