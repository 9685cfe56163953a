"""Launch calls the host made per traced frame of `vio_step` with td
estimated: CUDA runtime and low-level API calls that launch a kernel or a
graph, from the profiler's host activity (`trace.LAUNCH_NAMES`)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans:
        return None
    return ctx.trace.launches / ctx.trace.spans
