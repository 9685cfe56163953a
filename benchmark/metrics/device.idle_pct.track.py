"""Share of the traced tracker frames in which no operation ran on the
card: 100 × (1 − union of the device's kernel, copy and set intervals /
window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return ctx.trace.idle_pct
