"""Share of the traced frames with td estimated in which no operation ran
on the card: 100 × (1 − union of the device's kernel, copy and set
intervals / window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return ctx.trace.idle_pct
