"""Host milliseconds per traced frame in the window's LM solve
(`vio.solve`), with td estimated and the rolling shutter compensated."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "vio.step", "vio.solve")
