"""Host milliseconds per traced frame in the anticipation gate
(`vio.select`)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "vio.step", "vio.select")
