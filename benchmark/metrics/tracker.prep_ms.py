"""Host milliseconds per traced frame in CLAHE and the pyramid
(`track.prep`)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "track.step", "track.prep")
