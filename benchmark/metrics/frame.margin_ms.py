"""Host milliseconds per traced frame in the marginalization and slide
(`vio.margin`: the oldest frame's on a keyframe, the second-newest's
otherwise)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "vio.step", "vio.margin")
