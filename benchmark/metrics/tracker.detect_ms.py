"""Host milliseconds per traced frame in the top-up detection
(`track.detect`: the occupancy, the GFTT response, the NMS and the sort of
every pixel's score)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "track.step", "track.detect")
