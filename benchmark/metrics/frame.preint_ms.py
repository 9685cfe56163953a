"""Host milliseconds per traced frame inside the IMU preintegration
(`preint` spans: the window's measurements, and the marginalization's on a
keyframe)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "vio.step", "preint")
