"""Host milliseconds per traced frame in the pyramidal LK (`track.lk`)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "track.step", "track.lk")
