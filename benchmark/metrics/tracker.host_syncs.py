"""Host synchronisations per traced frame of `tracker_step`: the port's
sync counter (torch's check at each synchronising CUDA operation) over the
frame's spans; the runner's own synchronise after the frame is outside
them."""

from benchmark import spans


def read(ctx):
    return spans.syncs_per_unit(ctx, "track.step")
