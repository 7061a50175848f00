"""replay.roofline_pct: the least time of R1, B4f, R2 and B4b over a
step's slices (yardstick.replay_bounds_s over the reference's segments and
visited voxels) over their device time per traced step, in %."""
from h100bench import yardstick


def read(ctx):
    pct = yardstick.roofline_pct(ctx, yardstick.REPLAY_KERNELS,
                                 ("R1", "B4f", "R2", "B4b"))
    return None if pct is None else pct * ctx["units"]
