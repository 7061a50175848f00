"""wave_kernels.roofline_pct: the least time of W0-W4 on the traced
frames (yardstick.wave_bounds_s over the reference's lanes and traces)
over their device time, in %."""
from h100bench import yardstick


def read(ctx):
    return yardstick.roofline_pct(ctx, yardstick.WAVE_KERNELS,
                                  ("W0", "W1", "W2", "W3", "W4"))
