"""b2.roofline_pct: B2's least time on the traced frames' rays (bytes
bound: 80 B a ray, 4 B a distinct index word, 64 B a distinct brick row,
counted by the reference's trace of the same rays) over its device time,
in %."""
from h100bench import yardstick


def read(ctx):
    return yardstick.roofline_pct(ctx, yardstick.B2_KERNELS, ("B2",))
