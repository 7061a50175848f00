"""b2.ms_per_frame: kernel B2's (``traverse_kernel``) device ms per
traced frame."""
from h100bench import yardstick


def read(ctx):
    return yardstick.ms_per_unit(ctx, yardstick.B2_KERNELS)
