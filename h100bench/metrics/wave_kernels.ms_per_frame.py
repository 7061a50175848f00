"""wave_kernels.ms_per_frame: device ms of kernels W0-W4 (compaction,
primary rays, gather + clip, shade, rescue) per traced frame."""
from h100bench import yardstick


def read(ctx):
    return yardstick.ms_per_unit(ctx, yardstick.WAVE_KERNELS)
