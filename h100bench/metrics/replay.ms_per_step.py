"""replay.ms_per_step: device ms of R1, B4f, R2 and B4b
(``segment_geom_kernel``, ``extract_fwd_kernel``, ``composite_kernel``,
``extract_bwd_kernel``) per traced step."""
from h100bench import yardstick


def read(ctx):
    return yardstick.ms_per_unit(ctx, yardstick.REPLAY_KERNELS)
