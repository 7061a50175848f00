"""wave.idle_ms_per_frame: ms in which no device activity ran while a
``bm.wave`` span was open on the host (the host submitting the wave with
the device ahead of it), per traced frame.  A traced reading: every
operation under the profiler costs the host ~10 us more than untraced."""
from h100bench import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, "bm.wave")
