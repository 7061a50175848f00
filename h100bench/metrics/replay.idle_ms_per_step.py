"""replay.idle_ms_per_step: ms in which no device activity ran while the
program's ``bm.sparse.slices`` span (the loop that submits the replay's
slices) was open on the host, per traced step.  A traced reading: every
operation under the profiler costs the host ~10 us more than untraced."""
from h100bench import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, "bm.sparse.slices")
