"""wave.host_us_per_launch: the host's us inside the program's ``bm.wave``
spans over the device kernels launched inside them (what submitting a
wave costs the host a kernel).  A traced reading: every operation under
the profiler costs the host ~10 us more than untraced."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None or not ctx.get("acts"):
        return None
    kernels = spans.whole_kernels(ctx["prof"], "bm.wave")
    if not kernels:
        return None
    host = spans.length(spans.host_intervals(ctx["prof"], "bm.wave"))
    return host / len(kernels)
