"""wave.launches_per_frame: device kernels launched inside the program's
``bm.wave`` spans (``render/pathtrace.py::_wave``), per traced frame.  The
device's own record of each kernel, so a replayed CUDA graph's kernels
count as well as launches from Python."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None:
        return None
    kernels = spans.whole_kernels(ctx["prof"], "bm.wave")
    return spans.per_unit(ctx, len(kernels) or None)
