"""blit.roofline_pct: W5's least time over its device time, in %: each
``blit_kernel`` of the traced frames bound by the bytes the reference's
presentation of the cell's pixels moves (``reference/live.py::
present_bytes``: 16 B read and 3 B written a pixel) over the HBM
bandwidth."""
import re

from h100bench import yardstick
from h100bench.reference import live as rlive

KERNELS = ("blit_kernel",)
# A kernel's name as the profiler gives it holds its __global__ name as a
# word (yardstick.kernel_seconds reads it so).
NAME = re.compile(r"\bblit_kernel\b")


def read(ctx):
    acts, pixels = ctx.get("acts"), ctx.get("live_pixels")
    if not acts or not pixels:
        return None
    seconds = yardstick.kernel_seconds(acts, KERNELS)
    launches = sum(1 for n, _, _ in acts if NAME.search(n))
    if seconds <= 0 or not launches:
        return None
    bound = launches * yardstick.bound_s(rlive.present_bytes(pixels), 0)
    return 100.0 * bound / seconds
