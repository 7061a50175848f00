"""adam.ms_per_step: device ms of the kernels launched inside the
benchmark's span around ``adam_step`` (update and clip), per traced
step."""
from h100bench import yardstick


def read(ctx):
    if ctx.get("prof") is None or not ctx.get("units"):
        return None
    s = yardstick.span_device_seconds(ctx["prof"],
                                      yardstick.SPAN_PREFIX + "adam")
    return s / ctx["units"] * 1e3 if s > 0 else None
