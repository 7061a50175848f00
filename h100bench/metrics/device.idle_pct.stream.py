"""device.idle_pct.stream: the share of the traced cycle's window (a reset
and its frames) in which no device activity ran, in % (100 - the union of
activity ranges)."""
from h100bench import yardstick


def read(ctx):
    return yardstick.idle_pct(ctx) if ctx.get("loop") == "stream" else None
