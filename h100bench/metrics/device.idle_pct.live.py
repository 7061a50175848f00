"""device.idle_pct.live: the share of the traced leg's window in which no
device activity ran, in % (100 - the union of activity ranges)."""
from h100bench import yardstick


def read(ctx):
    return yardstick.idle_pct(ctx) if ctx.get("loop") == "live" else None
