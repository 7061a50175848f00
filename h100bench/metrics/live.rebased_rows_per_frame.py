"""live.rebased_rows_per_frame: the resident rows the streaming manager's
re-bases moved across the traced leg (``total_rebased_rows`` after it less
before it), per traced frame."""


def read(ctx):
    moved = (ctx.get("live_totals") or {}).get("total_rebased_rows")
    if moved is None or not ctx.get("units"):
        return None
    return moved / ctx["units"]
