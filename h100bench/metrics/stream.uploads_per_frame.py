"""stream.uploads_per_frame: the streaming manager's ``total_uploaded``
over the traced cycle (a reset clears it at the cycle's start), per traced
frame."""


def read(ctx):
    uploaded = (ctx.get("stream_totals") or {}).get("total_uploaded")
    if uploaded is None or not ctx.get("units"):
        return None
    return uploaded / ctx["units"]
