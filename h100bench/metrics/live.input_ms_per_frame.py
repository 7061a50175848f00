"""live.input_ms_per_frame: the host's ms inside the program's
``bm.live.input`` spans (the fly-camera step, the new camera's arrays on
the card and the fresh film), per traced frame."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None:
        return None
    got = spans.host_intervals(ctx["prof"], "bm.live.input")
    return spans.per_unit(ctx, spans.length(got) / 1e3) if got else None
