"""live.present_ms_per_frame: the host's ms inside the program's
``bm.live.present`` spans (W5's launch, the 8-bit frame's copy to the host,
which waits for the frame's device work, and the hand-off to the preview
server), per traced frame."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None:
        return None
    got = spans.host_intervals(ctx["prof"], "bm.live.present")
    return spans.per_unit(ctx, spans.length(got) / 1e3) if got else None
