"""stream.plan_ms_per_frame: the host's ms inside the program's
``bm.stream.plan`` spans (dedupe, cap, slots, segment growth and the
payloads from the truth), per traced frame."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None:
        return None
    got = spans.host_intervals(ctx["prof"], "bm.stream.plan")
    return spans.per_unit(ctx, spans.length(got) / 1e3) if got else None
