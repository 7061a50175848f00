"""step.sync_wait_ms: the host's ms inside the program's ``bm.sync.*``
spans (each a host read of a device value, which waits for the work queued
before it), per traced step."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None:
        return None
    syncs = spans.host_intervals(ctx["prof"], prefix="bm.sync.")
    if not syncs:
        return None
    return spans.per_unit(ctx, spans.length(syncs) / 1e3)
