"""stream.pull_ms_per_frame: the host's ms inside the program's
``bm.stream.pull`` spans (the whole of ``pull_requests``: the compaction's
launches, the device-to-host copy under ``bm.sync.pull_requests`` and the
host's list), per traced frame."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None:
        return None
    got = spans.host_intervals(ctx["prof"], "bm.stream.pull")
    return spans.per_unit(ctx, spans.length(got) / 1e3) if got else None
