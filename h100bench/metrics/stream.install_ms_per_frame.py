"""stream.install_ms_per_frame: the device ms of the kernels whose launch
call began inside the program's ``bm.stream.install`` spans (the scatters
of index words and payloads, and the re-base inside it when a segment
grew), per traced frame.  The count of kernels changes with growth, so
every span's kernels are read (no test of equal counts)."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None or not ctx.get("acts"):
        return None
    kernels = spans.attributed_kernels(ctx["prof"], "bm.stream.install")
    if not kernels:
        return None
    return spans.per_unit(ctx, sum(us for _, us in kernels) / 1e3)
