"""pack_field.ms_per_step: device ms of the kernels launched inside the
program's ``bm.sparse.pack_field`` span (``diff/sparse.py::_pack_field``),
per traced step."""
from h100bench import spans


def read(ctx):
    if ctx.get("prof") is None:
        return None
    kernels = spans.whole_kernels(ctx["prof"], "bm.sparse.pack_field")
    us = sum(d for _, d in kernels)
    return spans.per_unit(ctx, us / 1e3 if us > 0 else None)
