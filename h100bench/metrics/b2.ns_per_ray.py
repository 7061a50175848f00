"""b2.ns_per_ray: B2's (``traverse_kernel``) device ns over the rays the
traced frames' traces handed it (the program's ``wave.trace_rays`` counts,
W0's count of each trace)."""
from h100bench import spans, yardstick


def read(ctx):
    if not ctx.get("acts") or not spans.whole_kernels(ctx["prof"], "bm.wave"):
        return None
    rays = sum(spans.port_counts(ctx).get("wave.trace_rays", []))
    s = yardstick.kernel_seconds(ctx["acts"], yardstick.B2_KERNELS)
    return s * 1e9 / rays if rays and s > 0 else None
