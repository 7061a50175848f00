"""Reading the program's own spans and counts in a profile.

The program names its host phases ``bm.<layer>[.<phase>]`` with
``record_function`` ranges and keeps counts while a profiler records
(``brickmap_tpu_torch/utils/profiling.py``).  Those ranges sit on the
profiler's clock, as its device activities do, so a device-idle stretch can
be put down to the span open above it, and a kernel to the span its launch
was made in.  Times are the profiler's microseconds, unshifted, as
``yardstick.py`` reads them.  A reader finds nothing, and its metric
returns None, on a profile without device activity (the CPU) or without
the program's spans or counts (a program that records none), and on one
that is not sound: a traced frame or step whose span holds fewer kernels
than another's (the profile lost device activity), or, for a reader that
sets device times against host times, device times that run ahead of
their launch calls by more than ``OFFSET_LIMIT_US``.
"""

from __future__ import annotations

import bisect

from . import yardstick

__all__ = ["union", "length", "overlap", "idle_within", "host_intervals",
           "attributed_kernels", "kernels_per_span", "whole_kernels",
           "device_offset_us", "idle_ms_per_unit", "port_counts",
           "per_unit"]

# Device activities that are copies or fills, not kernel launches.
NOT_KERNELS = ("Memcpy", "Memset")
# The CUDA runtime and driver calls that launch kernels.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
# The most, in us, by which the device's times may run ahead of the host's
# for a reader that sets one against the other: sound runs on an H100 read
# 0-27 us, and the one run that read 5.12 ms had also lost a step's kernels.
OFFSET_LIMIT_US = 100.0


def union(intervals) -> list:
    """The sorted, disjoint union of (start, end) intervals: nested or
    overlapping spans counted once."""
    out: list = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def length(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def overlap(xs, ys) -> float:
    """The length of the intersection of two sets of intervals."""
    xs, ys = union(xs), union(ys)
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def idle_within(spans, busy) -> float:
    """How long the device was idle (no interval of ``busy`` running)
    while one of ``spans`` was open on the host."""
    return length(spans) - overlap(spans, busy)


def host_intervals(prof, name: str | None = None,
                   prefix: str | None = None) -> list:
    """(start, end) of each host range named ``name`` (or whose name starts
    with ``prefix``)."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU
            and (e.name == name if name is not None
                 else e.name.startswith(prefix))]


def _launches(prof):
    """{correlation id: host start} of the launch calls, and the device
    kernels (no copies, fills or images of host ranges)."""
    from torch.autograd import DeviceType

    host = yardstick._annotations(prof)
    calls, kernels = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS:
            calls[e.id] = e.time_range.start
        elif (e.device_type == DeviceType.CUDA and e.name not in host
              and not e.name.startswith(NOT_KERNELS)
              and not getattr(e, "is_user_annotation", False)):
            kernels.append(e)
    return calls, kernels


def _attributed(prof, name: str) -> tuple:
    """The union of the ranges named ``name``, and (range index, kernel
    name, device us) of each kernel launched inside one of them."""
    inside = union(host_intervals(prof, name))
    if not inside:
        return inside, []
    calls, kernels = _launches(prof)
    starts = [a for a, _ in inside]
    out = []
    for k in kernels:
        t = calls.get(k.id)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < inside[i][1]:
            out.append((i, k.name, k.time_range.end - k.time_range.start))
    return inside, out


def attributed_kernels(prof, name: str) -> list:
    """(kernel name, device us) of every kernel whose launch call (the CUDA
    runtime's ``cudaLaunchKernel`` and kin, paired with the kernel by the
    profiler's correlation id) began on the host inside a range named
    ``name``.  The launch call's time places it, not the profiler's own tie
    of a kernel to a torch operation, which the program's ctypes launches
    (made inside no operation) lack.  A graph launch's kernels share its
    call.  Copies, fills and the device-side images of host ranges are left
    out."""
    return [(k, d) for _, k, d in _attributed(prof, name)[1]]


def kernels_per_span(prof, name: str) -> list:
    """How many kernels were launched inside each range named ``name``
    (nested or overlapping ranges taken as one), in time order."""
    inside, kernels = _attributed(prof, name)
    counts = [0] * len(inside)
    for i, _, _ in kernels:
        counts[i] += 1
    return counts


def whole_kernels(prof, name: str) -> list:
    """:func:`attributed_kernels`, or [] where some range named ``name``
    holds fewer kernels than another: the profile lost device activity of
    a traced frame or step, and every reading of it would be short."""
    counts = kernels_per_span(prof, name)
    if not counts or min(counts) != max(counts):
        return []
    return attributed_kernels(prof, name)


def device_offset_us(prof) -> float:
    """The least shift, in us, that puts every kernel's start at or after
    its launch call's start: 0 where the profile's two clocks agree.  The
    profiler converts the device's timestamps onto the host's clock, and on
    an H100 host that conversion was seen to leave the device's times early
    by 7 us to 5.1 ms, as the device-to-host copy of a read also showed
    (its end 5.1 ms before the host call waiting on it returned).  A device
    clock running late is not seen this way."""
    calls, kernels = _launches(prof)
    early = [calls[k.id] - k.time_range.start for k in kernels
             if k.id in calls]
    return max([0.0] + early)


def idle_ms_per_unit(ctx: dict, name: str) -> float | None:
    """ms in which no device activity of ``ctx["acts"]`` ran while a range
    named ``name`` was open on the host, per traced frame or step; None
    where the profile is not sound (:func:`whole_kernels`,
    ``OFFSET_LIMIT_US``) or holds no such range."""
    prof = ctx.get("prof")
    if prof is None or not ctx.get("acts") \
            or not whole_kernels(prof, name) \
            or device_offset_us(prof) > OFFSET_LIMIT_US:
        return None
    busy = [(a, b) for _, a, b in ctx["acts"]]
    return per_unit(ctx, idle_within(host_intervals(prof, name), busy) / 1e3)


def port_counts(ctx: dict) -> dict:
    """The program's counts of the traced sub-window
    (``profiling.take_counts()``), read once and kept in ``ctx``; empty
    where the program keeps none."""
    if "port_counts" not in ctx:
        from brickmap_tpu_torch.utils import profiling

        take = getattr(profiling, "take_counts", None)
        ctx["port_counts"] = take() if take is not None else {}
    return ctx["port_counts"]


def per_unit(ctx: dict, value) -> float | None:
    """``value`` per traced frame or step; None without device activity,
    units or a value."""
    if not ctx.get("acts") or not ctx.get("units") or value is None:
        return None
    return value / ctx["units"]
