"""The yardstick: the card's peaks, the least bytes and operations each
kernel's inputs need, and the reading of a profile.

Frozen copies of ``chip_smoke.py``'s arithmetic (``bound``, ``b2_bound``,
``wave_bytes``, the W0/W4 and R1/R2/B4f/B4b counts, ``device_busy``), so
that a later change to the program cannot move the yardstick.  Each count
is what these inputs need, each input byte read once and each output byte
written once, whatever a kernel reads again; the counts come from the
reference's own work on the same inputs.
"""

from __future__ import annotations

import math
import re

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "bound_s", "b2_bound_s",
           "wave_bounds_s", "replay_bounds_s", "slice_counts",
           "percentile", "idle_pct", "ms_per_unit", "roofline_pct",
           "device_activity", "busy_s", "kernel_seconds",
           "span_device_seconds", "breakdown"]

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# A DDA step's least operations: axis select (4), t and cell updates (2),
# the exit test (1) and the occupancy test (5).
DDA_STEP_OPS = 12
# Least float operations a lane of W1 / a ray of W2 / a lane of W3 does.
W_OPS = {"W1": 70, "W2": 60, "W3": 300}
# R1: a valid segment's slot, entry, DDA set-up and 3 x 22 searched steps
# (1,654), and a crossing's rank on each axis the ray moves along (22).
# R2: a valid step's forward (12) and backward (19) operations.
R1_OPS, R1_RANK_OPS, R2_STEP_OPS = 1654, 22, 31
NVOX = 22
# The __global__ names of the kernels each group's metrics read.
B2_KERNELS = ("traverse_kernel",)
WAVE_KERNELS = ("compact_kernel", "primary_kernel", "gather_clip_kernel",
                "shade_kernel", "rescue_kernel")
REPLAY_KERNELS = ("segment_geom_kernel", "composite_kernel",
                  "extract_fwd_kernel", "extract_bwd_kernel")


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds: the larger of bytes over the HBM bandwidth and
    operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def b2_bound_s(trace: dict) -> float:
    """B2 over one trace's rays: per ray 41 B in (origin, direction, entry
    normal, tmin, ok) and 39 B out (hit, request, exhausted, t, resume_t,
    normal, request_pos, steps), each distinct index word (4 B) and brick
    row (64 B) once; DDA_STEP_OPS a step."""
    nbytes = trace["rays"] * 80 + 4 * trace["b2_words"] \
        + 64 * trace["b2_rows"]
    return bound_s(nbytes, trace["b2_steps"] * DDA_STEP_OPS)


def wave_bounds_s(lanes: int, traces: list) -> dict:
    """The least seconds of each wave kernel over one wave of ``lanes``
    lanes whose traces the reference counted (``traces``: the 5 traces of
    3 bounces + the final shadow trace, in order).

    W1 a lane: idx, stratum (8 B each), jitter, lens (8 each) read; both
    ray rows (48), live (2), the position map (8), accum, sh_color (24),
    request mask (1) and position (12) written.  W0 a compaction: 1 B a row
    read and 4 B a set row written (plus the 4-byte count).  W2 a ray: its
    lane (4) and ray (24) read, B2's five inputs (41) and its row (4)
    written.  W3 a bounce: per lane 79 B read and 95 B written, per live
    ray its row and B2's results (35); the final pass 55 + 37 B a lane and
    35 a live ray.  W4: 71 B a rescued ray, each distinct index word and
    brick row its passes read, 12 operations a step, at the least the
    4-byte count."""
    out = {"W1": bound_s(lanes * 127, lanes * W_OPS["W1"]),
           "W0": 0.0, "W2": 0.0, "W3": 0.0, "W4": 0.0}
    last = len(traces) - 1
    for i, t in enumerate(traces):
        out["W0"] += bound_s(t["rows"] + 4 * t["rays"] + 4, 0)
        out["W0"] += bound_s(t["rays"] + 4 * t["exhausted"] + 4, 0)
        out["W2"] += bound_s(t["rays"] * 73, t["rays"] * W_OPS["W2"])
        per_lane = 92 if i == last else 174
        out["W3"] += bound_s(lanes * per_lane + t["rays"] * 35,
                             lanes * W_OPS["W3"])
        out["W4"] += bound_s(max(t["exhausted"] * 71 + 4 * t["w4_words"]
                                 + 64 * t["w4_rows"], 4),
                             t["w4_steps"] * DDA_STEP_OPS)
    return out


def slice_counts(cells, direction, lin2) -> dict:
    """What one replay slice's bounds need, from the reference's own
    segments (``cells`` [C, K], ``direction`` [C, 3]) and R1's visited
    voxels (``lin2`` [C*K, NVOX], -1 where a step is not valid)."""
    import torch

    c, k = cells.shape
    ok = cells >= 0
    return {"rays": c, "segments": c * k,
            "valid_segments": int(ok.sum()),
            "moving": int((ok * (direction != 0).sum(1, keepdim=True)).sum()),
            "cell_words": int(torch.unique(cells[ok]).shape[0]),
            "valid_steps": int((lin2 >= 0).sum())}


def replay_bounds_s(slices: list) -> dict:
    """The least seconds of R1, B4f, R2 and B4b over a step's slices.

    R1: per ray its origin, direction and entry normal (36 B), per segment
    its cell, nd and ncode (12) and slot and voxel ids written (4 + 4 NVOX),
    each distinct cellmap word (4); R1_OPS a valid segment, R1_RANK_OPS a
    rank.  B4f: slots and ids read (4 + 4 NVOX a segment), 16 B a valid
    voxel read, 16 B an entry written.  R2: values read and cotangents
    written (32 B an entry), ids (4), background and target (24 B a ray)
    and the SSE (4); R2_STEP_OPS a valid step.  B4b: slots, ids and
    cotangents read, a 16-byte read-modify-write a valid voxel (32 B, 4
    adds)."""
    out = {"R1": 0.0, "B4f": 0.0, "R2": 0.0, "B4b": 0.0}
    for s in slices:
        cs, c, valid = s["segments"], s["rays"], s["valid_steps"]
        entries = cs * NVOX
        out["R1"] += bound_s(
            36 * c + 12 * cs + 4 * s["cell_words"] + (4 + 4 * NVOX) * cs,
            R1_OPS * s["valid_segments"]
            + R1_RANK_OPS * (NVOX - 1) * s["moving"])
        out["B4f"] += bound_s(4 * cs + 4 * entries + 16 * valid
                              + 16 * entries, 0)
        out["R2"] += bound_s(36 * entries + 28 * c, R2_STEP_OPS * valid)
        out["B4b"] += bound_s(4 * cs + 4 * entries + 16 * entries
                              + 32 * valid, 4 * valid)
    return out


def idle_pct(ctx: dict):
    """100 - the device's busy share of the traced sub-window, in %."""
    if not ctx.get("window_s") or not ctx.get("acts"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def ms_per_unit(ctx: dict, names) -> float | None:
    """Device ms of the kernels ``names`` per frame or step profiled."""
    if not ctx.get("acts") or not ctx.get("units"):
        return None
    s = kernel_seconds(ctx["acts"], names)
    return s / ctx["units"] * 1e3 if s > 0 else None


def roofline_pct(ctx: dict, names, groups) -> float | None:
    """The least time of the kernel groups ``groups`` (from the
    reference's counts) over the device time of the kernels ``names``, in
    %.  Nothing to read without counts or device time."""
    bounds = ctx.get("bounds")
    if not bounds or not ctx.get("acts"):
        return None
    s = kernel_seconds(ctx["acts"], names)
    if s <= 0:
        return None
    return 100.0 * sum(bounds[g] for g in groups) / s


def percentile(values: list, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


# ---- reading a torch.profiler profile -------------------------------------

SPAN_PREFIX = "h100bench."


def _annotations(prof) -> set:
    """Names of the host's ``record_function`` spans (the benchmark's and
    the program's own, such as ``Optimizer.step#Adam.step``): the profiler
    also lays each over the device's timeline, where it is no work."""
    from torch.autograd import DeviceType

    return {e.name for e in prof.events() if e.device_type == DeviceType.CPU}


def device_activity(prof) -> list:
    """(name, start us, end us) of each device activity (kernels, copies,
    sets) the profile holds, without the device-side ranges of host spans
    (a kernel never carries the name of a host operation)."""
    from torch.autograd import DeviceType

    host = _annotations(prof)
    return sorted(
        ((e.name, e.time_range.start, e.time_range.end)
         for e in prof.events() if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and e.name not in host and not e.name.startswith(SPAN_PREFIX)),
        key=lambda a: a[1])


def busy_s(acts: list) -> float:
    """Seconds in which at least one device activity ran: the union of
    their time ranges (``chip_smoke.py::device_busy``)."""
    busy, end = 0.0, None
    for _, a, b in acts:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6


def kernel_seconds(acts: list, names) -> float:
    """Summed device seconds of the activities whose name holds one of
    ``names`` as a word (a kernel's ``__global__`` name)."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return sum(b - a for n, a, b in acts if pat.search(n)) / 1e6


def span_device_seconds(prof, span: str) -> float:
    """Device seconds of the kernels launched inside every host span named
    ``span`` (a ``record_function`` of the benchmark), from the launches of
    each operation under it, without the device ranges of nested spans."""
    from torch.autograd import DeviceType

    host = _annotations(prof)
    total = 0.0
    for e in prof.events():
        if e.name != span or e.device_type != DeviceType.CPU:
            continue
        todo = [e]
        while todo:
            x = todo.pop()
            total += sum(k.duration for k in x.kernels if k.name not in host)
            todo.extend(x.cpu_children)
    return total / 1e6


def breakdown(prof, acts: list, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between device activities, each named by the innermost host
    span or operation open when the gap began."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for n, a, b in acts:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CPU]
    gaps = []
    end = None
    for _, a, b in acts:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:top]:
        inner = [h for h in host if h[0] <= g0 < h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else "no host span"
        named.append([name, (g1 - g0) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
