#!/usr/bin/env python3
"""Probe: the port's own spans and counts (``bm.*``,
``brickmap_tpu_torch/utils/profiling.py``) on the card, read as the
benchmark reads them.

    python3 notes/probe_torch_spans.py [--seed N] [--pairs 3]   # ~4 min

For each cell of ``BENCHMARK.json`` (the view cells, then the train cell:
its 37 GB set-up last), one process: the cell's set-up, then its traced
sub-window (``loop.profile()``, as a ``--trace 1`` run makes it), and
prints

* the seven span/count metrics and ``device.idle_pct.*`` from that ctx;
* the breakdown's longest idle gaps, each named by the host span or
  operation open when it began;
* the kernels ``spans.attributed_kernels`` ties to ``bm.wave`` (launch
  calls inside it), per frame by name, beside the count of runtime launch
  calls inside ``bm.wave``, the kernels tied to the benchmark's own
  ``h100bench.wave`` span and every kernel of the sub-window (film_add's
  and film_init's four a frame outside the wave);
* per view, the ``wave.trace_rays`` counts of one profiled wave against
  the wave's ``traced_rays``;
* train: for each ``bm.sync.tier_read`` span, the host's end of the span
  less the end of the last device activity that started before it ended
  (the shared clock: >= 0 and small), with the host calls and the copy
  inside it, the device's times shifted by ``spans.device_offset_us``
  (printed for every cell: how early the device's times ran);
* the traced sub-window's host seconds with the spans on and with them
  nulled (``annotate``/``count`` swapped for no-ops in the modules that
  call them), in turns.

Then the cost of a span and a count with no profiler, and of a span under
one, on this host.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from brickmap_tpu_torch.diff import optim, sparse  # noqa: E402
from brickmap_tpu_torch.render import pathtrace  # noqa: E402
from brickmap_tpu_torch import stream  # noqa: E402
from brickmap_tpu_torch.utils import profiling  # noqa: E402
from h100bench import harness, spans  # noqa: E402

NEW = {"view": ("wave.launches_per_frame", "wave.host_us_per_launch",
                "wave.idle_ms_per_frame", "b2.ns_per_ray",
                "device.idle_pct.view"),
       "train": ("step.sync_wait_ms", "replay.idle_ms_per_step",
                 "pack_field.ms_per_step", "device.idle_pct.train")}
CALLERS = (pathtrace, sparse, optim, stream)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


@contextlib.contextmanager
def nulled():
    """The program's spans and counts swapped for no-ops."""
    off = contextlib.nullcontext()
    saved = []
    for mod in CALLERS:
        for name in ("annotate", "keep_count"):
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, (lambda *a: off) if name == "annotate"
                        else (lambda *a: None))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def launch_calls_inside(prof, name) -> int:
    from torch.autograd import DeviceType

    waves = spans.union(spans.host_intervals(prof, name))
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in spans.LAUNCH_CALLS:
            t = e.time_range.start
            n += any(a <= t < b for a, b in waves)
    return n


def per_name(kernels, units) -> dict:
    out: dict = {}
    for k, _ in kernels:
        short = k.split("(")[0].replace("void ", "")[:48]
        out[short] = out.get(short, 0) + 1
    return {k: v / units for k, v in sorted(out.items())}


def tier_read_check(prof, acts) -> list:
    """For each bm.sync.tier_read span: its end less the end of the last
    device activity that started before it ended, and the host calls and
    device copies inside it, relative to the span's start; the device's
    times shifted onto the host's clock (``spans.device_offset_us``)."""
    from torch.autograd import DeviceType

    d = spans.device_offset_us(prof)
    acts = [(n, a + d, b + d) for n, a, b in acts]
    rows = []
    for a, b in spans.host_intervals(prof, "bm.sync.tier_read"):
        ended = [x for x in acts if x[1] < b]
        if not ended:
            continue
        last = max(ended, key=lambda x: x[2])
        work = [x for x in ended if not x[0].startswith("Memcpy")]
        inner = sorted(
            (e.time_range.start - a, e.time_range.end - a, e.name[:32])
            for e in prof.events() if e.device_type == DeviceType.CPU
            and a <= e.time_range.start < b)
        copies = [(x[1] - a, x[2] - a) for x in ended
                  if x[0].startswith("Memcpy") and x[1] >= a]
        rows.append({"span_us": b - a, "end_minus_last_us": b - last[2],
                     "last": last[0][:40],
                     "end_minus_last_kernel_us":
                         b - max(x[2] for x in work),
                     "host_calls": inner[:12], "copies": copies})
    return rows


def traced_rays_check(loop) -> list:
    """Each view's wave under the profiler: its wave.trace_rays counts
    against its traced_rays."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=loop.device)
    out = []
    profiling.take_counts()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if loop.device.type == "cuda" else [])
    with profile(activities=acts):
        traced = []
        for i in range(len(loop.views)):
            gen.manual_seed(1000 + i)
            _, _, req = loop.pathtrace.render_wave(
                loop.scene, loop.arrays[i], loop.bricks[i], loop.cfg,
                loop.width, loop.height, generator=gen)
            traced.append(req["traced_rays"])
        sync(loop.device)
    counts = profiling.take_counts().get("wave.trace_rays", [])
    per = len(counts) // max(len(traced), 1)
    for i, t in enumerate(traced):
        c = counts[i * per:(i + 1) * per]
        out.append({"view": loop.views[i], "counts": c, "sum": sum(c),
                    "traced_rays": int(t)})
    return out


def probe_cell(cell: dict, dev, seed: int, pairs: int) -> dict:
    name = cell["name"]
    loop = harness.load_loop(cell["traffic_data"]["loop"]).Loop(
        cell["config_data"], cell["traffic_data"], seed, dev)
    t0 = time.perf_counter()
    loop.setup()
    sync(dev)
    print(f"{name}: set-up {time.perf_counter() - t0:.1f} s", flush=True)
    profiling.take_counts()
    ctx = {"cell": name, "loop": loop.name}
    ctx.update(loop.profile())
    prof, units = ctx["prof"], ctx["units"]
    res = {"cell": name, "units": units, "window_s": ctx["window_s"],
           "busy_s": ctx["busy_s"]}
    res["metrics"] = {m: harness.load_metric(m)(ctx) for m in NEW[loop.name]}
    res["idle_gaps"] = ctx["breakdown"]["idle_gaps"]
    if loop.name == "view":
        bm = spans.attributed_kernels(prof, "bm.wave")
        outer = spans.attributed_kernels(prof, "h100bench.wave")
        res["kernels_in_bm_wave"] = len(bm)
        res["kernels_in_h100bench_wave"] = len(outer)
        res["launch_calls_in_bm_wave"] = launch_calls_inside(prof, "bm.wave")
        res["kernel_acts_in_window"] = sum(
            not a[0].startswith(spans.NOT_KERNELS) for a in ctx["acts"])
        res["per_frame_by_name"] = per_name(bm, units)
        res["device_offset_us"] = spans.device_offset_us(prof)
        res["trace_rays"] = traced_rays_check(loop)
    else:
        res["tier_read"] = tier_read_check(prof, ctx["acts"])
        res["device_offset_us"] = spans.device_offset_us(prof)
        res["sync_spans"] = sorted({n for n in (
            e.name for e in prof.events()) if n.startswith("bm.sync.")})
    del ctx, prof
    # The traced sub-window's host time, spans on and nulled, in turns.
    on, off = [], []
    for _ in range(pairs):
        for side, keep in ((False, on), (True, off)):
            with nulled() if side else contextlib.nullcontext():
                got = loop.profile()
            keep.append(got["window_s"])
            del got
            profiling.take_counts()
    res["sub_window_s"] = {"spans_on": on, "spans_nulled": off}
    print(json.dumps(res), flush=True)
    del loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def span_costs() -> dict:
    from torch.profiler import ProfilerActivity, profile

    n = 200_000

    def bare():
        pass

    def one_span():
        with profiling.annotate("bm.x"):
            pass

    def one_count():
        profiling.count("x", 1)

    out = {}
    for _ in range(2):
        base = min(timeit.repeat(bare, number=n, repeat=5)) / n
        out["off_span_us"] = (min(timeit.repeat(one_span, number=n,
                                                repeat=5)) / n - base) * 1e6
        out["off_count_us"] = (min(timeit.repeat(one_count, number=n,
                                                 repeat=5)) / n - base) * 1e6
    m = 20_000
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["on_span_us"] = (min(timeit.repeat(one_span, number=m,
                                               repeat=3)) / m - base) * 1e6
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=2**31 + 19)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--cells", default="view.over_world,view.from_outside,"
                   "train.fixed_rays")
    args = p.parse_args()
    print(f"card {card()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(json.dumps({"span_costs": span_costs()}), flush=True)
    dev = torch.device("cuda", 0)
    for name in args.cells.split(","):
        probe_cell(harness.cell_spec(name, limits=False), dev, args.seed,
                   args.pairs)
    print(json.dumps({"span_costs_after": span_costs()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
