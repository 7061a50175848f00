#!/usr/bin/env python3
"""Probe: kernels W0 (the wave's compaction) and W4 (the rescue) alone,
the shipped designs of ``csrc/wave.cu`` against the earlier ones, in
turns, at the shapes of view 0's 1080p wave on the full world.

    python3 notes/probe_torch_w0w4.py [--reps 50] [--no-w0]   # one card

Builds, with the port's nvcc flags, each printing its ptxas lines
(registers, stack, spills): ``csrc/wave.cu`` and ``csrc/traverse.cu``
(``traverse_kernel``, B2, which shares its walk with W4);
``notes/probe_torch_w0w4_pr13.cu``, the earlier W0 (``compact_count_kernel``
+ ``compact_write_kernel``: two launches of a block a 4,096-row tile) and
W4 (``rescue_kernel`` over a thread a row of the capacity) kept verbatim;
``notes/probe_torch_w0w4_variants.cu``, the shipped W4's rays under the
other schedules: ``stride`` (a plain grid-stride loop over the resident
blocks), ``block`` (a block's 128 rows at a time from the cursor),
``ahead`` (the shipped warps' 32 rows, the next 32 taken before the
current ones start), ``held`` (the shipped warps with the count held in a
register), ``cap128`` (the earlier grid, a thread a row of the capacity, over
the shipped per-ray code) and ``blocks`` (the shipped kernel or held's
over 6, 7 and 8 blocks an SM).  Each build's loops in the SASS
(``cuobjdump``: length, float compares) are printed.

Then, on the 4096^2 x 512 world built on the card, view 0 (1920x1080, 3
bounces, seed 0, lanes in the tile order), each design held against the
plain version (``torch.nonzero``; ``ops/wave.py::rescue_plain``) and timed
in turns (new, earlier, earlier, new; W4's other schedules between):

* W0 at bounce 0's live mask (4,147,200 rows, 2,073,600 set), bounce 1's,
  the trace's exhausted flags over ``limit`` = its count (few set), a
  ``limit`` of 0, and the starved primaries' exhausted flags (view 0's
  primaries traced with 16 steps), with ``torch.nonzero`` beside each;
* W4 at a count of 0 over the bounce-0 trace's capacity, and on the
  starved primaries' exhausted rays with the wave's rescue budget (every
  ray rescued; the distribution of their steps over the passes printed).

Three timings, so that they can be told apart: ``queued``, launches queued
behind a device sleep between two CUDA events (the device's time a launch,
``app/benchmark.py::kernel_alone_ms``; what a wave pays, whose host runs
ahead of the card); ``events``, CUDA events around each launch with the
host not ahead (how W0's "alone" was timed before: the device idles while the host submits
the launch, so a short kernel reads as its launch latency); and the
profiler's kernel time a call.  W4 on the starved rays rewrites its inputs,
so each launch follows copies that restore them, all queued behind the
sleep, the events around the launch alone.  ``torch.nonzero`` is timed by
events around 20 calls (each synchronises: its count comes to the host).
The masks are L2-warm as in the wave (W0 reads what W1, W3 or B2 wrote
just before); W4's restored results (~70 MB) exceed the L2.  A JSON line
with every number ends the output.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
STARVED_STEPS = 16          # as chip_smoke.py's phase 5


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def nvcc_all(build, jobs) -> dict:
    """Build each (tag, source) in parallel and print its ptxas lines;
    returns {tag: CDLL}."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = {}
    for tag, src in jobs:
        out = os.path.join(build.BUILD_DIR, f"libprobe_w0w4_{tag}.so")
        procs[tag] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             out, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for tag, (out, proc) in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {tag}:\n{se}")
        for line in build._summary(so + se):
            print(f"  ptxas {tag}: {line}", flush=True)
        libs[tag] = ctypes.CDLL(out)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-w0", action="store_true", help="W4 only")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import preset_full
    from brickmap_tpu_torch.kernels import build, traverse as ktrav, \
        wave as kwave
    from brickmap_tpu_torch.ops import wave as owave
    from brickmap_tpu_torch.ops.traverse import trace_clipped_rays
    from brickmap_tpu_torch.render import pathtrace
    from brickmap_tpu_torch.render.camera import camera_arrays_for
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_w0w4: needs a CUDA device")
    dev = torch.device("cuda")
    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build(("wave", "traverse"), force=True)
    for name in ("wave", "traverse"):
        for line in build.ptxas_summary[name]:
            print(f"  ptxas csrc {name}: {line}")
    libs = nvcc_all(build, [
        ("earlier", os.path.join(HERE, "probe_torch_w0w4_pr13.cu")),
        ("variants", os.path.join(HERE, "probe_torch_w0w4_variants.cu"))])
    import probe_torch_b1
    for tag, path in (("csrc", build.lib_path("wave")),
                      ("earlier", os.path.join(build.BUILD_DIR,
                                            "libprobe_w0w4_earlier.so")),
                      ("variants", os.path.join(build.BUILD_DIR,
                                                "libprobe_w0w4_variants.so"))):
        loops = probe_torch_b1.sass_loops(build, path, f"w4_{tag}", None)
        del loops
    new = build.load("wave", kwave._bind)
    p, i = ctypes.c_void_p, ctypes.c_int
    old = libs["earlier"]
    old.wave_compact_launch.argtypes = [i] + [p] * 6
    old.wave_rescue_launch.argtypes = \
        new.wave_rescue_launch.argtypes[:-2] + [p]
    sched = {tag: getattr(libs["variants"], f"wave_rescue_{tag}_launch")
             for tag in ("held", "block", "ahead", "stride", "cap128",
                         "blocks")}
    for f in sched.values():
        f.argtypes = new.wave_rescue_launch.argtypes
    set_k = libs["variants"].probe_blocks_per_sm
    set_k.argtypes = [i, i]
    for f in (old.wave_compact_launch, old.wave_rescue_launch,
              *sched.values()):
        f.restype = i
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = kwave.scratch(dev)

    # View 0's wave state: W1, then the first trace and W3.
    cfg = preset_full()
    world = scene_mod.generate_terrain_scene(cfg.grid, device=dev)
    w, h = cfg.render.width, cfg.render.height
    n, nb = w * h, cfg.render.max_bounces
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cam0 = benchmark.benchmark_cameras()[0]
    cam_b = cam0.brick_position
    sun = benchmark.ss.sun_direction_from_position(benchmark.SUN_POSITION,
                                                   dev)
    arrays = camera_arrays_for(cam0, sun, w, h, dev)
    u = draw_wave_uniforms(n, nb, gen, dev)
    perm = pathtrace._tile_order(w, h, dev)
    st = owave.new_state(n, dev)
    kwave.primary(perm, u, arrays, w, h, st)
    masks = {"bounce 0": (st["live"].clone(), None)}
    lanes, count = kwave.compact(st["live"])
    res = ktrav.trace_clipped(
        kwave.gather_clip(st["rays_o"], st["rays_d"], lanes, count, cfg.grid,
                          pos=st["pos"]), count, world, cam_b, cfg.grid,
        cfg.render.trace_budget)
    masks["exhausted rows"] = (res["exhausted"].clone(), count.clone())
    masks["limit 0"] = (res["exhausted"].clone(),
                        torch.zeros(1, dtype=torch.int32, device=dev))
    rows, n_rows = kwave.compact(res["exhausted"], count)
    kwave.rescue(res, rows, n_rows, lanes, st["rays_o"], st["rays_d"], world,
                 cam_b, cfg.grid, pathtrace.rescue_budget(cfg),
                 pathtrace.RESCUE_PASSES)
    kwave.shade(0, st, res, u["cone"][0], u["hemi"][0], sun, cfg)
    masks["bounce 1"] = (st["live"].clone(), None)
    # The starved primaries: view 0's primaries traced with 16 steps.
    kwave.primary(perm, u, arrays, w, h, st)
    lanes, count = kwave.compact(st["live"])
    sres = ktrav.trace_clipped(
        kwave.gather_clip(st["rays_o"], st["rays_d"], lanes, count,
                          cfg.grid), count, world, cam_b, cfg.grid,
        STARVED_STEPS)
    masks["starved exhausted"] = (sres["exhausted"].clone(), count.clone())
    torch.cuda.synchronize()

    def nonzero_of(mask, limit):
        m = mask.shape[0] if limit is None else int(limit)
        return torch.nonzero(mask[:m]).squeeze(1).int()

    def events_ms(fn, reps):
        """Mean ms of fn() by events around each call, host not ahead."""
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            pairs.append((a, b))
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def profiled_us(fn, reps=10):
        """Device kernel time a call by the profiler (sum of the kernels'
        durations), and the kernels' names."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        total = sum(e.time_range.end - e.time_range.start for e in evs)
        return total / reps, sorted({e.name for e in evs})

    out = {"card": card, "w0": {}, "w4": {}}
    m_cap = st["live"].shape[0]
    for shape, (mask, limit) in ({} if args.no_w0 else masks).items():
        want = nonzero_of(mask, limit)
        o_new = torch.empty(m_cap, dtype=torch.int32, device=dev)
        c_new = torch.empty(1, dtype=torch.int32, device=dev)
        o_old, c_old = o_new.clone(), c_new.clone()
        parts = torch.empty(-(-m_cap // 4096), dtype=torch.int32, device=dev)
        lim = None if limit is None else limit.data_ptr()
        args_new = kwave.compact_args(mask, limit, o_new, c_new, scratch,
                                      stream)
        args_old = (m_cap, mask.data_ptr(), lim, parts.data_ptr(),
                    o_old.data_ptr(), c_old.data_ptr(), stream)
        runs = {"new": lambda: new.wave_compact_launch(*args_new),
                "earlier": lambda: old.wave_compact_launch(*args_old)}
        for tag, run in runs.items():
            assert run() == 0
            torch.cuda.synchronize()
            o, c = (o_new, c_new) if tag == "new" else (o_old, c_old)
            k = want.shape[0]
            if int(c) != k or not torch.equal(o[:k], want):
                raise SystemExit(f"W0 {tag} at {shape}: not torch.nonzero's")
        if bool(scratch.any()):
            raise SystemExit(f"W0 at {shape} left its scratch dirty")
        rec = {"rows": int(m_cap if limit is None else limit),
               "set": int(want.shape[0])}
        for tag in ("new", "earlier", "earlier", "new"):
            rec.setdefault(f"{tag}_queued_ms", []).append(
                benchmark.kernel_alone_ms([runs[tag]], args.reps))
        for tag in ("new", "earlier", "earlier", "new"):
            rec.setdefault(f"{tag}_events_ms", []).append(
                events_ms(runs[tag], 20))
        for tag in ("new", "earlier"):
            us, names = profiled_us(runs[tag])
            rec[f"{tag}_profiled_ms"] = us / 1e3
            rec[f"{tag}_kernels"] = names
        head = mask[:rec["rows"]]
        nz = [events_ms(lambda: torch.nonzero(head), 20) for _ in range(2)]
        rec["nonzero_ms"] = nz
        rec["bound_ms"] = (rec["rows"] + 4 * rec["set"]) / \
            HBM_BYTES_PER_S * 1e3
        out["w0"][shape] = rec
        print(f"W0 at {shape} ({rec['rows']} rows, {rec['set']} set): "
              f"queued new {rec['new_queued_ms']} / earlier "
              f"{rec['earlier_queued_ms']} ms; events new "
              f"{rec['new_events_ms']} / earlier "
              f"{rec['earlier_events_ms']} ms; "
              f"profiled new {rec['new_profiled_ms']:.5f} "
              f"{rec['new_kernels']} / earlier {rec['earlier_profiled_ms']:.5f} "
              f"{rec['earlier_kernels']} ms; torch.nonzero {nz} ms; bound "
              f"{rec['bound_ms']:.5f} ms", flush=True)

    # W4: a zero count over the bounce-0 trace's capacity, then the starved
    # primaries' exhausted rays with the wave's rescue budget.
    budget, passes = pathtrace.rescue_budget(cfg), pathtrace.RESCUE_PASSES
    rows, n_rows = kwave.compact(sres["exhausted"], count)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    designs = {"new": new.wave_rescue_launch, **sched,
               "earlier": old.wave_rescue_launch}
    turns = [t for t in designs if t != "blocks"]
    turns += turns[::-1]

    def w4_args(tag, target, cnt):
        a = kwave.rescue_args(target, rows, cnt, lanes, st["rays_o"],
                              st["rays_d"], world, cam_b, cfg.grid, budget,
                              passes, scratch, stream)
        return a[:-2] + (stream,) if tag == "earlier" else a

    zero_runs = {tag: (lambda f=f, a=w4_args(tag, sres, zero): f(*a))
                 for tag, f in designs.items()}
    zrec = {}
    for tag in ("new", "stride", "earlier", "earlier", "stride", "new"):
        zrec.setdefault(f"{tag}_queued_ms", []).append(
            benchmark.kernel_alone_ms([zero_runs[tag]], args.reps))
    for tag in ("new", "earlier"):
        zrec[f"{tag}_events_ms"] = events_ms(zero_runs[tag], 20)
    out["w4"]["zero count"] = zrec
    print(f"W4 at a zero count ({rows.shape[0]} rows of capacity): {zrec}",
          flush=True)

    saved = {k: v.clone() for k, v in sres.items()}
    want = {k: v.clone() for k, v in saved.items()}
    stats = {}
    owave.rescue_plain(want, rows, n_rows, lanes, st["rays_o"], st["rays_d"],
                       world, cam_b, cfg.grid, budget, passes, stats)
    work = {k: v.clone() for k, v in saved.items()}

    def restore():
        for k, v in saved.items():
            work[k].copy_(v)

    srec = {"rays": int(n_rows)}
    # Each rescued ray's steps over its passes, by row (the plain passes).
    idx = rows[:int(n_rows)].long()
    steps = torch.zeros(idx.shape[0], dtype=torch.int64, device=dev)
    resume = saved["resume_t"][idx]
    alive = torch.ones_like(steps, dtype=torch.bool)
    for _ in range(passes):
        off = torch.clamp(resume - 2.0, min=0.0)
        r2 = trace_clipped_rays(
            *owave._clip_rows(st["rays_o"], st["rays_d"], lanes[idx].long(),
                              cfg.grid, off), world.index_volume,
            world.pool_words, world.pool_base, cam_b, cfg.grid,
            max_iters=budget)
        steps += torch.where(alive, r2["ray_iters"].long(), 0)
        alive &= r2["exhausted"]
        resume = torch.where(r2["exhausted"], r2["resume_t"] + off, 0.0)
    order = torch.sort(steps, descending=True)
    srec["steps_max"] = int(order.values[0])
    srec["steps_p99"] = int(order.values[idx.shape[0] // 100])
    srec["steps_p50"] = int(order.values[idx.shape[0] // 2])
    srec["longest_at"] = [int(x) for x in order.indices[:8]]
    srec["steps_check"] = int(steps.sum())
    for tag, f in designs.items():
        set_k(8, 0)
        restore()
        assert f(*w4_args(tag, work, n_rows)) == 0
        torch.cuda.synchronize()
        m = int(count)
        for k in owave.RESCUE_KEYS:
            if not torch.equal(work[k][:m], want[k][:m]):
                raise SystemExit(f"W4 {tag}: {k} differs from the plain "
                                 f"rescue passes")
    if bool(scratch.any()):
        raise SystemExit("W4 left its scratch dirty")

    def queued_each_ms(tag, reps=6):
        a_args = w4_args(tag, work, n_rows)
        torch.cuda.synchronize()
        torch.cuda._sleep(benchmark.SLEEP_CYCLES)
        pairs = []
        for _ in range(reps):
            restore()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            designs[tag](*a_args)
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(x.elapsed_time(y) for x, y in pairs) / reps

    for tag in turns:
        srec.setdefault(f"{tag}_ms", []).append(queued_each_ms(tag, 10))
    for held in (0, 1, 1, 0):
        for k in (6, 7, 8):
            set_k(k, held)
            srec.setdefault(f"{'held' if held else 'new'}_{k}_per_sm_ms",
                            []).append(queued_each_ms("blocks", 10))
    nbytes = srec["rays"] * 71 + 4 * int(stats["cells_read"].sum()) \
        + 64 * int(stats["rows_read"].sum())
    srec["steps"] = stats["steps"]
    srec["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    out["w4"]["starved primaries"] = srec
    print(f"W4 on the {srec['rays']} starved primaries ({budget} steps, "
          f"{passes} passes; every key equal to the plain passes for each "
          f"design): {srec}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
