#!/usr/bin/env python3
"""Probe: kernel W2 (the wave's gather + world-box clip) alone, the shipped
design of ``csrc/wave.cu`` against the earlier one, in turns, at the
shapes of the 1080p waves of view 0 and view 7 on the full world; and
what B2's grid over the capacity costs when its count is small.

    python3 notes/probe_torch_w2.py [--reps 50]   # one card, ~1.5 min

Builds, with the port's nvcc flags, each printing its ptxas lines
(registers, shared memory, stack, spills): ``csrc/wave.cu`` and
``csrc/traverse.cu``; ``notes/probe_torch_w2_pr14.cu``, the earlier W2 (a
thread a row of the capacity, threads past the count returning, three
4-byte stores a row for each [*, 3] output) kept verbatim;
``notes/probe_torch_w2_variants.cu``: ``tiles`` (the shipped kernel, a
block a tile over every tile of the capacity), ``blocks`` (the shipped
kernel over 4, 6, 7 or 8 blocks an SM), ``runs`` (the shipped kernel with
a tile whose lanes are one run of rows loading its rays as 16-byte words
through shared memory), ``stride`` (the earlier per-row code in a
grid-stride loop over the resident blocks), ``staged`` (runs with every
tile's rays through shared memory before the clip), ``ends`` (runs told
from a tile's two end lanes, no vote of the block), ``lb8`` (the shipped
kernel with launch bounds of 8 blocks an SM: 32 registers with spills,
where the shipped build has 40 and 6 blocks an SM) and ``fused`` (W0
with W2's work in its tile epilogue, one launch).

The traces are captured by wrapping ``kernels.wave.gather_clip`` (and
``compact`` for the live mask) in one wave of view 0 and one of view 7
(1920x1080, 3 bounces, seeded uniforms): bounce 0 (2,073,600 rays, lanes
the first N rows), bounce 1, the final shadow trace, view 7's near-empty
traces (every primary misses: counts of 0), and bounce 0's lanes at a
count of 0 (over the 4,147,200 rows of capacity).  At each shape every
design is held against the plain version (``ops/wave.py::
gather_clip_plain``: rows below the count and the position map bit for
bit, NaN equal) and timed queued (launches behind a
device sleep, ``app/benchmark.py::kernel_alone_ms``) in turns (new,
earlier, runs, stride, staged, ends, tiles, lb8, then back); the
profiler's kernel time a call of new and earlier beside it; each beside
its bound (73 bytes a ray over 3.35 TB/s); the SM clock read from a
device sleep before and after.  Then:

* ``blocks``: the shipped kernel at 4, 6, 7 and 8 blocks an SM, in turns;
* ``fused`` against W0 then W2 (two launches) at the captured live masks,
  both held equal (lanes, count, B2's inputs, map), W0 alone beside them;
* B2 (``traverse_launch``, unchanged) at a count of 0 over the 4,147,200
  rows of capacity (view 7's traces 1-4): its empty grid's cost;
* one view-0 and one view-7 wave under the profiler with each W2 (the
  earlier one through a wrapper of its launcher), in turns: W2's kernel
  time and launches, all launches, device busy ms;
* the 9-view forward benchmark (``run_forward_benchmark``, 1 warm-up and 1
  timed wave a view) with each W2 in turns: aggregate Mrays/s.

A JSON line with every number ends the output.  Imports torch and the
port only.
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

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
W2_BYTES = 73               # a ray: lane 4 + ray 24 read; 41 + map 4 written
BLOCKS_PER_SM = (4, 6, 7, 8)


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
        out = os.path.join(build.BUILD_DIR, f"libprobe_w2_{tag}.so")
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
    from brickmap_tpu_torch.render import pathtrace
    from brickmap_tpu_torch.render.camera import camera_arrays_for
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_w2: needs a CUDA device")
    dev = torch.device("cuda")
    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build(("wave", "traverse"), force=True)
    for name in ("wave", "traverse"):
        for line in build.ptxas_summary[name]:
            print(f"  ptxas csrc {name}: {line}")
    libs = nvcc_all(build, [
        ("pr14", os.path.join(HERE, "probe_torch_w2_pr14.cu")),
        ("variants", os.path.join(HERE, "probe_torch_w2_variants.cu"))])
    new = build.load("wave", kwave._bind)
    trav = build.load("traverse", ktrav._bind)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    w2_types = new.wave_gather_clip_launch.argtypes
    var = libs["variants"]
    launchers = {"new": new.wave_gather_clip_launch,
                 "earlier": libs["pr14"].wave_gather_clip_pr14_launch,
                 "runs": var.wave_gather_clip_runs_launch,
                 "stride": var.wave_gather_clip_stride_launch,
                 "staged": var.wave_gather_clip_staged_launch,
                 "ends": var.wave_gather_clip_ends_launch,
                 "tiles": var.wave_gather_clip_blocks_launch,
                 "lb8": var.wave_gather_clip_lb8_launch}
    for fn in list(launchers.values())[1:]:
        fn.argtypes = w2_types
        fn.restype = i
    set_k = var.probe_w2_blocks_per_sm
    set_k.argtypes = [i]
    fused = var.wave_compact_gather_launch
    fused.argtypes = [i] + [p] * 7 + [f] * 8 + [p] * 6
    fused.restype = i
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = kwave.scratch(dev)

    def sm_ghz() -> float:
        """The SM clock from a device sleep of 10^8 cycles."""
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(100_000_000)
        b.record()
        torch.cuda.synchronize()
        return 100_000_000 / a.elapsed_time(b) / 1e6

    clocks = [sm_ghz()]
    cfg = preset_full()
    world = scene_mod.generate_terrain_scene(cfg.grid, device=dev)
    w, h = cfg.render.width, cfg.render.height
    n, nb = w * h, cfg.render.max_bounces
    sun = benchmark.ss.sun_direction_from_position(benchmark.SUN_POSITION,
                                                   dev)
    cams = benchmark.benchmark_cameras()

    def wave_of(vi, seed):
        arrays = camera_arrays_for(cams[vi], sun, w, h, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        u = draw_wave_uniforms(n, nb, gen, dev)
        return lambda: pathtrace.render_wave(
            world, arrays, cams[vi].brick_position, cfg, w, h, uniforms=u)

    # Capture every trace's W2 inputs (and the live mask W0 read) in one
    # wave of views 0 and 7.
    caps = {}
    orig_gather, orig_compact = kwave.gather_clip, kwave.compact
    live = [None]

    def capture_compact(mask, limit=None):
        if limit is None:
            live[0] = mask.clone()
        return orig_compact(mask, limit)

    for vi in (0, 7):
        traces = []

        def capture_gather(rays_o, rays_d, lanes, count, grid, pos=None,
                           traces=traces):
            traces.append({"rays_o": rays_o.clone(), "rays_d": rays_d.clone(),
                           "lanes": lanes.clone(), "count": count.clone(),
                           "pos": pos.clone(), "mask": live[0]})
            return orig_gather(rays_o, rays_d, lanes, count, grid, pos)
        # While swapped in, the wrappers' own lookups of their launch count
        # and event hook find these functions.
        for fn in (capture_gather, capture_compact):
            fn.events, fn.launches = None, 0
        kwave.gather_clip, kwave.compact = capture_gather, capture_compact
        try:
            wave_of(vi, 100 + vi)()
        finally:
            kwave.gather_clip, kwave.compact = orig_gather, orig_compact
        torch.cuda.synchronize()
        for t, c in enumerate(traces):
            caps[(vi, t)] = c
    zero = dict(caps[(0, 0)])
    zero["count"] = torch.zeros(1, dtype=torch.int32, device=dev)
    shapes = {"bounce 0": caps[(0, 0)], "bounce 1": caps[(0, 1)],
              "final": caps[(0, nb + 1)], "count 0": zero,
              "view 7 trace 1": caps[(7, 1)]}
    out_counts = {f"view {vi} trace {t}": int(caps[(vi, t)]["count"])
                  for vi in (0, 7) for t in range(nb + 2)}
    print(f"trace counts: {out_counts}", flush=True)

    def outputs(cap):
        e = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype,  # noqa: E731
                                                        device=dev)
        return (e(cap, 3), e(cap, 3), e(cap, 3), e(cap),
                e(cap, dtype=torch.bool))

    def same(a, b) -> bool:
        if a.is_floating_point():
            return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        return torch.equal(a, b)

    def profiled_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return sum(e.time_range.end - e.time_range.start
                   for e in evs) / reps / 1e3

    out = {"card": card, "counts": out_counts, "w2": {}, "blocks_per_sm": {},
           "fused": {},
           "b2_empty_grid": {}, "waves": {}, "aggregate": {}}
    turns = ("new", "earlier", "runs", "stride", "staged", "ends",
             "tiles", "lb8")
    turns += turns[::-1]
    for shape, c in shapes.items():
        cap = c["lanes"].shape[0]
        m = int(c["count"])
        pos_w = c["pos"].clone()
        want = owave.gather_clip_plain(c["rays_o"], c["rays_d"], c["lanes"],
                                       c["count"], cfg.grid, pos_w)
        runs = {}
        for tag, fn in launchers.items():
            o, pos = outputs(cap), c["pos"].clone()
            a = kwave.gather_clip_args(c["rays_o"], c["rays_d"], c["lanes"],
                                       c["count"], cfg.grid, pos, o, stream)
            set_k(0)
            assert fn(*a) == 0
            torch.cuda.synchronize()
            if not (all(same(x[:m], y[:m]) for x, y in zip(o, want))
                    and torch.equal(pos, pos_w)):
                raise SystemExit(f"W2 {tag} at {shape}: not the plain "
                                 f"version's")
            runs[tag] = (lambda fn=fn, a=a, o=o, pos=pos: fn(*a))
        rec = {"rays": m, "capacity": cap,
               "bound_ms": W2_BYTES * m / HBM_BYTES_PER_S * 1e3}
        for tag in turns:
            set_k(0)
            rec.setdefault(f"{tag}_queued_ms", []).append(
                benchmark.kernel_alone_ms([runs[tag]], args.reps))
        for tag in ("new", "earlier"):
            rec[f"{tag}_profiled_ms"] = profiled_ms(runs[tag])
        if shape in ("bounce 0", "bounce 1", "count 0"):
            kr = out["blocks_per_sm"].setdefault(shape, {})
            for k in BLOCKS_PER_SM + BLOCKS_PER_SM[::-1]:
                set_k(k)
                kr.setdefault(str(k), []).append(
                    benchmark.kernel_alone_ms([runs["tiles"]], args.reps))
            set_k(0)
            print(f"W2 at {shape}, blocks an SM {BLOCKS_PER_SM}: {kr}",
                  flush=True)
        out["w2"][shape] = rec
        print(f"W2 at {shape} ({m} rays of {cap}; all designs equal to the "
              f"plain version): " + "; ".join(
                  f"{k} {v}" for k, v in rec.items()), flush=True)

    # Option 3: W0 with W2 in its tile epilogue, against W0 then W2.
    for shape in ("bounce 0", "bounce 1", "final", "view 7 trace 1"):
        c = shapes[shape]
        mask = c["mask"]
        cap = mask.shape[0]
        lanes_s = torch.empty(cap, dtype=torch.int32, device=dev)
        lanes_f = torch.empty_like(lanes_s)
        cnt_s = torch.empty(1, dtype=torch.int32, device=dev)
        cnt_f = torch.empty_like(cnt_s)
        o_s, o_f = outputs(cap), outputs(cap)
        pos_s, pos_f = c["pos"].clone(), c["pos"].clone()
        a0 = kwave.compact_args(mask, None, lanes_s, cnt_s, scratch, stream)
        a2 = kwave.gather_clip_args(c["rays_o"], c["rays_d"], lanes_s, cnt_s,
                                    cfg.grid, pos_s, o_s, stream)
        af = (cap, mask.data_ptr(), lanes_f.data_ptr(), cnt_f.data_ptr(),
              scratch.data_ptr(), c["rays_o"].data_ptr(),
              c["rays_d"].data_ptr(), pos_f.data_ptr(),
              *kwave._box_args(cfg.grid), *(x.data_ptr() for x in o_f),
              stream)

        def separate(a0=a0, a2=a2):
            assert new.wave_compact_launch(*a0) == 0
            assert new.wave_gather_clip_launch(*a2) == 0

        def one(af=af):
            assert fused(*af) == 0

        def w0_alone(a0=a0):
            assert new.wave_compact_launch(*a0) == 0
        separate()
        one()
        torch.cuda.synchronize()
        m = int(cnt_s)
        if not (int(cnt_f) == m and torch.equal(lanes_f[:m], lanes_s[:m])
                and torch.equal(pos_f, pos_s)
                and all(same(x[:m], y[:m]) for x, y in zip(o_f, o_s))):
            raise SystemExit(f"fused W0 + W2 at {shape}: not W0 then W2's")
        if bool(scratch.any()):
            raise SystemExit("the fused W0 + W2 left its scratch dirty")
        rec = {"rays": m}
        for tag in ("separate", "fused", "w0", "w0", "fused", "separate"):
            fn = {"separate": separate, "fused": one, "w0": w0_alone}[tag]
            rec.setdefault(f"{tag}_queued_ms", []).append(
                benchmark.kernel_alone_ms([fn], args.reps))
        out["fused"][shape] = rec
        print(f"W0 + W2 at {shape}: {rec}", flush=True)

    # B2's grid over the capacity at small counts: the unchanged launcher
    # over the 4,147,200 rows, and over exactly the count.
    budget = cfg.render.trace_budget
    for shape in ("count 0",):
        c = shapes[shape]
        cap, m = c["lanes"].shape[0], int(c["count"])
        inputs = kwave.gather_clip(c["rays_o"], c["rays_d"], c["lanes"],
                                   c["count"], cfg.grid)
        cam = cams[0 if shape == "count 0" else 7].brick_position
        res_cap = ktrav._outputs(cap, dev)
        a_cap = ktrav.launch_args(inputs, world.index_volume, world,
                                  tuple(int(x) for x in cam), cfg.grid,
                                  budget, res_cap, stream, c["count"])
        rec = {"rays": m, "capacity": cap}
        runs = {"capacity": lambda a=a_cap: trav.traverse_launch(*a)}
        if m:
            res_m = ktrav._outputs(m, dev)
            a_m = ktrav.launch_args(tuple(x[:m] for x in inputs),
                                    world.index_volume, world,
                                    tuple(int(x) for x in cam), cfg.grid,
                                    budget, res_m, stream, c["count"])
            runs["count"] = lambda a=a_m: trav.traverse_launch(*a)
        for tag in ("capacity", "count", "count", "capacity"):
            if tag in runs:
                rec.setdefault(f"over_{tag}_queued_ms", []).append(
                    benchmark.kernel_alone_ms([runs[tag]], args.reps))
        out["b2_empty_grid"][shape] = rec
        print(f"B2 at {shape}: {rec}", flush=True)

    # Whole waves with each W2: the earlier one through its launcher.
    def gather_with(fn):
        def gather_clip(rays_o, rays_d, lanes, count, grid, pos=None):
            o = outputs(lanes.shape[0])
            assert fn(*kwave.gather_clip_args(rays_o, rays_d, lanes, count,
                                              grid, pos, o, stream)) == 0
            return o
        return gather_clip

    designs = {"new": orig_gather, "earlier": gather_with(
        launchers["earlier"])}
    for vi in (0, 7):
        run = wave_of(vi, 200 + vi)
        for tag in ("new", "earlier", "earlier", "new"):
            kwave.gather_clip = designs[tag]
            try:
                run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
            finally:
                kwave.gather_clip = orig_gather
            evs = sorted((e for e in prof.events()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
            kern = [e for e in evs if not e.name.startswith(("Memcpy",
                                                             "Memset"))]
            w2 = [e for e in kern if "gather_clip" in e.name]
            busy, end = 0.0, evs[0].time_range.start
            for e in evs:
                if e.time_range.end > end:
                    busy += e.time_range.end - max(e.time_range.start, end)
                    end = e.time_range.end
            rec = out["waves"].setdefault(f"view {vi}", {})
            rec.setdefault(f"{tag}_w2_ms", []).append(sum(
                e.time_range.end - e.time_range.start for e in w2) / 1e3)
            rec.setdefault(f"{tag}_w2_each_ms", []).append([
                (e.time_range.end - e.time_range.start) / 1e3 for e in w2])
            rec.setdefault(f"{tag}_launches", []).append(len(kern))
            rec.setdefault(f"{tag}_busy_ms", []).append(busy / 1e3)
        print(f"view {vi}'s wave, profiled: {out['waves'][f'view {vi}']}",
              flush=True)

    for tag in ("new", "earlier", "earlier", "new"):
        kwave.gather_clip = designs[tag]
        try:
            res = benchmark.run_forward_benchmark(
                world, cfg, waves_per_view=1, warmup_waves=1, verbose=False)
        finally:
            kwave.gather_clip = orig_gather
        out["aggregate"].setdefault(f"{tag}_mrays_per_s", []).append(
            res["mrays_per_s"])
        out["aggregate"].setdefault(f"{tag}_wave_ms", []).append(
            [r["avg_ms"] for r in res["per_view"]])
    print(f"aggregate: {out['aggregate']}", flush=True)
    clocks.append(sm_ghz())
    out["sm_ghz"] = clocks
    print(f"SM clock from a device sleep, first and last: {clocks} GHz",
          flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
