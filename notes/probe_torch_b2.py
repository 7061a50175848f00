#!/usr/bin/env python3
"""Probe: kernel B2 (the hierarchical traversal) alone, its baseline design
against the one in ``csrc/traverse.cu`` and the candidate builds, in turns,
at the main path's shapes, with the lines each warp-wide gather touches.

    python3 notes/probe_torch_b2.py [--variants T1R0,T1R1,...]
        [--blocks-per-sm 1,2,...,9] [--sweep T0R0,T1R1] [--sass-dir DIR]
        [--reps 20] [--no-phase5] [--phase5 T0R0]
        [--parent OTHER/brickmap_tpu_torch/csrc/traverse.cu]  # one CUDA card

Builds, with the port's nvcc flags, each printing its ptxas lines:

* ``notes/probe_torch_b2_pr5.cu``: the baseline, a verbatim copy of B2 as
  the redesign found it (index words from ``index_volume[cz][cy][cx]``, the
  brick's row word re-read from global memory at every step of the
  descend);
* ``csrc/traverse.cu`` as it stands (its launcher reads the ray count on
  the device; here the count is every row);
* with ``--parent``, another tree's ``traverse.cu`` (the parent commit's,
  unpacked with ``git archive``), built the same way and timed as
  ``parent`` beside csrc's, for a change of B2's source;
* ``notes/probe_torch_b2_variants.cu`` once for each ``--variants`` spec
  ``T<top>R<row>`` (top 0: ``index_volume``, 1: ``block_words`` recomputed
  each step, 2: ``block_words`` advanced; row 0: re-read each step, 1: one
  fetch into a shared-memory slot, 2: the current word in a register;
  ``P1`` after a spec: row mode 0 with row mode 1's shared memory reserved
  and unused), once as the counting build (the baseline's reads,
  counting for each warp-wide gather the distinct 128-byte lines its lanes
  touch, and the lines and sectors of index words read at all), and once
  as the clock build (the baseline with ``clock64()`` stamps: the
  cycles each index-word and row-word load waits, and the share of a
  lane's cycles spent waiting and inside descends).  The variants read
  ``block_words`` as this probe tiles it (the JAX package's layout, padded
  with zero words; the port's scene does not carry it).

With ``--sass-dir`` every build's ``cuobjdump -sass`` listing is written
there; each kernel's loops are printed with their length (the descend's
sub-DDA loop is the short one with the most float compares).

Then, on the 4096^2 x 512 world built on the card, at four shapes: view 0's
primary rays (1920x1080, seed 0), the bounce-1 and the final shadow trace
of view 0's first wave (captured by wrapping ``kernels.wave.gather_clip``), and the
cold streaming world's wave-0 primaries (``StreamingScene`` before any
upload, in the wave's tile order, requests on):

* the plain version on the card, which every build must equal on every
  output; its steps give the launch-order SIMD efficiency and, with the
  distinct index words and brick rows it read, the bound (80 B in and out
  a ray, 4 B a distinct word, 64 B a distinct row, over 3.35 TB/s; or 12
  operations a step over 67 TFLOP/s);
* the counting build: index-word gathers and the lines they touch at
  ``index_volume``'s and at ``block_words``' addresses, the descend's
  per-step row-word gathers and their lines, and the descends and the lines
  of their whole rows, each per warp gather; then the clock build;
* each build alone (``app/benchmark.py::kernel_alone_ms``: launches queued
  behind a device sleep, CUDA events) over ``hbm_copies`` copies of the
  rays taken in turn, in turns: the baseline, csrc, the variants, then
  backwards.

``--blocks-per-sm`` times each ``--sweep`` build at the primaries and
bounce 1 as a grid-stride loop over at most that many blocks of 128 an SM:
whether the time keeps falling to 9 (latency binds) or flattens early (a
throughput unit binds).  Unless ``--no-phase5``, phase 5's 18 waves (a
warm-up and a timed wave for each of the 9 views, their seeds) are
rendered with every B2 launch made by the baseline's build, by csrc's and
by each ``--phase5`` variant, in turns there and back, each launch between CUDA
events (B2 as the wave's other kernels leave the L2 for it); the images
must be equal, and each build's sum of B2 time is printed.  A JSON line
with every number ends the output.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12
DDA_STEP_OPS = 12           # as in chip_smoke.py
RAY_BYTES = 41 + 39         # a ray's inputs and outputs, as in chip_smoke.py
KEYS = ("hit", "t", "normal", "request", "request_pos", "exhausted",
        "resume_t", "ray_iters")


def smi(fields="name,power.limit") -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def nvcc_all(build, jobs) -> dict:
    """Build each (tag, source, defines) job in parallel, print its ptxas
    lines; returns {tag: (CDLL, path)}."""
    procs = {}
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    for tag, src, defines in jobs:
        out = os.path.join(build.BUILD_DIR, f"libprobe_b2_{tag}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS,
               *(f"-D{d}" for d in defines), "-I", build.CSRC, "-o", out,
               src]
        procs[tag] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for tag, (out, proc) in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {tag}:\n{se}")
        for line in build._summary(so + se):
            print(f"  ptxas {tag}: {line}", flush=True)
        libs[tag] = (ctypes.CDLL(out), out)
    return libs


def block_words(iv):
    """The index words re-tiled into 4x4x4-cell blocks of 64 (the JAX
    package's ``block_words``, ``brickmap_tpu/scene.py:82``): word
    ((z%4)*4 + y%4)*4 + x%4 of block ((z/4)*NBY + y/4)*NBX + x/4, edges
    padded with zero words."""
    cz, cy, cx = iv.shape
    nz, ny, nx = (-(-c // 4) for c in (cz, cy, cx))
    padded = iv.new_zeros((4 * nz, 4 * ny, 4 * nx))
    padded[:cz, :cy, :cx] = iv
    return padded.reshape(nz, 4, ny, 4, nx, 4).permute(0, 2, 4, 1, 3, 5) \
        .reshape(-1, 64).contiguous()


def variant_spec(spec: str) -> tuple:
    m = re.fullmatch(r"T([012])R([012])(P1)?", spec)
    if not m:
        raise SystemExit(f"bad variant {spec!r}: T<0-2>R<0-2>[P1]")
    return (f"PROBE_TOP={m.group(1)}", f"PROBE_ROW={m.group(2)}",
            f"PROBE_PAD={int(bool(m.group(3)))}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="T0R0,T1R0,T2R0,T1R1,T1R2,T2R1")
    ap.add_argument("--blocks-per-sm", default="")
    ap.add_argument("--sweep", default="T0R0,T1R1")
    ap.add_argument("--sass-dir", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-phase5", action="store_true")
    ap.add_argument("--phase5", default="",
                    help="comma list: variants also timed in phase 5's waves")
    ap.add_argument("--parent", default=None,
                    help="another tree's traverse.cu (its launcher with or "
                         "without the count), timed as 'parent'")
    args = ap.parse_args()

    import torch

    import probe_torch_b1
    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import preset_full
    from brickmap_tpu_torch.kernels import build, traverse as ktrav, \
        wave as kwave
    from brickmap_tpu_torch.ops.traverse import trace_rays
    from brickmap_tpu_torch.render import pathtrace
    from brickmap_tpu_torch.render.camera import camera_arrays_for, \
        primary_rays_from_arrays
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms
    from brickmap_tpu_torch.stream import StreamingScene

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_b2: needs a CUDA device")
    dev = torch.device("cuda")
    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build(force=True)
    for name in ("brick", "traverse", "record"):
        for line in build.ptxas_summary[name]:
            print(f"  ptxas csrc {name}: {line}")
    specs = [s for s in args.variants.split(",") if s]
    sweep = [s for s in args.sweep.split(",") if s] if args.blocks_per_sm \
        else []
    jobs = [("base", os.path.join(HERE, "probe_torch_b2_pr5.cu"), ())]
    if args.parent:
        jobs.append(("parent", os.path.abspath(args.parent), ()))
    for spec in dict.fromkeys(specs + sweep):
        jobs.append((spec, os.path.join(HERE, "probe_torch_b2_variants.cu"),
                     variant_spec(spec)))
    jobs.append(("count", os.path.join(HERE, "probe_torch_b2_variants.cu"),
                 ("PROBE_TOP=0", "PROBE_ROW=0", "PROBE_COUNT=1")))
    jobs.append(("clock", os.path.join(HERE, "probe_torch_b2_variants.cu"),
                 ("PROBE_TOP=0", "PROBE_ROW=0", "PROBE_CLOCK=1")))
    libs = nvcc_all(build, jobs)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # Launchers without the count argument: the baseline's, and a parent's
    # from before B2 read its count on the device (a parent with the count
    # binds as csrc's does).
    parent_count = bool(args.parent) and "const int* count" in open(
        args.parent).read()
    old_sig = ("base",) + (() if parent_count else ("parent",))
    if parent_count:
        ktrav._bind(libs["parent"][0])
    for tag in old_sig:
        if tag in libs:
            libs[tag][0].traverse_launch.argtypes = (
                [i] + [p] * 8 + [i] * 12 + [f, i] + [p] * 8 + [p])
            libs[tag][0].traverse_launch.restype = i
    for tag, (lib, _) in libs.items():
        if tag not in (*old_sig, "parent"):
            lib.variant_launch.argtypes = ([i] + [p] * 9 + [i] * 12 + [f, i]
                                           + [p] * 8 + [p, i, p])
            lib.variant_launch.restype = i
    loops = {"csrc": probe_torch_b1.sass_loops(
        build, build.lib_path("traverse"), "b2_csrc", args.sass_dir)}
    for tag, (_, path) in libs.items():
        loops[tag] = probe_torch_b1.sass_loops(build, path, f"b2_{tag}",
                                               args.sass_dir)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    torch.cuda.synchronize()
    ghz = 100_000_000 / a.elapsed_time(b) / 1e6
    print(f"  SM clock from a device sleep: {ghz:.3f} GHz", flush=True)

    cfg = preset_full()
    grid = cfg.grid
    budget = cfg.render.trace_budget
    world = scene_mod.generate_terrain_scene(grid, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib_csrc = build.load("traverse", ktrav._bind)

    tilings = {}

    def runner(tag, inputs, out, sc, cam, bps=0, counters=None,
               steps=budget):
        """A callable that launches build ``tag`` on prepared inputs."""
        key = id(sc.index_volume)
        if key not in tilings:
            tilings[key] = block_words(sc.index_volume)
        if tag == "csrc":
            fn, words = lib_csrc.traverse_launch, sc.index_volume
        elif tag in (*old_sig, "parent"):
            fn, words = libs[tag][0].traverse_launch, sc.index_volume
        else:
            fn, words = libs[tag][0].variant_launch, tilings[key]
        n_dev = torch.full((1,), inputs[0].shape[0], dtype=torch.int32,
                           device=dev)
        a = ktrav.launch_args(inputs, words, sc, cam, grid, steps, out,
                              stream, n_dev)
        if tag != "csrc" and not (tag == "parent" and parent_count):
            a = a[:1] + a[2:]     # the launchers without the count
        if tag not in ("csrc", "parent", *old_sig):
            a = a[:6] + (sc.index_volume.data_ptr(),) + a[6:-1] + (
                None if counters is None else counters.data_ptr(), bps,
                stream)

        def run():
            build.check(fn(*a), f"B2 {tag}")
        run.keep = n_dev
        return run

    # The shapes.
    w, h = cfg.render.width, cfg.render.height
    cam0 = benchmark.benchmark_cameras()[0]
    cam = tuple(int(c) for c in cam0.brick_position)
    sun = benchmark.ss.sun_direction_from_position(benchmark.SUN_POSITION,
                                                    dev)
    arrays = camera_arrays_for(cam0, sun, w, h, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = draw_wave_uniforms(w * h, 0, gen, dev)
    o0, d0 = primary_rays_from_arrays(u["stratum"], u["jitter"], u["lens"],
                                      arrays, torch.arange(w * h, device=dev),
                                      w, h)
    calls = []
    orig_gather = kwave.gather_clip

    def capture(rays_o, rays_d, lanes, count, g, pos=None):
        rows = lanes[:int(count)].long()    # a trace's rays
        calls.append((rays_o[rows].clone(), rays_d[rows].clone()))
        return orig_gather(rays_o, rays_d, lanes, count, g, pos)

    capture.events, capture.launches = None, 0    # the wrapper's hooks
    kwave.gather_clip = capture
    gen.manual_seed(0)
    pathtrace.render_wave(world, arrays, cam0.brick_position, cfg, w, h,
                          generator=gen)
    torch.cuda.synchronize()
    kwave.gather_clip = orig_gather
    print(f"view 0's first wave: {len(calls)} trace calls of "
          f"{[c[0].shape[0] for c in calls]} rays", flush=True)
    cold = StreamingScene(world, grid, queue_size=1024, device=dev)
    csc = cold.device_scene()
    gen.manual_seed(0)
    u = draw_wave_uniforms(w * h, cfg.render.max_bounces, gen, dev)
    perm_np, _ = pathtrace._tile_permutation(w, h)
    o8, d8 = primary_rays_from_arrays(
        u["stratum"], u["jitter"], u["lens"], arrays,
        torch.from_numpy(perm_np.copy()).to(dev), w, h)
    shapes = {"primaries": (o0, d0, world), "bounce 1": (*calls[1][:2], world),
              "shadow": (*calls[-1][:2], world),
              "streaming primaries": (o8, d8, csc)}
    del calls, u

    builds = ["base"] + (["parent"] if args.parent else []) + ["csrc"] \
        + specs
    rows, sweeps = [], []
    for tag, (o, d, sc) in shapes.items():
        n = o.shape[0]
        want = trace_rays(o, d, sc.index_volume, sc.pool_words, sc.pool_base,
                          cam, grid, max_iters=budget)
        steps = want["ray_iters"]
        cells, brows = int(want["cells_read"].sum()), \
            int(want["rows_read"].sum())
        nbytes = n * RAY_BYTES + 4 * cells + 64 * brows
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = int(steps.sum()) * DDA_STEP_OPS / F32_OPS_PER_S * 1e3
        copies = [ktrav.launch_inputs(o, d, grid)] + [
            ktrav.launch_inputs(o.clone(), d.clone(), grid)
            for _ in range(benchmark.hbm_copies(RAY_BYTES * n, dev) - 1)]
        for bt in builds:
            inputs, out = ktrav.launch_inputs(o, d, grid)
            runner(bt, inputs, out, sc, cam)()
            torch.cuda.synchronize()
            for k in KEYS:
                if not torch.equal(out[k], want[k]):
                    raise SystemExit(f"{tag}: {bt} {k} differs from the "
                                     f"plain version")
        fw = -(-block_words(sc.index_volume).numel() // 8 // 32)  # a map
        counters = torch.zeros(16 + 2 * fw, dtype=torch.int64, device=dev)
        counters[12] = fw
        inputs, out = ktrav.launch_inputs(o, d, grid)
        runner("count", inputs, out, sc, cam, counters=counters)()
        c = counters[:12].tolist()
        maps = np.unpackbits(counters[16:].cpu().numpy().view(np.uint8))
        footprint = [int(m.sum()) for m in maps.reshape(4, -1)]
        stamps = torch.zeros(8, dtype=torch.int64, device=dev)
        runner("clock", inputs, out, sc, cam, counters=stamps)()
        ck = stamps.tolist()
        clock_ms = benchmark.kernel_alone_ms(
            [runner("clock", inputs, out, sc, cam, counters=stamps)], 5)
        clock = {"thread_cycles": ck[0], "index_wait": ck[1] / max(ck[0], 1),
                 "row_wait": ck[2] / max(ck[0], 1),
                 "descend": ck[3] / max(ck[0], 1),
                 "cycles_per_index_load": ck[1] / max(ck[4], 1),
                 "cycles_per_row_load": ck[2] / max(ck[5], 1),
                 "cycles_per_descend": ck[3] / max(ck[6], 1),
                 "cycles_per_thread": ck[0] / n, "ms": clock_ms}
        lines = {
            "index_gathers": c[0],
            "index_lines_volume": c[1] / max(c[0], 1),
            "index_lines_blocks": c[2] / max(c[0], 1),
            "index_lanes": c[3] / max(c[0], 1),
            "row_word_gathers": c[4], "row_word_lines": c[5] / max(c[4], 1),
            "row_word_lanes": c[7] / max(c[4], 1),
            "descend_gathers": c[8], "row_lines": c[9] / max(c[8], 1),
            "descend_lanes": c[11] / max(c[8], 1),
            "footprint_lines_volume": footprint[0],
            "footprint_sectors_volume": footprint[1],
            "footprint_lines_blocks": footprint[2],
            "footprint_sectors_blocks": footprint[3]}
        times = {bt: [] for bt in builds}
        for bt in builds + builds[::-1]:
            runs = [runner(bt, inp, outp, sc, cam) for inp, outp in copies]
            times[bt].append(benchmark.kernel_alone_ms(runs, args.reps))
        row = {"shape": tag, "rays": n, "copies": len(copies),
               "steps": int(steps.sum()),
               "simd": benchmark.launch_order_simd(steps),
               "exhausted": int(want["exhausted"].sum()),
               "requests": int(want["request"].sum()),
               "distinct_words": cells, "distinct_rows": brows,
               "word_reads": int(want["ray_words"].sum()),
               "row_reads": int(want["ray_bricks"].sum()),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "lines": lines, "clock": clock, "ms": times}
        rows.append(row)
        print(f"== {tag}: {n} rays ({len(copies)} copies in turn), "
              f"{row['steps']} steps, SIMD {row['simd']:.4f}, exhausted "
              f"{row['exhausted']}, requests {row['requests']}; distinct "
              f"{cells} words + {brows} rows -> bound {row['bound_ms']:.4f} "
              f"ms by {row['bound_by']}", flush=True)
        print(f"  lines per warp gather: index words "
              f"{lines['index_lines_volume']:.3f} (index_volume) vs {lines['index_lines_blocks']:.3f} "
              f"(block_words) over {c[0]} gathers of "
              f"{lines['index_lanes']:.2f} lanes; per-step row words "
              f"{lines['row_word_lines']:.3f} over {c[4]} gathers of "
              f"{lines['row_word_lanes']:.2f} lanes; whole rows "
              f"{lines['row_lines']:.3f} over {c[8]} descends of "
              f"{lines['descend_lanes']:.2f} lanes; index words' footprint "
              f"{footprint[0]} lines / {footprint[1]} sectors "
              f"(index_volume) vs {footprint[2]} / {footprint[3]} "
              f"(block_words)", flush=True)
        print(f"  clock64 build ({clock_ms:.4f} ms a launch, per thread, "
              f"summed): {clock['cycles_per_thread']:.0f} "
              f"cycles a ray; waiting on index words {clock['index_wait']:.1%}"
              f" ({clock['cycles_per_index_load']:.0f} a load), on row words "
              f"{clock['row_wait']:.1%} ({clock['cycles_per_row_load']:.0f} a "
              f"load), inside descends {clock['descend']:.1%} "
              f"({clock['cycles_per_descend']:.0f} a descend)", flush=True)
        print("  ms (turns there and back): " + ", ".join(
            f"{bt} {v[0]:.4f}/{v[1]:.4f}" for bt, v in times.items()),
            flush=True)
        for k in (int(x) for x in args.blocks_per_sm.split(",") if x):
            if tag not in ("primaries", "bounce 1"):
                break
            ms = {bt: benchmark.kernel_alone_ms(
                [runner(bt, inp, outp, sc, cam, bps=k)
                 for inp, outp in copies], args.reps) for bt in sweep}
            sweeps.append({"shape": tag, "blocks_per_sm": k, "ms": ms})
            print(f"  at most {k} blocks of 128 an SM: " + ", ".join(
                f"{bt} {v:.4f} ms" for bt, v in ms.items()), flush=True)
        del copies, want

    phase5 = None
    orig_trace = ktrav.trace_clipped
    if not args.no_phase5:
        # Phase 5's waves (a warm-up and a timed one a view, their seeds),
        # each B2 launch of the wave made by build ``tag`` between CUDA
        # events: B2 as the wave leaves the L2 for it.
        def wave_trace(tag, events):
            def tr(inputs, count, sc, cb, g, steps):
                out = ktrav._outputs(inputs[0].shape[0], inputs[0].device)
                n = int(count)      # the probe reads it; the wave does not
                inputs = tuple(a[:n] for a in inputs)
                if n:
                    e0, e1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    e0.record()
                    runner(tag, inputs, {k: v[:n] for k, v in out.items()},
                           sc, tuple(int(c) for c in cb), steps=steps)()
                    e1.record()
                    events.append((e0, e1))
                out["iters"] = out["ray_iters"].amax() if n else \
                    torch.zeros((), dtype=torch.int32, device=dev)
                return out
            return tr

        def phase5_waves(tag):
            events, images = [], []
            ktrav.trace_clipped = wave_trace(tag, events)
            try:
                for vi, cm in enumerate(benchmark.benchmark_cameras()):
                    arr = camera_arrays_for(cm, sun, w, h, dev)
                    g = torch.Generator(device=dev)
                    g.manual_seed(vi)
                    for _ in range(2):
                        images.append(pathtrace.render_wave(
                            world, arr, cm.brick_position, cfg, w, h,
                            generator=g)[0])
            finally:
                ktrav.trace_clipped = orig_trace
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in events), len(events), \
                images

        order = ["base"] + (["parent"] if args.parent else []) + ["csrc"] \
            + [t for t in args.phase5.split(",") if t]
        sums = {bt: [] for bt in order}
        ref_images = None
        for bt in order + order[::-1]:
            ms, launches, images = phase5_waves(bt)
            if ref_images is None:
                ref_images = images
            elif not all(torch.equal(a, b) for a, b in zip(images,
                                                            ref_images)):
                raise SystemExit(f"phase 5's waves through {bt} differ from "
                                 f"those through the baseline's B2")
            sums[bt].append(ms)
        phase5 = {"launches": launches, "ms": sums}
        print(f"== phase 5's 18 waves, {launches} B2 launches, B2's sum in "
              f"the waves (there and back): " + ", ".join(
                  f"{bt} {v[0]:.4f}/{v[1]:.4f} ms" for bt, v in sums.items()),
              flush=True)
    after = smi("name,power.limit,clocks.sm,clocks.max.sm")
    print(after)
    print(json.dumps({"probe": "b2", "card": card, "sm_ghz": ghz,
                      "rows": rows, "sweep": sweeps, "phase5": phase5,
                      "loops": {k: v for k, v in loops.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
