#!/usr/bin/env python3
"""Probe: how the schedule of kernels B2 (traversal, ``csrc/traverse.cu``)
and B3 (segment recorder, ``csrc/record.cu``) spends the warps' lanes, and
what launch bounds, a ray sort and other schedules would change.

    python3 notes/probe_torch_b2b3_schedule.py      # one CUDA card, ~1 min

Builds ``notes/probe_torch_b2b3_schedule.cu`` (B2 and B3 in their first
design, one thread per ray in launch order) four times, with no launch
bounds' minimum and with ``__launch_bounds__(128, m)`` for m = 10, 12, 16,
and prints each build's ptxas lines (registers, stack, spills).  Then, on
the 4096^2 x 512 world built on the card:

* the shapes: view 0's primary rays (1920x1080, seed 0), the bounce-1 and
  the final shadow trace of view 0's first wave (captured by wrapping
  ``kernels.wave.gather_clip``), and phase 7's frame for B3 (2,073,600 rays, K = 8);
* SIMD efficiency of the launch-order schedule at each shape, from the
  kernel's own per-ray step counts (B2's ``ray_iters``; B3's steps from
  its plain version, which it equals): sum of steps over the sum, over
  warps of 32 consecutive rays, of 32 times the warp's largest count;
* ms per launch of each build: CUDA events around 5 launches of the
  launcher alone, back to back (so the host's time to issue a launch does
  not count), 3 rounds interleaved, the L2 warm;
* the rays presorted by direction octant, then by the Morton code of the
  origin brick: the sort's own time (key, argsort and the gather of the
  rays), the SIMD efficiency of that order and the first design's ms on it.

Then the designs that replace them, each held bit-equal to the first
design at every shape and timed in turns with it (CUDA events around the
launcher alone):

* the kernels in ``csrc/traverse.cu`` and ``csrc/record.cu`` as built,
  checked through their wrappers and timed by their launchers as the first
  designs are;
* ``--refill R:b,...`` (default none; ``8:1,16:1,32:1`` were measured):
  persistent warps that refill finished lanes from a global counter,
  ``notes/probe_torch_b2b3_refill_{traverse,record}.cu``, with refill
  threshold R (``BM_*_REFILL``), batch ``--batch`` (``PROBE_BATCH``) and
  launch bounds' minimum b; their SIMD efficiency counted by the kernels'
  counting builds (a warp's step is the most steps any lane took in one
  loop iteration, so B2's descends of different lengths count against it);
* ``--variants S?L?B?[E?][N?],...`` (default none): B2's kernel as in
  ``csrc/traverse.cu`` built from ``notes/probe_torch_b2b3_variants.cu``
  with its pointers as separate ``__restrict__`` arguments (S0) or in
  structs (S1), the scene's reads through ``__ldg`` (L1) or not (L0),
  launch bounds' minimum B blocks an SM, a hit's outputs written where
  it is found (E1), and the entry normal read where it is used (N1); with each build's SASS instruction count and its load
  and store opcodes (``cuobjdump -sass``), and with ``--sass-dir`` each
  build's whole SASS listing written there.

Every build is first held bit-equal, on every output, to the plain version
(primaries, B3's frame) or to the unbounded build (the other shapes).
Imports torch and the port only.

    python3 notes/probe_torch_b2b3_schedule.py --refill 8:1,32:1 --batch 32
    python3 notes/probe_torch_b2b3_schedule.py --variants S0L0B0,S1L1B0
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

MIN_BLOCKS = (0, 10, 12, 16)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build_old(build) -> dict:
    """The first-design library for each MIN_BLOCKS value, built in
    parallel; prints the ptxas lines of each."""
    procs = {}
    for m in MIN_BLOCKS:
        out = os.path.join(build.BUILD_DIR, f"libprobe_b2b3_lb{m}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DPROBE_MIN_BLOCKS={m}",
               "-I", HERE, "-o", out,
               os.path.join(HERE, "probe_torch_b2b3_schedule.cu")]
        procs[m] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    libs = {}
    for m, (out, proc) in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc, min blocks {m}:\n{se}")
        for line in build._summary(so + se):
            print(f"  ptxas lb{m}: {line}")
        lib = ctypes.CDLL(out)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.old_traverse_launch.argtypes = ([i] + [p] * 8 + [i] * 12
                                            + [f, i] + [p] * 9)
        lib.old_traverse_launch.restype = i
        lib.old_record_launch.argtypes = [i, i] + [p] * 5 + [i] * 6 + [p] * 7
        lib.old_record_launch.restype = i
        libs[m] = lib
    return libs


def nvcc_all(build, jobs) -> dict:
    """Build each (key, source, defines, library name) job in parallel and
    print its ptxas lines; returns {key: CDLL}."""
    procs = {}
    for key, src, defines, name in jobs:
        out = os.path.join(build.BUILD_DIR, f"lib{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS,
               *(f"-D{d}" for d in defines), "-I", build.CSRC, "-I", HERE,
               "-o", out, src]
        procs[key] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key}:\n{se}")
        for line in build._summary(so + se):
            print(f"  ptxas {key}: {line}")
        libs[key] = ctypes.CDLL(out)
    return libs


SASS_DIR = None   # --sass-dir: where each build's SASS listing goes


def sass_report(build, path: str, tag: str) -> None:
    """Print the SASS instruction count of each kernel in ``path`` and the
    count of each load and store opcode (global, local, shared)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True)
    if res.returncode != 0:
        print(f"  sass {tag}: cuobjdump failed: {res.stderr.strip()[:200]}")
        return
    if SASS_DIR:
        os.makedirs(SASS_DIR, exist_ok=True)
        with open(os.path.join(SASS_DIR, f"{tag.replace(' ', '_')}.sass"),
                  "w") as f:
            f.write(res.stdout)
    kernel, ops = None, collections.Counter()

    def flush():
        if kernel is not None:
            mem = ", ".join(f"{k} {v}" for k, v in sorted(ops.items())
                            if re.match(r"(LD|ST)[GLS]?\b|(LD|ST)[GLS]\.",
                                        k))
            print(f"  sass {tag} {kernel[-40:]}: {sum(ops.values())} "
                  f"instructions; {mem}", flush=True)

    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            kernel, ops = m.group(1), collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m and kernel is not None:
            ops[m.group(1)] += 1
    flush()


def build_variants(build, specs) -> dict:
    """B2's kernel built from probe_torch_b2b3_variants.cu for each spec
    S<struct>L<ldg>B<min blocks>, in parallel; prints each build's SASS
    report."""
    jobs = []
    for spec in specs:
        m = re.fullmatch(r"S([01])L([01])B(\d+)(?:E([01]))?(?:N([01]))?",
                         spec)
        if not m:
            raise SystemExit(f"bad variant {spec!r}")
        jobs.append((spec, os.path.join(HERE, "probe_torch_b2b3_variants.cu"),
                     (f"PROBE_STRUCT={m.group(1)}", f"PROBE_LDG={m.group(2)}",
                      f"PROBE_MIN_BLOCKS={m.group(3)}",
                      f"PROBE_EARLY_OUT={m.group(4) or 0}",
                      f"PROBE_LAZY_NORMAL={m.group(5) or 0}"),
                     f"probe_b2_variant_{spec}"))
    libs = nvcc_all(build, jobs)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for spec, lib in libs.items():
        lib.variant_traverse_launch.argtypes = ([i] + [p] * 8 + [i] * 12
                                                + [f, i] + [p] * 9)
        lib.variant_traverse_launch.restype = i
        sass_report(build, os.path.join(build.BUILD_DIR,
                                        f"libprobe_b2_variant_{spec}.so"),
                    spec)
    return libs


def build_refill(build, refills, batch) -> dict:
    """The refill probe kernels for each (R, b), in parallel."""
    jobs = []
    for r, b in refills:
        for name, mac in (("traverse", "TRAVERSE"), ("record", "RECORD")):
            jobs.append(((name, "R", r, b),
                         os.path.join(HERE,
                                      f"probe_torch_b2b3_refill_{name}.cu"),
                         (f"BM_{mac}_REFILL={r}", f"BM_{mac}_MIN_BLOCKS={b}",
                          f"PROBE_BATCH={batch}"),
                         f"probe_refill_{name}_r{r}_b{b}"))
    libs = nvcc_all(build, jobs)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for key, lib in libs.items():
        if key[0] == "traverse":
            lib.traverse_launch.argtypes = ([i, i, p, p] + [p] * 8 + [i] * 12
                                            + [f, i] + [p] * 9)
            lib.traverse_launch.restype = i
            lib.traverse_resident_blocks.argtypes = [i]
            lib.traverse_resident_blocks.restype = i
        else:
            lib.record_launch.argtypes = ([i, i, p, p, i] + [p] * 5
                                          + [i] * 6 + [p] * 7)
            lib.record_launch.restype = i
            lib.record_resident_blocks.argtypes = [i, i]
            lib.record_resident_blocks.restype = i
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--refill", default="")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--variants", default="")
    ap.add_argument("--sass-dir", default=None)
    args = ap.parse_args()
    global SASS_DIR
    SASS_DIR = args.sass_dir

    def pairs(text):
        return [tuple(int(x) for x in v.split(":"))
                for v in text.split(",") if v]

    refills = pairs(args.refill)

    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import preset_full
    from brickmap_tpu_torch.kernels import build, record as krec, \
        traverse as ktrav, wave as kwave
    from brickmap_tpu_torch.ops.record import record_segments_plain
    from brickmap_tpu_torch.ops.traverse import aabb_clip, trace_rays
    from brickmap_tpu_torch.render import pathtrace
    from brickmap_tpu_torch.render.camera import camera_arrays_for, \
        primary_rays_from_arrays
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    print(smi(), flush=True)
    build.build()
    for name in ("traverse", "record"):
        for line in build.ptxas_summary.get(name, []):
            print(f"  ptxas csrc {name}: {line}")
    libs = build_old(build)
    sass_report(build, build.lib_path("traverse"), "csrc")
    sass_report(build, os.path.join(build.BUILD_DIR, "libprobe_b2b3_lb0.so"),
                "first design")
    new_libs = build_refill(build, refills, args.batch)
    variants = build_variants(build, [v for v in args.variants.split(",")
                                      if v])
    stream = torch.cuda.current_stream().cuda_stream
    cfg = preset_full()
    grid = cfg.grid
    world = scene_mod.generate_terrain_scene(grid, device=dev)
    budget = cfg.render.trace_budget

    def b2_launch(fn, o, d, cam, prefix=(), counter=None):
        """A launch of B2's launcher ``fn`` on (o, d), ``prefix`` after n;
        the counter, if any, zeroed before each launch.  Returns (launch,
        out)."""
        ok, tminn, clipped, en = aabb_clip(o, d, grid)
        clipped, en = clipped.contiguous(), en.contiguous()
        n = o.shape[0]
        out = {"hit": torch.empty(n, dtype=torch.bool, device=dev),
               "t": torch.empty(n, device=dev),
               "normal": torch.empty((n, 3), device=dev),
               "request": torch.empty(n, dtype=torch.bool, device=dev),
               "request_pos": torch.empty((n, 3), dtype=torch.int32,
                                          device=dev),
               "exhausted": torch.empty(n, dtype=torch.bool, device=dev),
               "resume_t": torch.empty(n, device=dev),
               "ray_iters": torch.empty(n, dtype=torch.int32, device=dev)}
        args = (n, *prefix, clipped.data_ptr(), d.data_ptr(), en.data_ptr(),
                tminn.data_ptr(), ok.data_ptr(),
                world.index_volume.data_ptr(), world.pool_words.data_ptr(),
                world.pool_base.data_ptr(), grid.cells, grid.cells,
                grid.cells_height, grid.supergrid_cell_size,
                grid.supergrid_xy, grid.num_superchunks, *cam,
                grid.lod_distance_8, grid.lod_distance_2, grid.brick_size,
                grid.epsilon, budget, *(v.data_ptr() for v in out.values()),
                stream)

        def launch():
            if counter is not None:
                counter.zero_()
            build.check(fn(*args), "traverse_kernel")
        launch.keep = (clipped, en, tminn, ok, out)
        return launch, out

    def b3_launch(fn, o, d, k, prefix=(), counter=None):
        ok, _, clipped, _ = aabb_clip(o, d, grid)
        o_cells = (clipped / float(grid.brick_size)).contiguous()
        n = o.shape[0]
        out = {"cells": torch.empty((n, k), dtype=torch.int32, device=dev),
               "nd": torch.empty((n, k), device=dev),
               "ncode": torch.empty((n, k), dtype=torch.int32, device=dev),
               "count": torch.empty(n, dtype=torch.int32, device=dev),
               "exhausted": torch.empty(n, dtype=torch.bool, device=dev)}
        args = (n, *prefix, k, o_cells.data_ptr(), d.data_ptr(),
                ok.data_ptr(), world.index_volume.data_ptr(),
                world.pool_base.data_ptr(), grid.cells, grid.cells,
                grid.cells_height, grid.supergrid_cell_size,
                grid.supergrid_xy, krec.DEFAULT_MAX_STEPS,
                out["cells"].data_ptr(), out["nd"].data_ptr(),
                out["ncode"].data_ptr(), None, out["count"].data_ptr(),
                out["exhausted"].data_ptr(), stream)

        def launch():
            if counter is not None:
                counter.zero_()
            build.check(fn(*args), "record_kernel")
        launch.keep = (o_cells, ok, out)
        return launch, out

    def refill(lib, name, n, counting, k=0):
        """Launch prefix (blocks, counter, steps) of a refill probe kernel:
        the resident blocks, at most one ray per thread."""
        per = (lib.traverse_resident_blocks(int(counting)) if name ==
               "traverse" else lib.record_resident_blocks(k, int(counting)))
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        steps = torch.zeros(2, dtype=torch.int64, device=dev)
        return ((max(1, min(per, -(-n // 128))), counter.data_ptr(),
                 steps.data_ptr() if counting else None), counter, steps,
                per)

    simd = benchmark.launch_order_simd

    def timed(fn, reps=5):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def part1by2(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    def presort(o, d):
        """Permutation by direction octant, then Morton code of the origin
        brick (clamped into the grid)."""
        b = torch.floor(o / grid.brick_size).to(torch.int64)
        bx = b[:, 0].clamp(0, grid.cells - 1)
        by = b[:, 1].clamp(0, grid.cells - 1)
        bz = b[:, 2].clamp(0, grid.cells_height - 1)
        octant = ((d[:, 0] < 0).to(torch.int64)
                  | ((d[:, 1] < 0).to(torch.int64) << 1)
                  | ((d[:, 2] < 0).to(torch.int64) << 2))
        key = (octant << 32) | part1by2(bx) | (part1by2(by) << 1) \
            | (part1by2(bz) << 2)
        perm = torch.argsort(key)
        return perm, o[perm].contiguous(), d[perm].contiguous()

    # The shapes.
    w, h = cfg.render.width, cfg.render.height
    cam0 = benchmark.benchmark_cameras()[0]
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
    cam = tuple(int(c) for c in cam0.brick_position)
    b2_shapes = {"primaries": (o0.contiguous(), d0.contiguous()),
                 "bounce 1": calls[1], "shadow": calls[-1]}
    o7, d7 = benchmark.sparse_inverse_rays(w * h, grid, dev)[:2]

    keys2 = ("hit", "t", "normal", "request", "request_pos", "exhausted",
             "resume_t", "ray_iters")
    for tag, (o, d) in b2_shapes.items():
        print(f"== B2 {tag}: {o.shape[0]} rays", flush=True)
        launches = {}
        for m, lib in libs.items():
            launch, out = b2_launch(lib.old_traverse_launch, o, d, cam)
            launch()
            launches[f"lb{m}"] = (launch, out)
        torch.cuda.synchronize()
        ref = launches["lb0"][1]
        if tag == "primaries":
            want = trace_rays(o, d, world.index_volume, world.pool_words,
                              world.pool_base, cam, grid, max_iters=budget)
            for k in keys2:
                if not torch.equal(ref[k], want[k]):
                    raise SystemExit(f"B2 lb0 {tag}: {k} differs from plain")
        for name, (_, out) in launches.items():
            for k in keys2:
                if not torch.equal(out[k], ref[k]):
                    raise SystemExit(f"B2 {name} {tag}: {k} differs")
        steps = ref["ray_iters"]
        perm_ms = timed(lambda: presort(o, d))
        perm, os_, ds_ = presort(o, d)
        sorted_launch, sorted_out = b2_launch(libs[0].old_traverse_launch,
                                              os_, ds_, cam)
        sorted_launch()
        torch.cuda.synchronize()
        for k in keys2:
            if not torch.equal(sorted_out[k], ref[k][perm]):
                raise SystemExit(f"B2 presorted {tag}: {k} differs")
        print(f"  steps: total {int(steps.sum())}, mean "
              f"{float(steps.float().mean()):.2f}, max {int(steps.max())}; "
              f"SIMD efficiency in launch order {simd(steps):.4f}, "
              f"presorted {simd(steps[perm]):.4f}; the sort "
              f"{perm_ms:.4f} ms", flush=True)
        cases = {k: v[0] for k, v in launches.items()}
        cases["lb0 presorted"] = sorted_launch
        for rnd in range(3):
            line = [f"{k} {timed(f):.4f}" for k, f in cases.items()]
            print(f"  round {rnd} ms: " + ", ".join(line), flush=True)

        turns = {}
        got = ktrav.trace(o, d, world, cam, grid, budget)
        for k in keys2:
            if not torch.equal(got[k], ref[k]):
                raise SystemExit(f"B2 csrc {tag}: {k} differs")
        print("  csrc: equal", flush=True)
        n_dev = torch.full((1,), o.shape[0], dtype=torch.int32, device=dev)
        launch, _ = b2_launch(build.load("traverse", ktrav._bind)
                              .traverse_launch, o, d, cam,
                              (n_dev.data_ptr(),))
        launch.count = n_dev
        turns["csrc"] = launch
        for spec, lib in variants.items():
            launch, out = b2_launch(lib.variant_traverse_launch, o, d, cam)
            launch()
            torch.cuda.synchronize()
            for k in keys2:
                if not torch.equal(out[k], ref[k]):
                    raise SystemExit(f"B2 variant {spec} {tag}: {k} differs")
            print(f"  variant {spec}: equal", flush=True)
            turns[spec] = launch
        for r, b in refills:
            lib = new_libs[("traverse", "R", r, b)]
            prefix, counter, st, per = refill(lib, "traverse", o.shape[0],
                                              True)
            launch, out = b2_launch(lib.traverse_launch, o, d, cam, prefix,
                                    counter)
            launch()
            torch.cuda.synchronize()
            for k in keys2:
                if not torch.equal(out[k], ref[k]):
                    raise SystemExit(f"B2 R{r} b{b} {tag}: {k} differs")
            warp, lane = st.tolist()
            prefix, counter, _, _ = refill(lib, "traverse", o.shape[0], False)
            launch, _ = b2_launch(lib.traverse_launch, o, d, cam, prefix,
                                  counter)
            print(f"  R{r} b{b}: equal; {per} blocks resident; SIMD "
                  f"efficiency {lane / (32 * warp):.4f} (lane steps {lane}, "
                  f"warp steps {warp})", flush=True)
            turns[f"R{r} b{b}"] = launch
        for rnd in range(3):
            line = [f"first design {timed(cases['lb0']):.4f}"]
            line += [f"{k} {timed(f):.4f}" for k, f in turns.items()]
            line.append(f"first design {timed(cases['lb0']):.4f}")
            print(f"  round {rnd} ms: " + ", ".join(line), flush=True)
        del launches, cases, sorted_launch, sorted_out, ref

    K = benchmark.SPARSE_K
    print(f"== B3 phase 7's frame: {o7.shape[0]} rays, K = {K}", flush=True)
    launches = {}
    for m, lib in libs.items():
        launch, out = b3_launch(lib.old_record_launch, o7, d7, K)
        launch()
        launches[f"lb{m}"] = (launch, out)
    torch.cuda.synchronize()
    want = record_segments_plain(o7, d7, world, grid, k_segments=K)
    for name, (_, out) in launches.items():
        for k, v in out.items():
            if not torch.equal(v, want[k]):
                raise SystemExit(f"B3 {name}: {k} differs from plain")
    steps = want["ray_words"]
    perm_ms = timed(lambda: presort(o7, d7))
    perm, os_, ds_ = presort(o7, d7)
    sorted_launch, sorted_out = b3_launch(libs[0].old_record_launch, os_,
                                          ds_, K)
    sorted_launch()
    torch.cuda.synchronize()
    for k, v in sorted_out.items():
        if not torch.equal(v, want[k][perm]):
            raise SystemExit(f"B3 presorted: {k} differs")
    print(f"  steps: total {int(steps.sum())}, mean "
          f"{float(steps.float().mean()):.2f}, max {int(steps.max())}; SIMD "
          f"efficiency in launch order {simd(steps):.4f}, presorted "
          f"{simd(steps[perm]):.4f}; the sort {perm_ms:.4f} ms", flush=True)
    cases = {k: v[0] for k, v in launches.items()}
    cases["lb0 presorted"] = sorted_launch
    for rnd in range(3):
        line = [f"{k} {timed(f):.4f}" for k, f in cases.items()]
        print(f"  round {rnd} ms: " + ", ".join(line), flush=True)

    turns = {}
    got = krec.record_segments(o7, d7, world, grid, k_segments=K)
    for k, v in got.items():
        if k in want and not torch.equal(v, want[k]):
            raise SystemExit(f"B3 csrc: {k} differs from plain")
    print("  csrc: equal", flush=True)
    launch, _ = b3_launch(build.load("record", krec._bind).record_launch,
                          o7, d7, K)
    turns["csrc"] = launch
    for r, b in refills:
        lib = new_libs[("record", "R", r, b)]
        prefix, counter, st, per = refill(lib, "record", o7.shape[0], True, K)
        launch, out = b3_launch(lib.record_launch, o7, d7, K, prefix, counter)
        launch()
        torch.cuda.synchronize()
        for k, v in out.items():
            if not torch.equal(v, want[k]):
                raise SystemExit(f"B3 R{r} b{b}: {k} differs from plain")
        warp, lane = st.tolist()
        prefix, counter, _, _ = refill(lib, "record", o7.shape[0], False, K)
        launch, _ = b3_launch(lib.record_launch, o7, d7, K, prefix, counter)
        print(f"  R{r} b{b}: equal; {per} blocks resident; SIMD efficiency "
              f"{lane / (32 * warp):.4f} (lane steps {lane}, warp steps "
              f"{warp})", flush=True)
        turns[f"R{r} b{b}"] = launch
    for rnd in range(3):
        line = [f"first design {timed(cases['lb0']):.4f}"]
        line += [f"{k} {timed(f):.4f}" for k, f in turns.items()]
        line.append(f"first design {timed(cases['lb0']):.4f}")
        print(f"  round {rnd} ms: " + ", ".join(line), flush=True)
    print(smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
