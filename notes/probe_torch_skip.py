#!/usr/bin/env python3
"""Probe: the kernels that share B2's top step (csrc/dda.cuh::top_step) --
B3 (csrc/record.cu) and W4 (csrc/wave.cu's rescue) -- as this tree builds
them against another tree's builds of the same sources, in turns.

    python3 notes/probe_torch_skip.py [--defines BM_SKIP=1] \\
        --parent checkout/parent/brickmap_tpu_torch/csrc   # one CUDA card

Both trees' ``record.cu`` and ``wave.cu`` are built with the port's nvcc
flags, this tree's with ``-D`` of each of ``--defines`` (ptxas lines
printed; with ``BM_SKIP``, from a copy of csrc/ whose dda.cuh is
``notes/probe_torch_b2_skip_dda.cuh``); the other tree is the parent
commit's, unpacked with ``git archive`` into a gitignored directory.  The
launchers' signatures are this tree's, so the wrappers of
``kernels/record.py`` and ``kernels/wave.py`` drive either build: the
probe puts one or the other in the build module's table of loaded
libraries.  On the 4096^2 x 512 world built on the card:

* B3 (``record_segments``, K = 8) on phase 7's frame, 2,073,600 rays of
  ``app/benchmark.py::sparse_inverse_rays``: both builds' outputs equal to
  the plain version's; each timed alone, queued behind a device sleep
  over copies of the rays that exceed the L2;
* W4 (``rescue``) on view 0's primaries traced at 16 steps, every
  exhausted ray rescued with the wave's budget: both builds equal to
  ``ops/wave.py::rescue_plain``; W4 rewrites its inputs, so each launch
  follows copies that restore them; and at a count of 0 over the capacity
  (``kernel_alone_ms``).

Each timed alone: the calls queued behind a device sleep, CUDA events
around each call (restoring copies outside them).

Turns: parent, this tree, this tree, parent.  A JSON line with every
number ends the output.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

STARVED_STEPS = 16      # as chip_smoke.py phase 5


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other tree's brickmap_tpu_torch/csrc")
    ap.add_argument("--defines", default="",
                    help="comma list of -D defines for this tree's builds")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    import probe_torch_b2
    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import preset_full
    from brickmap_tpu_torch.kernels import build, record as krec, \
        traverse as ktrav, wave as kwave
    from brickmap_tpu_torch.ops import wave as owave
    from brickmap_tpu_torch.ops.record import record_segments_plain
    from brickmap_tpu_torch.render import pathtrace
    from brickmap_tpu_torch.render.camera import camera_arrays_for
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_skip: needs a CUDA device")
    dev = torch.device("cuda")
    card = smi()
    print(card, flush=True)
    build.build(("traverse",), force=True)
    defines = [f"-D{d}" for d in args.defines.split(",") if d]
    new_csrc = probe_torch_b2.skip_overlay(build) if any(
        "BM_SKIP" in d for d in defines) else build.CSRC
    trees = {"parent": (os.path.abspath(args.parent), []),
             "new": (new_csrc, defines)}
    procs = {}
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    for tag, (csrc, flags) in trees.items():
        for name in ("record", "wave"):
            out = os.path.join(build.BUILD_DIR,
                               f"libprobe_skip_{tag}_{name}.so")
            procs[tag, name] = (out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", out,
                 os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {"parent": {}, "new": {}}
    for (tag, name), (out, proc) in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {tag} {name}:\n{se}")
        for line in build._summary(so + se):
            print(f"  ptxas {tag} {name}: {line}")
        lib = ctypes.CDLL(out)
        (krec._bind if name == "record" else kwave._bind)(lib)
        libs[tag][name] = lib

    def use(tag):
        build._libs.update(libs[tag])

    def queued_ms(runs, reps, before=None):
        """Mean device ms of a launch: ``reps`` calls taking ``runs`` in
        turn, queued behind a device sleep long enough for the host to
        enqueue them all (the wrappers allocate their outputs), CUDA events
        around each call and ``before`` (restoring copies) outside them."""
        for run in runs:
            run()
        torch.cuda.synchronize()
        torch.cuda._sleep(10 * benchmark.SLEEP_CYCLES)
        pairs = []
        for k in range(reps):
            if before is not None:
                before()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            runs[k % len(runs)]()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(x.elapsed_time(y) for x, y in pairs) / reps

    cfg = preset_full()
    grid = cfg.grid
    world = scene_mod.generate_terrain_scene(grid, device=dev)
    turns = ("parent", "new", "new", "parent")
    res = {"card": card}

    # B3 on phase 7's frame.
    w, h = cfg.render.width, cfg.render.height
    o7, d7, _, _ = benchmark.sparse_inverse_rays(w * h, grid, dev)
    want = record_segments_plain(o7, d7, world, grid, k_segments=8)
    for tag in ("parent", "new"):
        use(tag)
        got = krec.record_segments(o7, d7, world, grid, k_segments=8)
        torch.cuda.synchronize()
        for k, v in want.items():
            if k in got and not torch.equal(got[k], v):
                raise SystemExit(f"B3 {tag}: {k} differs from the plain "
                                 f"version")
    copies = [(o7, d7)] + [(o7.clone(), d7.clone()) for _ in range(
        benchmark.hbm_copies(o7.numel() * 8, dev) - 1)]
    b3 = {}
    for tag in turns:
        use(tag)
        b3.setdefault(tag, []).append(queued_ms(
            [lambda o=o, d=d: krec.record_segments(o, d, world, grid,
                                                   k_segments=8)
             for o, d in copies], args.reps))
    res["b3_ms"] = b3
    print(f"B3 at {w * h} rays, K = 8, queued (both equal to the plain "
          f"version): " + ", ".join(f"{t} {v}" for t, v in b3.items()),
          flush=True)
    del want, copies

    # W4 on view 0's starved primaries.
    cam0 = benchmark.benchmark_cameras()[0]
    cam_b = cam0.brick_position
    sun = benchmark.ss.sun_direction_from_position(benchmark.SUN_POSITION,
                                                    dev)
    arrays = camera_arrays_for(cam0, sun, w, h, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = draw_wave_uniforms(w * h, cfg.render.max_bounces, gen, dev)
    perm = pathtrace._tile_order(w, h, dev)
    st = owave.new_state(w * h, dev)
    kwave.primary(perm, u, arrays, w, h, st)
    lanes, count = kwave.compact(st["live"])
    sres = ktrav.trace_clipped(
        kwave.gather_clip(st["rays_o"], st["rays_d"], lanes, count, grid),
        count, world, cam_b, grid, STARVED_STEPS)
    rows, n_rows = kwave.compact(sres["exhausted"], count)
    budget, passes = pathtrace.rescue_budget(cfg), pathtrace.RESCUE_PASSES
    saved = {k: v.clone() for k, v in sres.items()}
    want = {k: v.clone() for k, v in saved.items()}
    owave.rescue_plain(want, rows, n_rows, lanes, st["rays_o"], st["rays_d"],
                       world, cam_b, grid, budget, passes)
    work = {k: v.clone() for k, v in saved.items()}
    m = int(count)

    def restore():
        for k, v in saved.items():
            work[k].copy_(v)

    def rescue(cnt):
        kwave.rescue(work, rows, cnt, lanes, st["rays_o"], st["rays_d"],
                     world, cam_b, grid, budget, passes)

    for tag in ("parent", "new"):
        use(tag)
        restore()
        rescue(n_rows)
        torch.cuda.synchronize()
        for k in owave.RESCUE_KEYS:
            if not torch.equal(work[k][:m], want[k][:m]):
                raise SystemExit(f"W4 {tag}: {k} differs from the plain "
                                 f"rescue passes")

    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    w4, w4z = {}, {}
    for tag in turns:
        use(tag)
        w4.setdefault(tag, []).append(queued_ms([lambda: rescue(n_rows)],
                                                10, restore))
        w4z.setdefault(tag, []).append(benchmark.kernel_alone_ms(
            [lambda: rescue(zero)], 50))
    res.update(w4_rays=int(n_rows), w4_ms=w4, w4_zero_ms=w4z)
    print(f"W4 on {int(n_rows)} of {m} primaries exhausted at "
          f"{STARVED_STEPS} steps (both equal to the plain passes), queued: "
          + ", ".join(f"{t} {v}" for t, v in w4.items())
          + "; at a count of 0: "
          + ", ".join(f"{t} {v}" for t, v in w4z.items()), flush=True)
    res["defines"] = defines
    use("new")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
