#!/usr/bin/env python3
"""Probe: kernel B1 (the 8^3 brick DDA) alone, its first design against the
one in ``csrc/brick.cu``, in turns.

    python3 notes/probe_torch_b1.py [--sass-dir DIR] [--reps 50]
                                    [--blocks-per-sm 1,2,4]   # one card

Builds ``notes/probe_torch_b1_first.cu`` (B1's first design, one thread per
ray, ``sub_dda`` of ``csrc/dda.cuh``), ``csrc/brick.cu`` and
``notes/probe_torch_b1_variants.cu`` (``csrc/brick.cu`` included whole, with
a chosen number of blocks an SM, and the candidate taking 4 rays a thread
with 16-byte loads and vector stores) with the port's nvcc flags, and prints
each build's ptxas lines.  With ``--sass-dir`` each library's
``cuobjdump -sass`` listing is written there, and every loop of each kernel
(a back-edge branch to a lower address) is printed with its instruction
count, its float compares and its shared loads: the inner DDA loop is the
short loop with both.

Then, at each shape:

* (a) ``bench.py::_pallas_brick_bench``'s stage: 2,097,152 rays at density
  0.12 (``app/benchmark.py::brick_benchmark_rays``);
* (b) ``chip_smoke.py`` phase 3's 1,048,576 random rays (origins uniform
  in [-0.1, 8.1]^3, unit directions; numpy seed 0) at densities 0.12, 0.5
  and 0.9;
* (c) config 1's render: the 65,536 clipped camera rays of
  ``render_single_brick`` at 256x256, density 0.3 (launch-bound);
* diagnostics: (a)'s rays against a full brick (each stops in its entry
  cell: setup and bytes only) and an empty one (each walks to its exit);

every build is held bit-equal to the plain version on hit, t and axis; the
plain version's steps give the bound (bytes: 24 B in and 9 B out a ray and
the 64-byte brick; operations: 12 a step) and the launch-order SIMD
efficiency (32 consecutive rays a warp, both designs); then each launcher
alone is timed (``app/benchmark.py::kernel_alone_ms``: ``--reps`` launches
queued behind a device sleep, CUDA events around them) over
``hbm_copies`` copies of the rays taken in turn, so that every launch
reads and writes HBM, not a warm L2; in turns: first, new, 4 rays a
thread, then the same backwards.  The wrapper's host ms per call is
measured behind a device sleep.  With ``--blocks-per-sm``, shape (a) again
at each cap of blocks an SM, 1 and 4 rays a thread.  The SM clock is read
off a device sleep of known cycles.  A JSON line with every number ends
the output.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12
DDA_STEP_OPS = 12           # as in chip_smoke.py


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build_probe_lib(build, source: str, tag: str, extra=()):
    """A library built from ``notes/<source>`` with the port's nvcc flags
    and ``-I csrc`` (its ptxas lines printed).  Returns (lib, path)."""
    out = os.path.join(build.BUILD_DIR, f"libprobe_b1_{tag}.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *extra, "-I",
                          build.CSRC, "-o", out, os.path.join(HERE, source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {source}:\n{res.stderr}")
    for line in build._summary(res.stdout + res.stderr):
        print(f"  ptxas {tag}: {line}")
    return ctypes.CDLL(out), out


class Launcher:
    """One build's launch into outputs allocated once, on CUDA rays:
    ``lib.brick_launch`` (first design) or ``lib.variant_launch`` with
    ``rays_per_thread`` and ``blocks_per_sm`` (the variants)."""

    def __init__(self, torch, lib, words, o, d, variant=None):
        n, dev = o.shape[0], o.device
        self.torch, self.lib, self.variant = torch, lib, variant
        self.args = (words, o, d)
        self.out = {"hit": torch.empty(n, dtype=torch.bool, device=dev),
                    "t": torch.empty(n, dtype=torch.float32, device=dev),
                    "axis": torch.empty(n, dtype=torch.int32, device=dev)}

    def __call__(self):
        words, o, d = self.args
        ptrs = (words.data_ptr(), o.data_ptr(), d.data_ptr(), o.shape[0],
                self.out["hit"].data_ptr(), self.out["t"].data_ptr(),
                self.out["axis"].data_ptr())
        stream = self.torch.cuda.current_stream().cuda_stream
        if self.variant is None:
            status = self.lib.brick_launch(*ptrs, stream)
        else:
            status = self.lib.variant_launch(*ptrs, *self.variant, stream)
        if status != 0:
            raise RuntimeError(f"probe launch failed: cudaError {status}")


def sass_loops(build, path: str, tag: str, sass_dir) -> dict:
    """Print every loop of each kernel in ``path``: its instruction count,
    FSETP and LDS count.  Returns {kernel: [(length, fsetp, lds), ...]}."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True)
    if res.returncode != 0:
        print(f"  sass {tag}: cuobjdump failed: {res.stderr.strip()[:200]}")
        return {}
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        with open(os.path.join(sass_dir, f"b1_{tag}.sass"), "w") as f:
            f.write(res.stdout)
    kernels = collections.OrderedDict()
    name = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name is not None:
            kernels[name].append((int(m.group(1), 16), m.group(2).strip()))
    loops = {}
    for name, ins in kernels.items():
        addr = [a for a, _ in ins]
        found = []
        for a, text in ins:
            m = re.match(r"(?:@!?U?P\w+\s+)?BRA(?:\.\S+)?\s+(?:`\(\S+\)\s*)?"
                         r"(?:0x)?([0-9a-f]+)", text)
            if not m:
                continue
            target = int(m.group(1), 16)
            if target > a or target not in addr:
                continue
            body = [t for b, t in ins if target <= b <= a]
            found.append((len(body), sum("FSETP" in t for t in body),
                          sum(bool(re.search(r"\bLDS\b", t))
                              for t in body)))
        loops[name] = found
        print(f"  sass {tag} {name[-40:]}: {len(ins)} instructions; loops "
              f"(length, FSETP, LDS): {found}", flush=True)
    return loops


def occupancy_sweep(torch, benchmark, variants, shape, dev, args) -> None:
    """Shape (a) timed with csrc/brick.cu's kernel capped at k blocks an SM,
    for each k of --blocks-per-sm, 1 and 4 rays a thread: whether the walk
    is bound by latency (time falls with more warps) or by a pipe's
    throughput (it does not)."""
    tag, words, o, d = shape
    words = words.to(dev)
    copies = [(o.to(dev), d.to(dev)) for _ in range(
        benchmark.hbm_copies(33 * o.shape[0], dev))]
    for k in (int(x) for x in args.blocks_per_sm.split(",")):
        ms = {r: benchmark.kernel_alone_ms(
            [Launcher(torch, variants, words, oo, dd, (r, k))
             for oo, dd in copies], args.reps) for r in (1, 4)}
        print(f"  {tag}, at most {k} blocks of 256 an SM: 1 ray a thread "
              f"{ms[1]:.4f} ms, 4 rays {ms[4]:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass-dir", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--blocks-per-sm", default="",
                    help="comma list: csrc/brick.cu's kernel launched with "
                         "at most this many blocks an SM, timed at shape "
                         "(a) with 1 and 4 rays a thread")
    args = ap.parse_args()

    import numpy as np
    import torch

    from brickmap_tpu_torch import bits, single_brick
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.kernels import brick as kbrick, build
    from brickmap_tpu_torch.ops import sunsky as ss
    from brickmap_tpu_torch.render.camera import Camera
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_b1: needs a CUDA device")
    dev = torch.device("cuda")
    print(smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build(("brick",), force=True)
    for line in build.ptxas_summary["brick"]:
        print(f"  ptxas new: {line}")
    first, first_path = build_probe_lib(build, "probe_torch_b1_first.cu",
                                        "first")
    variants, variants_path = build_probe_lib(
        build, "probe_torch_b1_variants.cu", "variants")
    p, i = ctypes.c_void_p, ctypes.c_int
    first.brick_launch.argtypes = [p, p, p, i, p, p, p, p]
    variants.variant_launch.argtypes = [p, p, p, i, p, p, p, i, i, p]
    first.brick_launch.restype = variants.variant_launch.restype = i
    sass_loops(build, first_path, "first", args.sass_dir)
    sass_loops(build, build.lib_path("brick"), "new", args.sass_dir)
    sass_loops(build, variants_path, "variants", args.sass_dir)
    # The SM clock while the device sleeps a known number of cycles.
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    torch.cuda.synchronize()
    print(f"  SM clock from a device sleep: "
          f"{100_000_000 / a.elapsed_time(b) / 1e6:.3f} GHz", flush=True)

    rng = np.random.default_rng(0)
    shapes = []
    w, o, d = benchmark.brick_benchmark_rays()
    shapes.append(("a bench 2M d0.12", torch.from_numpy(w.view(np.int32)),
                   torch.from_numpy(o), torch.from_numpy(d)))
    # Diagnostics at the same rays: every ray stops in its entry cell (the
    # setup and the bytes alone), or walks to its exit (the longest walks).
    for fill, tag in ((-1, "full"), (0, "empty")):
        shapes.append((f"a' bench rays, {tag} brick",
                       torch.full((16,), fill, dtype=torch.int32),
                       torch.from_numpy(o), torch.from_numpy(d)))
    n = 1 << 20
    for density in (0.12, 0.5, 0.9):
        dense = torch.from_numpy(rng.random((8, 8, 8)) < density)
        o = rng.uniform(-0.1, 8.1, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        shapes.append((f"b phase3 1M d{density}",
                       bits.brick_words_from_dense(dense),
                       torch.from_numpy(o), torch.from_numpy(d)))
    # (c) config 1's rays, captured from render_single_brick.
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    words1 = bits.brick_words_from_dense(torch.from_numpy(
        rng.random((8, 8, 8)) < 0.3)).to(dev)
    cam = Camera(position=(-6.0, -5.0, 12.0),
                 direction=tuple(np.array([10.0, 9.0, -8.0])
                                 / np.linalg.norm([10.0, 9.0, -8.0])))
    captured = []
    wrapper = single_brick.trace_single_brick

    def capture(o, d, words):
        captured.append((o.clone(), d.clone()))
        return wrapper(o, d, words)

    single_brick.trace_single_brick = capture
    try:
        single_brick.render_single_brick(
            words1, cam, 256, 256,
            ss.sun_direction_from_position((0.05, 0.1), dev),
            uniforms=draw_wave_uniforms(256 * 256, 0, gen, dev), device=dev)
    finally:
        single_brick.trace_single_brick = wrapper
    shapes.append(("c config-1 256x256 d0.3", words1.cpu(),
                   captured[0][0].cpu(), captured[0][1].cpu()))

    results = []
    for tag, words, o, d in shapes:
        words, o, d = words.to(dev), o.to(dev), d.to(dev)
        n = o.shape[0]
        hit, t, axis, steps = kbrick.intersect_brick_plain(words, o, d)
        copies = [(o, d)] + [(o.clone(), d.clone()) for _ in range(
            benchmark.hbm_copies(33 * n, dev) - 1)]
        runs = {
            "first": [Launcher(torch, first, words, oo, dd)
                      for oo, dd in copies],
            "new": [kbrick.prepared_launch(oo, dd, words)
                    for oo, dd in copies],
            "r4": [Launcher(torch, variants, words, oo, dd, (4, 0))
                   for oo, dd in copies]}
        outs = {"first": runs["first"][0].out, "new": runs["new"][0][1],
                "4 rays a thread": runs["r4"][0].out}
        runs["new"] = [run for run, _ in runs["new"]]
        for name in ("first", "new", "r4"):
            runs[name][0]()
        torch.cuda.synchronize()
        for name, out in outs.items():
            for k, want in (("hit", hit), ("axis", axis), ("t", t)):
                if not torch.equal(out[k], want):
                    raise SystemExit(f"{tag}: {name} {k} differs from the "
                                     f"plain version on "
                                     f"{int((out[k] != want).sum())} rays")
        total = int(steps.sum())
        t_bytes = (n * 33 + 64) / HBM_BYTES_PER_S * 1e3
        t_ops = total * DDA_STEP_OPS / F32_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        simd = benchmark.launch_order_simd(steps)
        times = {"first": [], "new": [], "r4": []}
        for name in ("first", "new", "r4", "r4", "new", "first"):
            times[name].append(benchmark.kernel_alone_ms(runs[name],
                                                         args.reps))
        torch.cuda.synchronize()
        torch.cuda._sleep(benchmark.SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(20):
            kbrick.trace_single_brick(o, d, words)
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        row = {"shape": tag, "rays": n, "copies": len(copies),
               "hits": int(hit.sum()), "mean_steps": total / n,
               "max_steps": int(steps.max()), "bound_ms": bound_ms,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "simd": simd, "first_ms": times["first"],
               "new_ms": times["new"],
               "4_rays_a_thread_ms": times["r4"],
               "wrapper_host_ms": host_ms}
        results.append(row)
        print(f"  {tag}: {n} rays ({len(copies)} copies in turn), "
              f"{row['hits']} hits, mean steps {row['mean_steps']:.3f} (max "
              f"{row['max_steps']}); bound {bound_ms:.4f} ms by "
              f"{row['bound_by']}; SIMD {simd:.4f}; first "
              f"{times['first'][0]:.4f}/{times['first'][1]:.4f} ms, new "
              f"{times['new'][0]:.4f}/{times['new'][1]:.4f} ms, 4 rays a "
              f"thread {times['r4'][0]:.4f}/{times['r4'][1]:.4f} ms; new at "
              f"{bound_ms / min(times['new']):.1%} of its bound; wrapper "
              f"host {host_ms:.4f} ms a call", flush=True)
        del runs, outs, copies
    if args.blocks_per_sm:
        occupancy_sweep(torch, benchmark, variants, shapes[0], dev, args)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"probe": "b1", "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
