#!/usr/bin/env python3
"""Smoke test of brickmap_tpu_torch on one CUDA card.

    python3 chip_smoke.py [OUT_DIR]

OUT_DIR keeps phase 9's images, metrics and profiler trace (in a new
``viewer_*`` directory); without it they go to a temporary directory that
is removed.  Phases, each printing its seconds; any failure raises and exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels (nvcc, all sources at once, rebuilt even where a
   build exists) and the native heightfield (g++); print the ptxas summary,
   and fail if B1's, B2's or B3's build has a stack frame or spills;
3. kernel B1 (brick DDA) against its plain torch version, every output
   equal (``t`` included): 1M random rays at densities 0.12, 0.5 and 0.9,
   ``bench.py``'s 2M rays, origins around the brick, edge values of
   origins and directions (``brick_edge_rays``), empty and full
   bricks, 1, 3, 4, 5, 1023, 1025 rays, one less and one more than every
   count of threads that 1 to 8 blocks of 256 an SM make resident, and
   views at a 12- and a 4-byte offset; the walk's reciprocal against IEEE
   division on every float of the range it takes.  B1 alone (launches
   queued behind a device sleep, over copies of the rays that exceed the
   L2) at bench.py's shape beside its bound, with its SIMD efficiency and
   ptxas line; then
   bench.py's brick stage (``run_brick_benchmark``: Mrays/s through the
   wrapper) and the config-1 path (``render_single_brick`` at 256x256);
4. kernel B2 (hierarchical traversal) against its plain version on a
   512^2 x 128 terrain world, fully resident and with a third of the bricks
   unloaded: random rays, camera rays from inside and outside, cameras
   whose distances straddle each LoD switch, a tiny budget, and the
   schedule's edge cases (1, 31, 33 rays, the resident threads and one less
   or more, 3.5 times them; in each warp rays that take no step beside rays
   that spend the budget; two launches back to back).  Every output must
   be equal, ``t`` and ``resume_t`` included;
5. the main path: the 4096^2 x 512 world built on the card, then the
   9-viewpoint benchmark at 1920x1080, 3 bounces (1 warm-up + 1 timed wave
   per view), with B2 held against its plain version at the main path's
   shape (view 0's primary rays) and timed there beside its bound, with
   its SIMD efficiency and ptxas line.  Each wave must launch B2 at least 5
   times (4 bounce traces + the final shadow pass) unless the plain version
   finds that none of its primary rays hits;
6. kernels B3 (segment recorder), B4f and B4b (the visited voxels' values
   read from the pool fields, and their cotangents added back with
   atomics) against their plain versions on the phase-4 terrain, resident
   and streaming: random rays and the inverse benchmark's rays, K = 8 and
   16, with pool slots, and B3 on the schedule's edge cases at K = 6, 8 and
   16; B4f/B4b on the terrain's fields at the inverse rays' segments, on
   random fields, and on a duplicate-heavy case (every row on one slot and
   one voxel).  Outputs must be equal, except B4b's field gradient: within
   1e-6 of its largest value;
7. the training path: the sparse inverse-rendering step on the phase-5
   world, 1920x1080 = 2,073,600 rays, K = 8 (``run_sparse_inverse_
   benchmark``: active-brick pre-pass, an uncached and a cached step, 3 Adam
   steps).  B3, B4f and B4b must each launch, no plain version may run,
   no ray may exhaust its budget, the loss must be finite and fall and the
   gradients finite and not all zero.  Then one uncached step through the
   kernels is held against one with their plain versions swapped in (loss
   equal, gradients within 1e-6 of their largest value), B3 against its
   plain version on the frame's rays (with its SIMD efficiency and ptxas
   line) and B4f/B4b on the first 131,072-row
   slice of the step's seg_cache, each timed there beside its bound and a
   PyTorch call; one slice of the replay is split by part and profiled for
   the device's idle share, and must run no index_select or index_add_;
8. streaming: a cold start on the phase-5 world (``run_streaming_
   benchmark``: view 0, 1920x1080, 3 bounces, queue 1024, segments from 16
   rows, 48 waves, each wave's requests serviced before the next).  B2 is
   held against its plain version on wave 0's primary rays over the cold
   scene; every wave must launch B2, no plain traversal may run, no ray may
   exhaust its budget and no wave may upload more than 1024 bricks; the
   uploads must equal the resident counts and the loaded index words, no
   loaded brick may be unreachable (the reference's locality invariant), a
   manager on the CPU fed the same request lists must end in the same
   state bit for bit, and one more wave over the streaming scene must equal
   the same wave over the resident scene on every pixel that requested
   nothing;
9. the viewer: ``cli.main(["render", ..., "--turntable", "3", "--spp", "2",
   "--serve", "0", "--preview-every", "1", "--profile", ..., "--metrics",
   ...])`` in this process (it builds phase 5's world itself), 1920x1080,
   3 bounces, view 0's camera orbiting a point 300 voxels ahead of it; a
   client thread fetches ``/frame.png`` and ``/stats.json`` from the served
   page and posts one fly-camera move.  Three PNGs and ``frames`` 3, B2 in
   every wave, no plain traversal, 0 exhausted, the post applied once and
   followed by a film reset, and the trace file naming ``traverse_kernel``.
   Then one view-0 wave under ``torch.profiler``: the device operations by
   time and the device's idle share of the wave;
10. the sharded paths at world size 1 over NCCL: ``render_wave_sharded``
   equal to ``wave_for_indices`` on the same pixels and uniforms bit for
   bit; ``render_frame`` in 61,440-ray chunks equal to one
   ``render_wave`` with the same per-pixel uniforms (0 exhausted, the same
   requests); ``inverse_train_step_sparse`` at 2,073,600 rays, K = 8 equal
   to ``l2_loss_and_grads_sparse`` (loss equal, gradients within 1e-6 of
   their largest value) through B3, B4f and B4b; ``run_scaling_benchmark``
   at one rank on the scaling CLI's 512^2 x 128 world at 512x288; then the
   dense compositor's fwd+bwd Mrays/s (``run_dense_inverse_benchmark``)
   and the sparse step on the 1024^2 x 256 world
   (``run_sparse_inverse_benchmark_small``, bench.py's small-world stage).

The second-to-last line is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# Operations one DDA step needs at the least: axis select (2 compares +
# 2 selects), t and cell updates (2 adds), exit test (1 compare) and the
# occupancy test (index arithmetic, shift, and, compare: 5).
DDA_STEP_OPS = 12
FULL_WORLD_BRICKS = 8_663_747  # non-empty bricks of the 4096^2 x 512 world
L2_FLUSH_BYTES = 256 << 20     # written between timed launches: 5x the L2


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase(name: str):
    class _P:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== {name}", flush=True)
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.perf_counter() - self.t0:.2f} s",
                      flush=True)
            return False
    return _P()


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events.

    With a ``flush`` buffer (a few times the L2), every call is timed alone
    by its own events after the buffer is zeroed, so it finds the L2 cold.
    """
    import torch

    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(reps if flush is not None else 1)]
    torch.cuda.synchronize()
    for a, b in pairs:
        if flush is not None:
            flush.zero_()
        a.record()
        for _ in range(1 if flush is not None else reps):
            fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def in_solid(scene, grid, position) -> bool:
    """Whether the voxel at world ``position`` is occupied."""
    from brickmap_tpu_torch import bits
    from brickmap_tpu_torch.config import BRICK_FLAG_BITS, i32

    x, y, z = (int(p) for p in position)
    if not (0 <= x < grid.grid_size and 0 <= y < grid.grid_size
            and 0 <= z < grid.grid_height):
        return False
    b, s = grid.brick_size, grid.supergrid_cell_size
    word = int(scene.index_volume[z // b, y // b, x // b])
    if not word & i32(BRICK_FLAG_BITS):
        return False
    sc = (x // b) // s + ((y // b) // s) * grid.supergrid_xy \
        + ((z // b) // s) * grid.supergrid_xy ** 2
    row = scene.pool_words[int(scene.pool_base[sc]) + (word & 0xFFF)]
    return bool(bits.test_voxel_bit(row, x % b, y % b, z % b))


def check_b2(tag, got, want, max_err):
    """Kernel B2 result ``got`` equal to the plain version's ``want`` on
    every output, ``t`` and ``resume_t`` included."""
    import torch

    for k in ("hit", "t", "normal", "request", "request_pos", "exhausted",
              "resume_t", "ray_iters", "iters"):
        if not torch.equal(got[k], want[k]):
            diff = (got[k] != want[k]).reshape(-1, *got[k].shape[1:])
            bad = diff.reshape(diff.shape[0], -1).any(1)
            fail(f"B2 {tag}: {k} differs on {int(bad.sum())} rays")
    h = want["hit"]
    err = float((got["t"][h] - want["t"][h]).abs().max()) if bool(
        h.any()) else 0.0
    print(f"  B2 {tag}: {want['hit'].shape[0]} rays, {int(h.sum())} hits, "
          f"{int(want['request'].sum())} requests, "
          f"{int(want['exhausted'].sum())} exhausted, max steps "
          f"{int(want['iters'])}: equal", flush=True)
    max_err[0] = max(max_err[0], err)


def device_busy(prof):
    """(busy ms, first-to-last ms, activities) of the device work a profile
    holds: the union of its CUDA activities' time ranges."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        fail("the profiler saw no device activity")
    busy_us, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3, (end - spans[0][0]) / 1e3, len(spans)


def ptxas_line(name: str) -> str:
    """Registers, stack and spills of ``name``'s kernels in this run's
    build."""
    from brickmap_tpu_torch.kernels import build

    return "; ".join(line.split(":")[-1].strip()
                     for line in build.ptxas_summary.get(name, [])
                     if "spill" in line or "Used" in line)


def ptxas_clean(name: str) -> bool:
    """Whether this run's build of ``name`` reported its kernels' stack and
    spills, and all of them are 0 bytes."""
    from brickmap_tpu_torch.kernels import build

    lines = [ln for ln in build.ptxas_summary.get(name, []) if "spill" in ln]
    return bool(lines) and all(
        ln.startswith("0 bytes stack frame, 0 bytes spill stores, "
                      "0 bytes spill loads") for ln in lines)


def check_equal(tag: str, got: dict, want: dict) -> None:
    """Every output of a kernel ``got`` equal to its plain version's."""
    import torch

    for k, v in got.items():
        if not torch.equal(v, want[k]):
            bad = (v != want[k]).reshape(v.shape[0], -1).any(1)
            fail(f"{tag}: {k} differs on {int(bad.sum())} rows")


def record_bound(plain: dict, k: int, slots: bool):
    """B3's least time on these rays: per ray the inputs (clipped origin and
    direction 24 B, hit flag 1 B) and outputs (12 B per segment, 4 more with
    slots, count 4 B, exhausted 1 B), then each distinct index word read
    once (4 B); DDA_STEP_OPS per step.  Returns (ms, by, bytes)."""
    n = plain["count"].shape[0]
    nbytes = n * (25 + (16 if slots else 12) * k + 5) \
        + 4 * int(plain["cells_read"].sum())
    ms, by = bound(nbytes, int(plain["ray_words"].sum()) * DDA_STEP_OPS)
    return ms, by, nbytes


def main() -> int:
    import numpy as np
    import torch

    with phase("1 device"):
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false")
        dev = torch.device("cuda")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        smi = smi_line()
        print(smi)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")

    from brickmap_tpu_torch import bits, native, scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import GridConfig, i32, \
        BRICK_FLAG_BITS, BRICK_UNLOADED_BIT, BRICK_LOD_BITS, preset_full, \
        preset_single_brick
    from brickmap_tpu_torch.kernels import brick as kbrick, build
    from brickmap_tpu_torch.kernels import traverse as ktrav
    from brickmap_tpu_torch.ops.traverse import trace_rays
    from brickmap_tpu_torch.render import pathtrace
    from brickmap_tpu_torch.render.camera import Camera, \
        camera_arrays_for, primary_rays_from_arrays
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms
    from brickmap_tpu_torch.single_brick import render_single_brick

    with phase("2 build"):
        native_ok = []
        th = threading.Thread(target=lambda: native_ok.append(
            native.available()))
        th.start()
        secs = build.build(force=True)
        th.join()
        print(f"  nvcc build of {list(build.KERNELS)}: {secs:.2f} s")
        for name, lines in build.ptxas_summary.items():
            for line in lines:
                print(f"  ptxas {name}: {line}")
        if not native_ok[0]:
            fail("native heightfield (g++) did not build")
        for name in ("brick", "traverse", "record"):
            if not ptxas_clean(name):
                fail(f"{name}.cu: ptxas reports a stack frame or spills")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records = {}

    def rand_dirs(n):
        d = torch.randn((n, 3), generator=gen, device=dev)
        return d / torch.linalg.vector_norm(d, dim=1, keepdim=True)

    # ------------------------------------------------------------------
    with phase("3 kernel B1 vs plain, bench.py's brick stage, the config-1 "
               "path"):
        n = 1 << 20
        # Cases: phase 3's random rays at three densities, bench.py's rays,
        # origins around the brick (the general loop), empty and full
        # bricks, the launch's edge sizes and two offset views.
        cases = []
        for density in (0.12, 0.5, 0.9):
            occ = torch.rand((8, 8, 8), generator=gen, device=dev) < density
            words = bits.brick_words_from_dense(occ)
            o = torch.rand((n, 3), generator=gen, device=dev) * 8.2 - 0.1
            cases.append((f"density {density}", words, o, rand_dirs(n)))
        w_np, o_np, d_np = benchmark.brick_benchmark_rays()
        words_b = torch.from_numpy(w_np.view(np.int32)).to(dev)
        o_b, d_b = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
        cases.append(("bench.py's rays", words_b, o_b, d_b))
        # One less and one more than the threads resident at 1..8 blocks
        # of 256 an SM: the persistent grid's last full and first partial
        # second pass, whatever the occupancy calculator gives.
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        resident = [sms * 256 * k for k in range(1, 9)]
        n_w = max(n, resident[-1] + 1)
        o_w = torch.rand((n_w, 3), generator=gen, device=dev) * 14.0 - 3.0
        d_w = rand_dirs(n_w)
        cases.append(("origins in [-3, 11)^3", words_b, o_w, d_w))
        for fill, tag in ((0, "empty"), (-1, "full")):
            cases.append((f"{tag} brick", torch.full((16,), fill,
                                                     dtype=torch.int32,
                                                     device=dev),
                          o_w[:65536], d_w[:65536]))
        for m in (1, 3, 4, 5, 1023, 1025, *(r + e for r in resident
                                            for e in (-1, 1))):
            cases.append((f"n = {m}", words_b, o_w[:m], d_w[:m]))
        o_e, d_e = benchmark.brick_edge_rays(1 << 16)
        cases.append(("edge values of origins and directions", words_b,
                      torch.from_numpy(o_e).to(dev),
                      torch.from_numpy(d_e).to(dev)))
        cases.append(("origins[1:] (12-byte offset)", words_b, o_b[1:],
                      d_b[1:]))
        flat = torch.empty(3 * 4097 + 1, device=dev)
        flat[1:] = o_w[:4097].reshape(-1)
        cases.append(("a 4-byte offset view", words_b,
                      flat[1:].view(4097, 3), d_w[:4097]))
        for tag, words, o, d in cases:
            got = kbrick.trace_single_brick(o, d, words)
            hit, t, axis, steps = kbrick.intersect_brick_plain(words, o, d)
            torch.cuda.synchronize()
            # t bit for bit, NaN where both are NaN (edge rays)
            t_diff = (got["t"].view(torch.int32) != t.view(torch.int32)) & ~(
                got["t"].isnan() & t.isnan())
            for k, bad in (("hit", got["hit"] != hit),
                           ("axis", got["axis"] != axis), ("t", t_diff)):
                if bool(bad.any()):
                    fail(f"B1 {tag}: {k} differs on {int(bad.sum())} rays")
            print(f"  B1 {tag}: {int(hit.sum())} of {o.shape[0]} hit, max "
                  f"steps {int(steps.max())}: hit, axis and t equal")
            if tag == "density 0.9":
                b1_ms_1m = benchmark.brick_kernel_ms(o, d, words)
            if tag == "bench.py's rays":
                steps_b = steps
        b1_err = 0.0   # t equal bit for bit on every case
        bad_rcp = kbrick.rcp_mismatches(dev)
        if bad_rcp:
            fail(f"B1's reciprocal differs from IEEE 1 / d on {bad_rcp} "
                 f"floats of [2^-126, 2^126)")
        print("  B1's reciprocal equals IEEE 1 / d on all 2 x 252 x 2^23 "
              "floats of +-[2^-126, 2^126)")
        n_b = o_b.shape[0]
        b1_ms = benchmark.brick_kernel_ms(o_b, d_b, words_b)
        b1_wrapper_ms = cuda_ms(lambda: kbrick.trace_single_brick(
            o_b, d_b, words_b), 20)
        b1_plain_ms = cuda_ms(lambda: kbrick.intersect_brick_plain(
            words_b, o_b, d_b), 3)
        # in: origin, direction (24 B); out: hit, t, axis (9 B); the brick.
        b1_bound, b1_by = bound(n_b * 33 + 64,
                                float(steps_b.sum()) * DDA_STEP_OPS)
        b1_simd = benchmark.launch_order_simd(steps_b)
        print(f"  B1 alone at bench.py's {n_b} rays: {b1_ms:.4f} ms, "
              f"{b1_bound / b1_ms:.1%} of its bound {b1_bound:.4f} ms by "
              f"{b1_by} ({float(steps_b.float().mean()):.3f} steps a ray, "
              f"launch-order SIMD efficiency {b1_simd:.4f}); through the "
              f"wrapper "
              f"{b1_wrapper_ms:.4f} ms a call; plain {b1_plain_ms:.3f} ms; "
              f"alone at phase 3's {n} rays, density 0.9: {b1_ms_1m:.4f} ms; "
              f"ptxas {ptxas_line('brick')}", flush=True)
        del cases, o_w, d_w, flat, steps_b

        stage = benchmark.run_brick_benchmark(dev)
        print(f"  brick stage (bench.py::_pallas_brick_bench, {stage['rays']}"
              f" rays): brick_mrays_per_s {stage['brick_mrays_per_s']:.3f} "
              f"({stage['call_ms']:.4f} ms a wrapper call, "
              f"{stage['wrapper_host_ms']:.4f} ms of it the host's), kernel "
              f"alone {stage['kernel_ms']:.4f} ms, {stage['hits']} hits on "
              f"{stage['device']}", flush=True)
        if not (stage["hits"] > 0 and stage["brick_mrays_per_s"] > 0):
            fail(f"the brick stage: {stage}")

        # The config-1 path: one brick rendered through B1 at 256x256.
        occ = torch.rand((8, 8, 8), generator=gen, device=dev) < 0.3
        words = bits.brick_words_from_dense(occ)
        cam = Camera(position=(-6.0, -5.0, 12.0),
                     direction=tuple(np.array([10.0, 9.0, -8.0])
                                     / np.linalg.norm([10.0, 9.0, -8.0])))
        sun = benchmark.ss.sun_direction_from_position(
            benchmark.SUN_POSITION, dev)
        w1, h1 = (preset_single_brick().render.width,
                  preset_single_brick().render.height)
        u = draw_wave_uniforms(w1 * h1, 0, gen, dev)
        kbrick.trace_single_brick.launches = 0
        rgb, mask = render_single_brick(words, cam, w1, h1, sun,
                                        uniforms=u, device=dev)
        torch.cuda.synchronize()
        b1_launches = kbrick.trace_single_brick.launches
        rgb_c, mask_c = render_single_brick(
            words.cpu(), cam, w1, h1, sun.cpu(),
            uniforms={k: v.cpu() for k, v in u.items()}, device="cpu")
        if b1_launches < 1:
            fail("config-1 path did not launch B1")
        if not torch.equal(mask.cpu(), mask_c):
            fail("config-1 hit mask differs from the CPU path")
        if not torch.allclose(rgb.cpu(), rgb_c, rtol=1e-5, atol=1e-5):
            fail("config-1 image differs from the CPU path")
        print(f"  config-1 {w1}x{h1}: {int(mask.sum())} brick pixels, "
              f"B1 launches {b1_launches}, image matches the CPU path")
        records["B1"] = {
            "name": "brick_dda (B1)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/brick.cu",
            "replaces": "brickmap_tpu/pallas/brick.py:48",
            "launches": b1_launches, "max_abs_err": b1_err, "ms": b1_ms,
            "wrapper_ms": b1_wrapper_ms, "plain_ms": b1_plain_ms,
            "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None}

    # ------------------------------------------------------------------
    b2_err = [0.0]
    with phase("4 kernel B2 vs plain (512^2 x 128 terrain)"):
        grid = GridConfig(grid_size=512, grid_height=128)
        full = scene_mod.generate_terrain_scene(grid, device=dev)
        iv = full.index_volume.clone()
        occupied = (iv & i32(BRICK_FLAG_BITS)) != 0
        flip = occupied & (torch.rand(iv.shape, generator=gen,
                                      device=dev) < 1 / 3)
        iv[flip] = (iv[flip] & BRICK_LOD_BITS) | BRICK_UNLOADED_BIT
        streaming = scene_mod.TorchScene(iv, full.pool_words, full.pool_base)
        print(f"  {full.num_bricks} bricks, {int(flip.sum())} unloaded in the "
              f"streaming copy")

        def both(tag, o, d, sc, cam_brick, steps):
            got = ktrav.trace(o, d, sc, cam_brick, grid, steps)
            want = trace_rays(o, d, sc.index_volume, sc.pool_words,
                              sc.pool_base, cam_brick, grid, max_iters=steps)
            torch.cuda.synchronize()
            check_b2(tag, got, want, b2_err)

        n = 1 << 18
        lo = torch.tensor([-40.0, -40.0, -20.0], device=dev)
        hi = torch.tensor([552.0, 552.0, 148.0], device=dev)
        o_rand = lo + torch.rand((n, 3), generator=gen, device=dev) * (hi - lo)
        d_rand = rand_dirs(n)
        inside = Camera(position=(60.0, 70.0, 110.0),
                        direction=tuple(np.array([1.0, 0.9, -0.35])
                                        / np.linalg.norm([1.0, 0.9, -0.35])))
        outside = Camera(position=(-300.0, -250.0, 400.0),
                         direction=tuple(np.array([1.0, 0.9, -0.6])
                                         / np.linalg.norm([1.0, 0.9, -0.6])))
        w, h = 640, 360
        cam_rays = {}
        for tag, cam in (("inside", inside), ("outside", outside)):
            u = draw_wave_uniforms(w * h, 0, gen, dev)
            arrays = camera_arrays_for(cam, sun, w, h, dev)
            idx = torch.arange(w * h, device=dev)
            cam_rays[tag] = (primary_rays_from_arrays(
                u["stratum"], u["jitter"], u["lens"], arrays, idx, w, h),
                cam.brick_position)
        budget = preset_full().render.trace_budget
        for sc_tag, sc in (("resident", full), ("streaming", streaming)):
            both(f"{sc_tag} random rays", o_rand, d_rand, sc, (0, 0, 0),
                 budget)
            for tag, ((o, d), cb) in cam_rays.items():
                both(f"{sc_tag} camera {tag}", o, d, sc, cb, budget)
            # Cameras whose squared brick distances to the 64x64x16-cell
            # grid straddle a LoD switch: (340, 30, 8) spans 76,729..116,753
            # (near and byte, lod_distance_2 = 100,000), (800, 30, 8) spans
            # 543,169..641,153 (byte and far, lod_distance_8 = 600,000).
            for cam_far in ((340, 30, 8), (800, 30, 8)):
                both(f"{sc_tag} LoD camera {cam_far}", o_rand, d_rand, sc,
                     cam_far, budget)
            both(f"{sc_tag} tiny budget", o_rand, d_rand, sc, (0, 0, 0), 16)

        # The schedule's edge cases: ray counts around a warp and around the
        # threads resident at once, each warp mixing rays that take no step
        # with rays that spend the whole budget (a small one, then the full
        # one), and two launches back to back before one sync.
        for seed, n in enumerate(benchmark.edge_counts(
                benchmark.B2_BLOCKS_PER_SM, sms)):
            o, d = benchmark.schedule_edge_rays(n, grid, dev, seed=seed)
            for steps in (24, budget):
                both(f"edge rays N={n} budget {steps}", o, d, streaming,
                     (0, 0, 0), steps)
        first = ktrav.trace(o, d, full, (0, 0, 0), grid, 24)
        second = ktrav.trace(o_rand, d_rand, streaming, (340, 30, 8), grid,
                             budget)
        check_b2("back to back, first", first, trace_rays(
            o, d, full.index_volume, full.pool_words, full.pool_base,
            (0, 0, 0), grid, max_iters=24), b2_err)
        check_b2("back to back, second", second, trace_rays(
            o_rand, d_rand, streaming.index_volume, streaming.pool_words,
            streaming.pool_base, (340, 30, 8), grid, max_iters=budget),
            b2_err)
        del iv, first, second

    # ------------------------------------------------------------------
    with phase("5 main path: 4096^2 x 512 world, 9 views, 1920x1080, "
               "3 bounces"):
        cfg = preset_full()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        world = scene_mod.generate_terrain_scene(cfg.grid, device=dev)
        torch.cuda.synchronize()
        print(f"  world built in {time.perf_counter() - t0:.2f} s: "
              f"{world.num_bricks} bricks, {world.nbytes} bytes resident "
              f"(index {world.index_volume.numel() * 4}, pool "
              f"{world.pool_words.numel() * 4}), peak allocated "
              f"{torch.cuda.max_memory_allocated()} bytes")
        if world.num_bricks != FULL_WORLD_BRICKS:
            fail(f"world has {world.num_bricks} bricks, expected "
                 f"{FULL_WORLD_BRICKS}")

        # B2 at the main path's shape: view 0's primary rays, full world.
        w, h = cfg.render.width, cfg.render.height
        cam0 = benchmark.benchmark_cameras()[0]
        arrays = camera_arrays_for(cam0, sun, w, h, dev)
        u = draw_wave_uniforms(w * h, 0, gen, dev)
        o0, d0 = primary_rays_from_arrays(
            u["stratum"], u["jitter"], u["lens"], arrays,
            torch.arange(w * h, device=dev), w, h)
        budget = cfg.render.trace_budget
        got = ktrav.trace(o0, d0, world, cam0.brick_position, cfg.grid,
                          budget)
        want = trace_rays(o0, d0, world.index_volume, world.pool_words,
                          world.pool_base, cam0.brick_position, cfg.grid,
                          max_iters=budget)
        torch.cuda.synchronize()
        check_b2("main-path shape (view 0 primaries)", got, want, b2_err)
        with benchmark.KernelTimes(B2=ktrav.trace) as timer:
            for _ in range(5):
                ktrav.trace(o0, d0, world, cam0.brick_position, cfg.grid,
                            budget)
            b2_ms = timer.take()["B2"][0] / 5
        t1 = time.perf_counter()
        trace_rays(o0, d0, world.index_volume, world.pool_words,
                   world.pool_base, cam0.brick_position, cfg.grid,
                   max_iters=budget)
        torch.cuda.synchronize()
        b2_plain_ms = (time.perf_counter() - t1) * 1e3
        nray = o0.shape[0]
        cells = int(want["cells_read"].sum())
        rows = int(want["rows_read"].sum())
        words_read = int(want["ray_words"].sum())
        bricks_read = int(want["ray_bricks"].sum())
        steps = int(want["ray_iters"].sum())
        # Per ray in: origin, direction, entry normal (36 B), tmin (4), ok
        # (1); out: hit, request, exhausted (3), t, resume (8), normal (12),
        # request_pos (12), steps (4).  Then each distinct index word (4 B)
        # and brick row (64 B) the rays read, once.
        ray_bytes = nray * (41 + 39)
        b2_bytes = ray_bytes + 4 * cells + 64 * rows
        requested = ray_bytes + 4 * words_read + 64 * bricks_read
        b2_bound, b2_by = bound(b2_bytes, steps * DDA_STEP_OPS)
        print(f"  B2 at {nray} rays: {b2_ms:.4f} ms per launch (kernel "
              f"alone; plain {b2_plain_ms:.1f} ms); distinct reads {cells} "
              f"index words + {rows} brick rows -> {b2_bytes} bytes; "
              f"{steps} DDA steps -> bound {b2_bound:.4f} ms by {b2_by}; "
              f"bytes requested {requested} ({words_read} index-word and "
              f"{bricks_read} brick-row reads)", flush=True)
        print(f"  B2 schedule at {nray} rays: SIMD efficiency in launch "
              f"order {benchmark.launch_order_simd(want['ray_iters']):.4f}"
              f"; {benchmark.B2_BLOCKS_PER_SM} blocks of 128 an SM on {sms} "
              f"SMs; ptxas "
              f"{ptxas_line('traverse')}", flush=True)
        del got, want

        # Count plain-version calls during the main path: there must be none.
        plain_calls = {"B1": 0, "B2": 0}

        def counting(mod, attr, key):
            f = getattr(mod, attr)

            def wrapped(*a, **k):
                plain_calls[key] += 1
                return f(*a, **k)
            setattr(mod, attr, wrapped)
            return f

        orig_b2 = counting(ktrav, "trace_rays", "B2")
        orig_b1 = counting(kbrick, "intersect_brick_plain", "B1")
        waves = []        # per wave: (view, B2 launches)
        primaries = []    # the rays of the wave's first trace call
        orig_wave = pathtrace.render_wave
        orig_trace = pathtrace.trace

        def counted_wave(*a, **k):
            before = ktrav.trace.launches
            primaries.clear()
            ktrav.trace.events.clear()    # B2 launches of this wave only
            out = orig_wave(*a, **k)
            launches = ktrav.trace.launches - before
            traced = int(out[2]["traced_rays"])
            if launches < 5:
                # Only a wave whose primary rays all miss may stop early:
                # hold that against the plain version on those rays.
                o, d = primaries[0]
                ref = trace_rays(o, d, world.index_volume, world.pool_words,
                                 world.pool_base, a[2], cfg.grid,
                                 max_iters=cfg.render.trace_budget)
                hits = int(ref["hit"].sum())
                if hits or traced != w * h:
                    fail(f"a wave launched B2 {launches} times, traced "
                         f"{traced} rays; the plain version finds {hits} "
                         f"primary hits")
                print(f"  a wave with {launches} B2 launch(es): the plain "
                      f"version finds 0 hits among its {o.shape[0]} primary "
                      f"rays", flush=True)
            waves.append((len(images), launches))
            return out

        def first_trace(*a, **k):
            if not primaries:
                primaries.append((a[0], a[1]))
            return orig_trace(*a, **k)

        pathtrace.render_wave = counted_wave
        pathtrace.trace = first_trace
        # View -> image statistics of its timed wave; while a view renders,
        # len(images) is its index.
        images = {}

        def on_wave(vi, rgb):
            ms, calls = timer.take()["B2"]
            images[vi] = (float(rgb.mean()), float(rgb.std()),
                          bool(torch.isfinite(rgb).all()), ms, calls)

        def on_view(results):
            r = results[-1]
            m, s, finite, b2, calls = images[r["viewpoint"]]
            print(f"  view {r['viewpoint']}: {r['avg_ms']:.2f} ms, "
                  f"{r['rays']} rays traced, {r['mrays_per_s']:.3f} Mrays/s,"
                  f" exhausted {r['exhausted']}, B2 kernel {b2:.3f} ms in "
                  f"{calls} launches ({100 * b2 / r['avg_ms']:.1f}% of the "
                  f"wave), image mean {m:.5f} std {s:.5f}, finite {finite}",
                  flush=True)

        ktrav.trace.launches = 0
        kbrick.trace_single_brick.launches = 0
        cams = benchmark.benchmark_cameras()
        with benchmark.KernelTimes(B2=ktrav.trace) as timer:
            out = benchmark.run_forward_benchmark(
                world, cfg, waves_per_view=1, warmup_waves=1, verbose=False,
                on_view=on_view, on_wave=on_wave)
        b2_launches = ktrav.trace.launches
        pathtrace.render_wave = orig_wave
        pathtrace.trace = orig_trace
        ktrav.trace_rays = orig_b2
        kbrick.intersect_brick_plain = orig_b1

        per_wave = [n for _, n in waves]
        print(f"  aggregate {out['mrays_per_s']:.3f} Mrays/s over "
              f"{out['total_rays']} rays in {out['total_seconds']:.3f} s on "
              f"{out['device']}; B2 launches {b2_launches}, per wave "
              f"{per_wave}")
        if out["total_exhausted"] != 0:
            fail(f"{out['total_exhausted']} rays exhausted")
        if plain_calls["B1"] or plain_calls["B2"]:
            fail(f"plain versions ran on the main path: {plain_calls}")
        # Views 0-2 look down on the terrain from inside the world: each of
        # their waves traces every bounce and the final shadow pass.
        for vi, n in waves:
            if vi <= 2 and n < 5:
                fail(f"view {vi}: a wave launched B2 {n} times, not >= 5")
        for vi, (m, s, finite, _, _) in images.items():
            if not finite:
                fail(f"view {vi}: image not finite")
            # Viewpoint 3 of the reference's script sits below the terrain
            # (z=44.8 over ground at ~217): its rays start in solid voxels
            # and its image is black by the protocol.  Every other view
            # must show sky and ground.
            if not in_solid(world, cfg.grid, cams[vi].position) and not (
                    m > 0.0 and s > 0.0):
                fail(f"view {vi}: image black or uniform")
        records["B2"] = {
            "name": "traverse (B2)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/traverse.cu",
            "replaces": "brickmap_tpu/pallas/traverse3.py:143",
            "launches": b2_launches, "max_abs_err": b2_err[0], "ms": b2_ms,
            "plain_ms": b2_plain_ms, "bound_ms": b2_bound, "bound_by": b2_by,
            "library_ms": None}

    # ------------------------------------------------------------------
    from brickmap_tpu_torch.diff import sparse as dsparse
    from brickmap_tpu_torch.kernels import extract as kext, record as krec
    from brickmap_tpu_torch.ops.extract import extract_bwd_plain, \
        extract_fwd_plain, field_index
    from brickmap_tpu_torch.ops.record import record_segments_plain

    b4_err = [0.0, 0.0]     # B4f, B4b: max |kernel - plain| over the checks

    def rand_field(cs, pool, nvox=22):
        """A random field, slots with a few outside [0, P), and a lin with
        -1, >= 512 and duplicates."""
        field4 = torch.randn((pool * 512, 4), generator=gen, device=dev)
        slots = torch.randint(-1, pool + 1, (cs,), generator=gen,
                              device=dev, dtype=torch.int32)
        lin = torch.randint(-2, 520, (cs, nvox), generator=gen, device=dev,
                            dtype=torch.int32)
        lin[:, 3] = lin[:, 1]
        dv = torch.randn((cs, 4 * nvox), generator=gen, device=dev)
        return field4, slots, lin, dv

    def check_b4(tag, field4, slots, lin, dv):
        """B4f equal to its plain version, B4b (atomics) within 1e-6 of the
        largest gradient value."""
        vals = kext.extract_fwd(field4, slots, lin)
        dfield = kext.extract_bwd(torch.zeros_like(field4), slots, lin, dv)
        want_vals = extract_fwd_plain(field4, slots, lin)
        want = extract_bwd_plain(torch.zeros_like(field4), slots, lin, dv)
        torch.cuda.synchronize()
        check_equal(f"B4f {tag}", {"vals": vals}, {"vals": want_vals})
        err = float((dfield - want).abs().max())
        scale = float(want.abs().max())
        if not err <= 1e-6 * scale:
            fail(f"B4b {tag}: field gradient differs by {err} (max |want| "
                 f"{scale})")
        _, valid = field_index(slots, lin, field4.shape[0])
        print(f"  B4f/B4b {tag}: {lin.shape[0]} rows x {lin.shape[1]} "
              f"voxels, {int(valid.sum())} valid: values equal, field "
              f"gradient within {err:.3g} (max |want| {scale:.6g})",
              flush=True)
        b4_err[0] = max(b4_err[0], float((vals - want_vals).abs().max()))
        b4_err[1] = max(b4_err[1], err)
        del vals, dfield, want_vals, want

    with phase("6 kernels B3, B4f, B4b vs plain (512^2 x 128 terrain)"):
        grid6 = GridConfig(grid_size=512, grid_height=128)
        inv_rays = benchmark.sparse_inverse_rays(1 << 18, grid6, dev)[:2]
        for sc_tag, sc in (("resident", full), ("streaming", streaming)):
            for ray_tag, (o, d) in (("random rays", (o_rand, d_rand)),
                                    ("inverse rays", inv_rays)):
                for k in (8, 16):
                    got = krec.record_segments(o, d, sc, grid6, k_segments=k,
                                               with_slots=True)
                    want = record_segments_plain(o, d, sc, grid6,
                                                 k_segments=k,
                                                 with_slots=True)
                    torch.cuda.synchronize()
                    check_equal(f"B3 {sc_tag} {ray_tag} K={k}", got, want)
                    c = want["count"]
                    print(f"  B3 {sc_tag} {ray_tag} K={k}: {c.shape[0]} "
                          f"rays, {int((c > 0).sum())} with segments, "
                          f"{int((c == k).sum())} full, "
                          f"{int((want['slot'] == -1).sum())} slots -1, "
                          f"{int(want['exhausted'].sum())} exhausted: equal",
                          flush=True)
        # The schedule's edge cases at K = 6 (scalar row stores), 8 and 16
        # (16-byte stores): ray counts around a warp and around the threads
        # resident at once, warps mixing rays that take no step with rays
        # that spend the budget, and two launches back to back before one
        # sync.
        for k in (6, 8, 16):
            counts = benchmark.edge_counts(benchmark.B3_BLOCKS_PER_SM, sms)
            for seed, n in enumerate(counts):
                o, d = benchmark.schedule_edge_rays(n, grid6, dev, seed=seed)
                for steps in (12, 2048):
                    got = krec.record_segments(o, d, streaming, grid6,
                                               k_segments=k, max_steps=steps,
                                               with_slots=True)
                    want = record_segments_plain(o, d, streaming, grid6,
                                                 k_segments=k,
                                                 max_steps=steps,
                                                 with_slots=True)
                    torch.cuda.synchronize()
                    check_equal(f"B3 edge rays N={n} K={k} budget {steps}",
                                got, want)
            first = krec.record_segments(o, d, full, grid6, k_segments=k,
                                         max_steps=12)
            second = krec.record_segments(o_rand, d_rand, full, grid6,
                                          k_segments=k, with_slots=True)
            check_equal(f"B3 back to back K={k}, first", first,
                        record_segments_plain(o, d, full, grid6,
                                              k_segments=k, max_steps=12))
            check_equal(f"B3 back to back K={k}, second", second,
                        record_segments_plain(o_rand, d_rand, full, grid6,
                                              k_segments=k, with_slots=True))
            print(f"  B3 K={k}: edge rays at N = {counts} (budgets 12, "
                  f"2048) and two launches back to back: equal", flush=True)
        del got, want, first, second

        # B4f/B4b on the terrain's own fields at the inverse rays' segments.
        occ6, alb6 = dsparse.pool_fields_from_bitmask(full)
        alb6 = alb6 * torch.rand(alb6.shape, generator=gen, device=dev)
        field6 = dsparse._pack_field(occ6 * 0.8, alb6)
        segs = krec.record_segments(*inv_rays, full, grid6, k_segments=8)
        slots6, lin6, mask6 = dsparse._segment_geom(
            segs["o_cells"], inv_rays[1], segs["cells"], segs["nd"],
            segs["ncode"], segs["entry_normal"],
            dsparse.cell_pool_map(full, grid6), grid6, 8)
        lin6 = torch.where(mask6, lin6, -1).reshape(-1, lin6.shape[2])
        check_b4("terrain fields, inverse rays' segments", field6,
                 slots6.reshape(-1), lin6,
                 torch.randn((lin6.shape[0], 4 * lin6.shape[1]),
                             generator=gen, device=dev))
        del occ6, alb6, field6, segs, slots6, lin6, mask6
        spread = rand_field(131072, 4096)
        check_b4("random field (131072 rows, 4096 slots)", *spread)
        check_b4("random field (8191 rows, 64 slots)", *rand_field(8191, 64))
        check_b4("random field, 7 voxels", *rand_field(1000, 8, 7))
        # Duplicate-heavy: every row on one slot, 20 of its 22 steps on one
        # voxel (2,621,440 atomics on one address), cotangents in quarters
        # so every sum is exact whatever the order.
        f4, s4, l4, _ = rand_field(131072, 4)
        s4[:] = 2
        l4[:, 2:] = 17
        dq = torch.randint(-8, 9, (131072, 88), generator=gen, device=dev
                           ).float() / 4
        check_b4("duplicate-heavy (one slot, one voxel)", f4, s4, l4, dq)
        # What contention costs B4b: the same row count spread over 4096
        # slots, and piled on one voxel.
        b4b_spread_ms = cuda_ms(lambda: kext.extract_bwd(
            torch.zeros_like(spread[0]), *spread[1:]), 5)
        b4b_dup_ms = cuda_ms(lambda: kext.extract_bwd(
            torch.zeros_like(f4), s4, l4, dq), 5)
        print(f"  B4b at 131072 rows with its zeroed gradient: spread "
              f"{b4b_spread_ms:.4f} ms, duplicate-heavy {b4b_dup_ms:.4f} ms")
        del full, streaming, o_rand, d_rand, inv_rays, f4, s4, l4, dq, spread

    # ------------------------------------------------------------------
    with phase("7 training path: sparse inverse step, 4096^2 x 512 world, "
               "1920x1080 rays, K = 8"):
        K = benchmark.SPARSE_K
        nvox = 3 * cfg.grid.brick_size - 2
        plain_calls = {"B3": 0, "B4f": 0, "B4b": 0}
        saved = [counting(krec, "record_segments_plain", "B3"),
                 counting(kext, "extract_fwd_plain", "B4f"),
                 counting(kext, "extract_bwd_plain", "B4b")]
        krec.record_segments.launches = 0
        kext.extract_fwd.launches = 0
        kext.extract_bwd.launches = 0
        out7 = benchmark.run_sparse_inverse_benchmark(world, cfg.grid)
        launches = {"B3": krec.record_segments.launches,
                    "B4f": kext.extract_fwd.launches,
                    "B4b": kext.extract_bwd.launches}
        krec.record_segments_plain, kext.extract_fwd_plain, \
            kext.extract_bwd_plain = saved
        frame = out7.pop("frame")
        print(f"  active bricks A = {out7['active_bricks']} (the JAX "
              f"package's record of these rays: 138541), rays with "
              f"segments {out7['live_rays']} of {out7['rays']}, mean count "
              f"{out7['mean_count']:.4f}, exhausted {out7['exhausted']}")
        print(f"  prepass {out7['prepass_s']:.3f} s, uncached step "
              f"{out7['uncached_step_s']:.3f} s ({out7['mrays_per_s']:.4f} "
              f"Mrays/s), cached step {out7['cached_step_s']:.3f} s "
              f"({out7['cached_mrays_per_s']:.4f} Mrays/s), Adam steps "
              f"{out7['adam_step_s']} s, losses {out7['losses']}, peak "
              f"allocated {out7['peak_bytes']} bytes on {out7['device']}")
        print(f"  Adam update alone {out7['adam_update_s']} s")
        for st, per in out7["kernels"].items():
            print(f"  stage {st}: " + ", ".join(
                f"{k} {ms:.3f} ms in {c} launches" for k, (ms, c) in
                per.items()), flush=True)
        print(f"  launches in the run: {launches}; plain calls "
              f"{plain_calls}")
        if any(v < 1 for v in launches.values()):
            fail(f"a kernel of the training path did not launch: {launches}")
        if any(plain_calls.values()):
            fail(f"plain versions ran on the training path: {plain_calls}")
        if out7["exhausted"]:
            fail(f"{out7['exhausted']} rays exhausted the record budget")
        losses = out7["losses"]
        if not (all(math.isfinite(v) for v in losses)
                and math.isfinite(out7["loss"]) and losses[-1] < losses[0]):
            fail(f"loss not finite and falling: {losses}")
        if not (out7["grads_finite"] and out7["grads_nonzero"]):
            fail("gradients not finite, or all zero")

        # The whole step against the plain versions on the same inputs (the
        # fields after the Adam steps): one uncached step through B3, B4f
        # and B4b, one with their plain versions swapped in.  B4b's atomics
        # and the plain version's index_add_ sum in run-dependent orders on
        # the card, so gradients agree to 1e-6 of their largest value; the
        # loss takes no atomics and must be equal.
        o7, d7 = frame["origins"], frame["dirs"]
        kernel_fns = (dsparse.record_segments, dsparse.extract_fwd,
                      dsparse.extract_bwd)

        def full_step():
            before = [f.launches for f in kernel_fns]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, grads = dsparse.l2_loss_and_grads_sparse(
                o7, d7, world, frame["cellmap"], frame["occupancy"],
                frame["albedo"], frame["background"], frame["target"],
                cfg.grid, k_segments=K)
            torch.cuda.synchronize()
            return (float(loss), grads, time.perf_counter() - t1,
                    [f.launches - b for f, b in zip(kernel_fns, before)])

        loss_k, (go_k, ga_k), step_k_s, n_k = full_step()
        dsparse.record_segments = record_segments_plain
        dsparse.extract_fwd = extract_fwd_plain
        dsparse.extract_bwd = extract_bwd_plain
        try:
            loss_p, (go_p, ga_p), step_p_s, n_p = full_step()
        finally:
            dsparse.record_segments, dsparse.extract_fwd, \
                dsparse.extract_bwd = kernel_fns
        grad_errs = [(float((gk - gp).abs().max()), float(gp.abs().max()))
                     for gk, gp in ((go_k, go_p), (ga_k, ga_p))]
        print(f"  whole uncached step, kernels {step_k_s:.3f} s (launches "
              f"B3/B4f/B4b {n_k}) against the plain versions "
              f"{step_p_s:.3f} s (launches {n_p}): loss {loss_k!r} vs "
              f"{loss_p!r}; max |dgrad| (max |grad|) occupancy "
              f"{grad_errs[0][0]:.3g} ({grad_errs[0][1]:.6g}), albedo "
              f"{grad_errs[1][0]:.3g} ({grad_errs[1][1]:.6g})", flush=True)
        del go_k, ga_k, go_p, ga_p
        if min(n_k) < 1 or any(n_p):
            fail(f"kernel launches {n_k} in the kernel step, {n_p} in the "
                 f"plain one")
        if loss_k != loss_p or any(e > 1e-6 * m for e, m in grad_errs):
            fail(f"the step's loss ({loss_k!r} vs {loss_p!r}) or gradients "
                 f"({grad_errs}) differ from the plain versions'")

        # B3 against its plain version on the frame's rays, timed there.
        got = krec.record_segments(o7, d7, world, cfg.grid, k_segments=K)
        t1 = time.perf_counter()
        want = record_segments_plain(o7, d7, world, cfg.grid, k_segments=K)
        torch.cuda.synchronize()
        b3_plain_ms = (time.perf_counter() - t1) * 1e3
        check_equal("B3 frame rays", got, want)
        b3_err = float((got["nd"] - want["nd"]).abs().max())
        with benchmark.KernelTimes(B3=krec.record_segments) as timer:
            for _ in range(5):
                krec.record_segments(o7, d7, world, cfg.grid, k_segments=K)
            b3_ms = timer.take()["B3"][0] / 5
        print(f"  B3 schedule at {o7.shape[0]} rays: SIMD efficiency in "
              f"launch order "
              f"{benchmark.launch_order_simd(want['ray_words']):.4f}; "
              f"{benchmark.B3_BLOCKS_PER_SM} blocks of 128 an SM on {sms} "
              f"SMs; ptxas "
              f"{ptxas_line('record')}", flush=True)
        b3_bound, b3_by, b3_bytes = record_bound(want, K, False)
        print(f"  B3 at {o7.shape[0]} rays: {b3_ms:.4f} ms per launch (plain "
              f"{b3_plain_ms:.1f} ms); {int(want['cells_read'].sum())} "
              f"distinct index words, {int(want['ray_words'].sum())} steps "
              f"-> {b3_bytes} bytes, bound {b3_bound:.4f} ms by {b3_by}; "
              f"outputs equal", flush=True)
        del got, want

        # B4f/B4b on the first 131,072-row slice of the replay: the first
        # 16,384 count-sorted live rays of the timed steps' seg_cache.
        c7 = 16384
        sl_in = tuple(a[:c7] for a in frame["seg_cache"]["geo"])
        cellmap_a = frame["cellmap"]
        field4 = dsparse._pack_field(frame["occupancy"], frame["albedo"])
        del frame, o7, d7
        slots, lin, mask = dsparse._segment_geom(*sl_in[:6], cellmap_a,
                                                 cfg.grid, K)
        flat = slots.reshape(-1)
        lin2 = torch.where(mask, lin, -1).reshape(c7 * K, nvox)
        del lin, mask
        cs = lin2.shape[0]
        dv = torch.randn((cs, 4 * nvox), generator=gen, device=dev)
        check_b4(f"replay slice ({cs} rows)", field4, flat, lin2, dv)
        # The kernels, their plain versions and the library calls are timed
        # alike: CUDA events around each call, the L2 flushed before every
        # one (the replay finds the 6 GB fields and their gradient cold).
        # The library calls: one index_select of the valid voxels' rows, and
        # one index_add_ of their cotangents, on inputs compacted before.
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        dfield = torch.zeros_like(field4)
        gidx, valid = field_index(flat, lin2, field4.shape[0])
        gidx_valid = gidx[valid]
        dv_valid = dv.reshape(cs, 4, nvox).permute(0, 2, 1)[valid]
        n_valid = gidx_valid.shape[0]
        b4f_ms, b4b_ms, b4f_plain_ms, b4b_plain_ms, b4f_lib_ms, b4b_lib_ms = (
            cuda_ms(fn, reps, flush) for fn, reps in (
                (lambda: kext.extract_fwd(field4, flat, lin2), 10),
                (lambda: kext.extract_bwd(dfield, flat, lin2, dv), 10),
                (lambda: extract_fwd_plain(field4, flat, lin2), 3),
                (lambda: extract_bwd_plain(dfield, flat, lin2, dv), 3),
                (lambda: field4.index_select(0, gidx_valid), 10),
                (lambda: dfield.index_add_(0, gidx_valid, dv_valid), 10)))
        # B4b on index_add_'s own input: the compacted valid entries as
        # one-step rows.
        one_step = ((gidx_valid // 512).to(torch.int32),
                    (gidx_valid % 512).to(torch.int32).reshape(-1, 1),
                    dv_valid.contiguous())
        b4b_compact_ms = cuda_ms(lambda: kext.extract_bwd(dfield, *one_step),
                                 10, flush)
        del flush, one_step
        # How many of the slice's atomics share an address.
        _, per_voxel = torch.unique(gidx_valid, return_counts=True)
        # B4f: slots, lin, the 16 B of each valid voxel read, all 4*nvox
        # values written.  B4b: slots, lin, the cotangents read, and a
        # 16-byte read-modify-write per valid voxel (4 adds).
        entries = cs * nvox
        b4f_bound, b4f_by = bound(4 * cs + 4 * entries + 16 * n_valid
                                  + 16 * entries, 0)
        b4b_bound, b4b_by = bound(4 * cs + 4 * entries + 16 * entries
                                  + 32 * n_valid, 4 * n_valid)
        print(f"  B4f at {cs} rows ({n_valid} valid voxels), L2 cold: "
              f"{b4f_ms:.4f} ms per launch (plain {b4f_plain_ms:.3f} ms, "
              f"index_select of the valid rows {b4f_lib_ms:.4f} ms, bound "
              f"{b4f_bound:.4f} ms by {b4f_by}, "
              f"{100 * b4f_bound / b4f_ms:.1f}% of it)")
        print(f"  B4b at {cs} rows, L2 cold: {b4b_ms:.4f} ms per launch (plain "
              f"{b4b_plain_ms:.3f} ms, index_add_ of the valid rows "
              f"{b4b_lib_ms:.4f} ms, bound {b4b_bound:.4f} ms by {b4b_by}, "
              f"{100 * b4b_bound / b4b_ms:.1f}% of it; on index_add_'s "
              f"compacted input {b4b_compact_ms:.4f} ms); its {n_valid} "
              f"atomics fall on {per_voxel.shape[0]} voxels, at most "
              f"{int(per_voxel.max())} on one", flush=True)
        del gidx, valid, gidx_valid, dv_valid, per_voxel

        # Where one slice's time goes: host clock around synchronised work
        # (the replay is eager torch: its launches set the pace).  The
        # device's busy and idle shares come from one profiled call of the
        # slice alone: the union of its device activities against the host
        # time of that same call, and against the span from its first
        # device activity to its last.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        def host_ms(fn, reps=3):
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t1) * 1e3 / reps

        sse0 = torch.zeros((), device=dev)
        v7 = K * nvox
        occ_v = torch.rand((c7, v7), generator=gen, device=dev)
        s_v = torch.rand((c7, v7), generator=gen, device=dev)

        def one_slice():
            dsparse._row_chunk_grad(*sl_in[:6], cellmap_a, sse0, dfield,
                                    field4, sl_in[6], sl_in[7], cfg.grid, K)

        parts = {
            "geometry": host_ms(lambda: dsparse._segment_geom(
                *sl_in[:6], cellmap_a, cfg.grid, K)),
            "B4f": host_ms(lambda: kext.extract_fwd(field4, flat, lin2)),
            "B4b": host_ms(lambda: kext.extract_bwd(dfield, flat, lin2, dv)),
            "suffix loop": host_ms(lambda: dsparse._suffix(
                occ_v, s_v, s_v[:, 0])),
            "whole slice": host_ms(one_slice),
        }
        print("  one 16,384-ray slice at K = 8 (host ms, 3 calls each): "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            one_slice()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t1) * 1e3
        busy_ms, span_ms, n_act = device_busy(prof)
        print(f"  one profiled call of the slice: {traced_ms:.3f} ms host, "
              f"{n_act} device activities over {span_ms:.3f} ms from "
              f"first to last, {busy_ms:.3f} ms busy -> device idle "
              f"{1 - busy_ms / traced_ms:.3f} of the call, "
              f"{1 - busy_ms / span_ms:.3f} of its device span; top by "
              f"device time:")
        evs = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        for e in sorted(evs, key=dev_us, reverse=True)[:8]:
            print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key[:90]}")
        # The row gather and the row index_add_ are folded into B4f/B4b:
        # neither of torch's index_select or index_add_ kernels may run.
        rows_ops = [e.key for e in evs if dev_us(e) > 0 and (
            "indexSelect" in e.key or "indexFunc" in e.key)]
        if rows_ops:
            fail(f"the slice still runs index_select/index_add_: {rows_ops}")
        del dfield, occ_v, s_v, field4, cellmap_a, sl_in, flat, lin2, dv
        del slots

        records["B3"] = {
            "name": "record (B3)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/record.cu",
            "replaces": "brickmap_tpu/pallas/record.py:42",
            "launches": launches["B3"], "max_abs_err": b3_err, "ms": b3_ms,
            "plain_ms": b3_plain_ms, "bound_ms": b3_bound, "bound_by": b3_by,
            "library_ms": None}
        records["B4f"] = {
            "name": "extract forward (B4f)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/extract.cu",
            "replaces": "brickmap_tpu/pallas/extract.py:35",
            "launches": launches["B4f"], "max_abs_err": b4_err[0],
            "ms": b4f_ms,
            "plain_ms": b4f_plain_ms, "bound_ms": b4f_bound,
            "bound_by": b4f_by, "library_ms": b4f_lib_ms}
        records["B4b"] = {
            "name": "extract backward (B4b)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/extract.cu",
            "replaces": "brickmap_tpu/pallas/extract.py:55",
            "launches": launches["B4b"], "max_abs_err": b4_err[1],
            "ms": b4b_ms,
            "plain_ms": b4b_plain_ms, "bound_ms": b4b_bound,
            "bound_by": b4b_by, "library_ms": b4b_lib_ms}

    # ------------------------------------------------------------------
    from brickmap_tpu_torch.config import BRICK_LOADED_BIT
    from brickmap_tpu_torch.stream import StreamingScene

    with phase("8 streaming: cold start on the 4096^2 x 512 world"):
        w, h, waves8, queue = cfg.render.width, cfg.render.height, 48, 1024
        budget = cfg.render.trace_budget
        t0 = time.perf_counter()
        truth = world.to("cpu")
        print(f"  truth copied to the host in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        cam0 = benchmark.benchmark_cameras()[0]
        arrays = camera_arrays_for(cam0, sun, w, h, dev)

        # B2 at full size on the cold scene: wave 0's primary rays (its
        # generator's draws, in the wave's tile order), where nearly every
        # ray stops at an unloaded brick and requests it.
        cold = StreamingScene(truth, cfg.grid, queue_size=queue, device=dev)
        gen8 = torch.Generator(device=dev)
        gen8.manual_seed(0)
        u = draw_wave_uniforms(w * h, cfg.render.max_bounces, gen8, dev)
        perm_np, inv_np = pathtrace._tile_permutation(w, h)
        o8, d8 = primary_rays_from_arrays(
            u["stratum"], u["jitter"], u["lens"], arrays,
            torch.from_numpy(perm_np.copy()).to(dev), w, h)
        csc = cold.device_scene()
        got = ktrav.trace(o8, d8, csc, cam0.brick_position, cfg.grid, budget)
        want = trace_rays(o8, d8, csc.index_volume, csc.pool_words,
                          csc.pool_base, cam0.brick_position, cfg.grid,
                          max_iters=budget)
        torch.cuda.synchronize()
        check_b2("cold full world (wave 0 primaries)", got, want, b2_err)
        records["B2"]["max_abs_err"] = b2_err[0]
        del cold, csc, got, want, o8, d8, u

        # What the wave's per-call copies of the tile permutation and its
        # inverse cost (render_wave copies both from pageable memory).
        def perm_copies():
            torch.from_numpy(perm_np.copy()).to(dev)
            torch.from_numpy(inv_np.copy()).to(dev)
            torch.cuda.synchronize()

        perm_copies()
        t0 = time.perf_counter()
        for _ in range(3):
            perm_copies()
        perm_ms = (time.perf_counter() - t0) * 1e3 / 3

        plain_calls = {"B2": 0}
        orig_b2 = counting(ktrav, "trace_rays", "B2")
        launches8, requests8, b2_ms8 = [], [], []
        # Host stalls that a wave's timings may hide: the garbage
        # collector's passes (ms since the last wave) and the caching
        # allocator's retries (it frees its cache and allocates again).
        gc_ms, gc_t0 = [0.0], [0.0]

        def gc_timer(stage, info):
            if stage == "start":
                gc_t0[0] = time.perf_counter()
            else:
                gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3

        def retries():
            return torch.cuda.memory_stats().get("num_alloc_retries", 0)

        retries0 = [retries()]

        def on_wave8(i, row, reqs):
            b2, n = timer8.take()["B2"]
            launches8.append(n)
            b2_ms8.append(b2)
            requests8.append(reqs)
            stall = (f"gc {gc_ms[0]:.3f} ms, allocator retries "
                     f"{retries() - retries0[0]}")
            gc_ms[0], retries0[0] = 0.0, retries()
            print(f"  wave {i}: {row['wave_ms']:.3f} ms, {row['traced']} "
                  f"rays, {row['traced'] / row['wave_ms'] / 1e3:.3f} "
                  f"Mrays/s, B2 {b2:.3f} ms in {n} launches, exhausted "
                  f"{row['exhausted']}; {row['requests']} requests pulled "
                  f"in {row['pull_ms']:.3f} ms, {row['uploads']} uploads, "
                  f"{row['dropped']} dropped, plan {row['plan_ms']:.3f} ms,"
                  f" install {row['install_ms']:.3f} ms, pool "
                  f"{row['pool_rows']} rows{' (grew)' if row['grew'] else ''}"
                  f"; {stall}", flush=True)

        ktrav.trace.launches = 0
        gc.callbacks.append(gc_timer)
        try:
            with benchmark.KernelTimes(B2=ktrav.trace) as timer8:
                out8 = benchmark.run_streaming_benchmark(
                    truth, cfg, view=0, width=w, height=h, waves=waves8,
                    queue_size=queue, starting_capacity=16, seed=0,
                    device=dev, on_wave=on_wave8)
        finally:
            gc.callbacks.remove(gc_timer)
        b2_launches8 = ktrav.trace.launches
        ktrav.trace_rays = orig_b2
        mgr = out8.pop("manager")
        rows8 = out8.pop("per_wave")
        wave_ms = [r["wave_ms"] for r in rows8]
        print(f"  manager cold init {out8['init_s']:.3f} s; "
              f"{out8['mrays_during_convergence']:.3f} Mrays/s over waves "
              f"1-{waves8 - 1}; {out8['bricks_uploaded']} bricks uploaded, "
              f"{out8['upload_bricks_per_s']:.1f} bricks/s over the pull "
              f"and servicing; waves {min(wave_ms):.3f}-{max(wave_ms):.3f} "
              f"ms (sum {sum(wave_ms):.3f}), B2 {sum(b2_ms8):.3f} ms in "
              f"{b2_launches8} launches, pull "
              f"{sum(r['pull_ms'] for r in rows8):.3f} ms, plan "
              f"{sum(r['plan_ms'] for r in rows8):.3f} ms, install "
              f"{sum(r['install_ms'] for r in rows8):.3f} ms, "
              f"{sum(r['grew'] for r in rows8)} growths, perm/inv copies "
              f"{perm_ms:.3f} ms a wave "
              f"({100 * perm_ms * waves8 / sum(wave_ms):.1f}% of the waves) "
              f"on {out8['device']}", flush=True)
        sc8 = mgr.device_scene()
        print(f"  device bytes: streaming scene {sc8.nbytes} (pool "
              f"{sc8.pool_words.numel() * 4}) against the resident "
              f"{world.nbytes}", flush=True)
        if b2_launches8 != sum(launches8) or min(launches8) < 1:
            fail(f"a streaming wave did not launch B2: {launches8}")
        if plain_calls["B2"]:
            fail(f"the plain traversal ran in the streaming waves: "
                 f"{plain_calls}")
        if any(r["exhausted"] for r in rows8):
            fail(f"exhausted rays: {[r['exhausted'] for r in rows8]}")
        if any(r["uploads"] > queue for r in rows8):
            fail(f"a wave uploaded more than {queue} bricks")
        loaded_words = int(((sc8.index_volume & i32(BRICK_LOADED_BIT)) != 0)
                           .sum())
        if not (mgr.total_uploaded == int(mgr.dump().sum()) == loaded_words
                == out8["bricks_uploaded"] > 0):
            fail(f"uploads {mgr.total_uploaded}, resident "
                 f"{int(mgr.dump().sum())}, loaded words {loaded_words}")
        t0 = time.perf_counter()
        surf = mgr.surface_stats()
        print(f"  streaming: {int(mgr.dump().sum())} bricks resident, "
              f"{mgr.total_uploaded} uploaded, {mgr.total_dropped} dropped")
        print(f"  streaming: {surf['loaded_surface']} air-surface + "
              f"{surf['loaded_reachable'] - surf['loaded_surface']} "
              f"behind-partial / {surf['loaded_unreachable']} unreachable "
              f"(world: {surf['surface_total']} surface, "
              f"{surf['reachable_total']} reachable of "
              f"{surf['nonempty_total']} non-empty; "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
        if surf["loaded_unreachable"]:
            fail("a loaded brick is unreachable")

        # The device's scatters and re-basing against a manager on the CPU
        # fed the same request lists.
        t0 = time.perf_counter()
        replay = StreamingScene(truth, cfg.grid, queue_size=queue,
                                device="cpu")
        for reqs in requests8:
            replay.process_requests(reqs)
        st_dev, st_cpu = mgr.state(), replay.state()
        for k, v in st_cpu.items():
            if not np.array_equal(st_dev[k], v):
                fail(f"streaming state {k} differs from the CPU replay")
        print(f"  CPU replay of the {len(requests8)} request lists: state "
              f"equal ({time.perf_counter() - t0:.2f} s)", flush=True)
        del replay, st_dev, st_cpu

        # One more wave, the same uniforms over the streaming and the
        # resident scene: a pixel whose rays requested nothing never met an
        # unloaded brick (the mask is sticky over the path), so it must be
        # equal bit for bit.
        gen8.manual_seed(waves8)
        u = draw_wave_uniforms(w * h, cfg.render.max_bounces, gen8, dev)
        rgb_s, cnt_s, req_s = pathtrace.render_wave(
            sc8, arrays, cam0.brick_position, cfg, w, h, uniforms=u)
        rgb_r, cnt_r, req_r = pathtrace.render_wave(
            world, arrays, cam0.brick_position, cfg, w, h, uniforms=u)
        free = ~req_s["mask"]
        n_free = int(free.sum())
        if int(req_s["exhausted_rays"]) or int(req_r["exhausted_rays"]):
            fail("exhausted rays in the closing waves")
        if bool(req_r["mask"].any()):
            fail("the resident scene requested bricks")
        if not (n_free > 0 and torch.equal(rgb_s[free], rgb_r[free])
                and torch.equal(cnt_s[free], cnt_r[free])):
            fail(f"the streaming wave differs from the resident one on its "
                 f"{n_free} request-free pixels")
        print(f"  wave {waves8}: {n_free} of {w * h} pixels requested "
              f"nothing; their rgb and count equal the resident scene's "
              f"bit for bit", flush=True)
        del mgr, sc8, truth, rgb_s, cnt_s, req_s, rgb_r, cnt_r, req_r, u

    # ------------------------------------------------------------------
    from brickmap_tpu_torch.app import cli
    from brickmap_tpu_torch.utils import preview

    with phase("9 viewer: render --turntable 3 --spp 2 --serve 0 "
               "--preview-every 1 --profile on the 4096^2 x 512 world"):
        w, h = cfg.render.width, cfg.render.height
        # The run's PNGs, metrics and trace: in a new directory under the
        # one named on the command line (kept), else in a temporary one.
        keep = sys.argv[1] if len(sys.argv) > 1 else None
        if keep:
            os.makedirs(keep, exist_ok=True)
        out_dir = tempfile.mkdtemp(prefix="viewer_", dir=keep)
        prof_dir = os.path.join(out_dir, "profile")
        metrics_path = os.path.join(out_dir, "metrics.jsonl")
        cam0 = benchmark.benchmark_cameras()[0]
        look = [p + 300.0 * d for p, d in zip(cam0.position, cam0.direction)]
        argv = ["render", "--out", os.path.join(out_dir, "view.png"),
                "--width", str(w), "--height", str(h), "--bounces",
                str(cfg.render.max_bounces), "--world",
                str(cfg.grid.grid_size), "--world-height",
                str(cfg.grid.grid_height), "--max-steps",
                str(cfg.render.max_top_steps), "--spp", "2",
                "--turntable", "3", "--serve", "0", "--preview-every", "1",
                "--profile", prof_dir, "--metrics", metrics_path,
                "--camera", *(str(p) for p in cam0.position), "--look",
                *(str(p) for p in look)]

        # The served page's client: once the loop serves frame 1, fetch the
        # frame and the stats and post one fly-camera move.
        servers, got9 = [], {}

        class Served(preview.PreviewServer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                servers.append(self)

        def client():
            t_end = time.perf_counter() + 300
            while not servers and time.perf_counter() < t_end:
                time.sleep(0.005)
            url = f"http://127.0.0.1:{servers[0].port}"
            while time.perf_counter() < t_end:
                with urllib.request.urlopen(url + "/stats.json",
                                            timeout=10) as r:
                    st = json.loads(r.read())
                if st.get("frame", 0) >= 1:
                    break
                time.sleep(0.005)
            with urllib.request.urlopen(url + "/frame.png", timeout=10) as r:
                got9["png"] = r.read()
            with urllib.request.urlopen(url + "/stats.json", timeout=10) as r:
                got9["stats"] = json.loads(r.read())
            req = urllib.request.Request(
                url + "/camera", method="POST", data=json.dumps(
                    {"move": [2.0, 0.5, 0.0], "rot": [0.2, -0.05]}).encode())
            with urllib.request.urlopen(req, timeout=10) as r:
                got9["post"] = r.status

        def client_run():
            try:
                client()
            except Exception as e:   # reported with the phase's checks
                got9["error"] = repr(e)

        events9, waves9 = [], []
        orig_wave, orig_init = pathtrace.render_wave, pathtrace.film_init
        orig_apply = cli._apply_camera_input

        def counted_wave9(*a, **k):
            before = ktrav.trace.launches
            out = orig_wave(*a, **k)
            waves9.append((ktrav.trace.launches - before,
                           int(out[2]["exhausted_rays"])))
            return out

        def logged_init(*a, **k):
            events9.append("film_init")
            return orig_init(*a, **k)

        def logged_apply(*a, **k):
            events9.append("camera_input")
            return orig_apply(*a, **k)

        plain_calls = {"B2": 0}
        orig_b2 = counting(ktrav, "trace_rays", "B2")
        pathtrace.render_wave, pathtrace.film_init = counted_wave9, \
            logged_init
        cli._apply_camera_input = logged_apply
        orig_server, preview.PreviewServer = preview.PreviewServer, Served
        th9 = threading.Thread(target=client_run, daemon=True)
        stdout9 = io.StringIO()
        ktrav.trace.launches = 0
        try:
            th9.start()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout9):
                rc = cli.main(argv)
            loop_s = time.perf_counter() - t0
            th9.join(timeout=60)
        finally:
            pathtrace.render_wave, pathtrace.film_init = orig_wave, \
                orig_init
            cli._apply_camera_input = orig_apply
            preview.PreviewServer = orig_server
            ktrav.trace_rays = orig_b2
        b2_launches9 = ktrav.trace.launches
        line = stdout9.getvalue().strip().splitlines()[-1]
        print(f"  render: rc {rc}, {loop_s:.2f} s; {line}")
        rec9 = json.loads(line)
        pngs = sorted(f for f in os.listdir(out_dir)
                      if f.startswith("view_") and f.endswith(".png"))
        print(f"  B2 launches {b2_launches9}, per wave "
              f"{[n for n, _ in waves9]}, exhausted "
              f"{[e for _, e in waves9]}; PNGs {pngs}; film events "
              f"{events9}; served: frame.png {len(got9.get('png', b''))} "
              f"bytes, stats {got9.get('stats')}, POST /camera -> "
              f"{got9.get('post')}", flush=True)
        if rc != 0 or rec9["frames"] != 3 or rec9["waves"] != 6:
            fail(f"the viewer run: rc {rc}, {rec9}")
        if pngs != ["view_000.png", "view_001.png", "view_002.png"]:
            fail(f"the viewer wrote {pngs}")
        if len(waves9) != 6 or min(n for n, _ in waves9) < 1 \
                or b2_launches9 != sum(n for n, _ in waves9):
            fail(f"a viewer wave did not launch B2: {waves9}")
        if plain_calls["B2"]:
            fail(f"the plain traversal ran in the viewer: {plain_calls}")
        if any(e for _, e in waves9):
            fail(f"exhausted rays in the viewer: {waves9}")
        if th9.is_alive() or not got9.get("png", b"").startswith(
                b"\x89PNG") or got9.get("post") != 204 \
                or "mrays_s" not in got9.get("stats", {}):
            fail(f"the served page: {got9}")
        # The post resets the film: the camera input is applied once, and
        # the film is cleared right after it.
        k9 = [i for i, e in enumerate(events9) if e == "camera_input"]
        if len(k9) != 1 or events9[k9[0] + 1:k9[0] + 2] != ["film_init"]:
            fail(f"the camera post did not reset the film: {events9}")
        traces = [f for f in os.listdir(prof_dir)
                  if f.endswith(".pt.trace.json")]
        if not traces:
            fail(f"no trace file in {prof_dir}")
        newest = max((os.path.join(prof_dir, f) for f in traces),
                     key=os.path.getmtime)
        with open(newest) as fh:
            text = fh.read()
        print(f"  profile trace {newest}: {len(text)} bytes, names "
              f"traverse_kernel {text.count('traverse_kernel')} times")
        if "traverse_kernel" not in text:
            fail("the viewer's trace does not name traverse_kernel")
        del text
        if not keep:
            shutil.rmtree(out_dir)

        # One full-world wave (view 0, 1080p, 3 bounces) under the
        # profiler: device operations by time and the device's idle share
        # of the call.
        arrays = camera_arrays_for(cam0, sun, w, h, dev)
        pathtrace.render_wave(world, arrays, cam0.brick_position, cfg, w, h,
                              generator=gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof9:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pathtrace.render_wave(world, arrays, cam0.brick_position, cfg,
                                  w, h, generator=gen)
            torch.cuda.synchronize()
            wave_ms = (time.perf_counter() - t1) * 1e3
        busy_ms, span_ms, n_act = device_busy(prof9)
        print(f"  one profiled wave (view 0): {wave_ms:.3f} ms host, "
              f"{n_act} device activities over {span_ms:.3f} ms, "
              f"{busy_ms:.3f} ms busy -> device idle "
              f"{1 - busy_ms / wave_ms:.3f} of the wave; top device "
              f"operations (ms, share of the wave, calls):")

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        evs = prof9.key_averages()
        for title, rows in (
                ("kernels", [e for e in evs
                             if e.device_type == DeviceType.CUDA]),
                ("torch ops", [e for e in evs
                               if e.device_type != DeviceType.CUDA])):
            print(f"    by {title}:")
            for e in sorted(rows, key=dev_us, reverse=True)[:10]:
                print(f"    {dev_us(e) / 1e3:9.3f} ms  "
                      f"{100 * dev_us(e) / 1e3 / wave_ms:5.1f}%  "
                      f"{e.count:5d}x  {e.key[:90]}")
        ops = sorted((e for e in evs if e.device_type != DeviceType.CUDA),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
        print("    by host time (self): " + "; ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms ({e.count}x)"
            for e in ops), flush=True)
        del prof9, evs

    # ------------------------------------------------------------------
    from brickmap_tpu_torch.app import scaling
    from brickmap_tpu_torch.parallel import render as par
    from brickmap_tpu_torch.stream import pull_requests

    with phase("10 sharded paths and the dense stage: world size 1 over "
               "NCCL"):
        import torch.distributed as dist

        w, h = cfg.render.width, cfg.render.height
        n = w * h
        scaling.init_single_process(dev)
        try:
            mesh = par.make_mesh(1)
            print(f"  process group: backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, mesh {mesh.size} on "
                  f"{mesh.device}")
            cam0 = benchmark.benchmark_cameras()[0]
            arrays = camera_arrays_for(cam0, sun, w, h, dev)
            u = draw_wave_uniforms(n, cfg.render.max_bounces, gen, dev)
            plain_calls = {"B2": 0, "B3": 0, "B4f": 0, "B4b": 0}
            saved10 = [counting(ktrav, "trace_rays", "B2"),
                       counting(krec, "record_segments_plain", "B3"),
                       counting(kext, "extract_fwd_plain", "B4f"),
                       counting(kext, "extract_bwd_plain", "B4b")]

            def host_s(fn):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                return out, time.perf_counter() - t1

            ktrav.trace.launches = 0
            (rgb_s, cnt_s, req_s), sharded_s = host_s(
                lambda: par.render_wave_sharded(
                    mesh, world, arrays, cam0.brick_position, cfg, w, h,
                    uniforms=u))
            b2_sharded = ktrav.trace.launches
            (rgb_i, cnt_i, req_i), indices_s = host_s(
                lambda: pathtrace.wave_for_indices(
                    world, torch.arange(n, device=dev), arrays,
                    cam0.brick_position, cfg, w, h, uniforms=u))
            same = (torch.equal(rgb_s, rgb_i) and torch.equal(cnt_s, cnt_i)
                    and torch.equal(req_s["mask"], req_i["mask"])
                    and torch.equal(req_s["pos"], req_i["pos"])
                    and int(req_s["traced_rays"]) == int(req_i["traced_rays"])
                    and int(req_s["exhausted_rays"])
                    == int(req_i["exhausted_rays"]) == 0)
            print(f"  render_wave_sharded, view 0 at {w}x{h}: "
                  f"{sharded_s * 1e3:.3f} ms (wave_for_indices "
                  f"{indices_s * 1e3:.3f} ms), B2 launches {b2_sharded}, "
                  f"{int(req_s['traced_rays'])} rays traced, equal to "
                  f"wave_for_indices bit for bit: {same}")
            if b2_sharded < 5 or not same:
                fail("the sharded wave differs from wave_for_indices, or "
                     "skipped B2")
            del rgb_s, cnt_s, req_s, rgb_i, cnt_i, req_i

            # render_frame with the per-pixel uniforms of one render_wave.
            (rgb_w, cnt_w, req_w), wave_s = host_s(
                lambda: pathtrace.render_wave(
                    world, arrays, cam0.brick_position, cfg, w, h,
                    uniforms=u))
            reqs_w = pull_requests(req_w, n)
            _, inv_np = pathtrace._tile_permutation(w, h)
            inv = torch.from_numpy(inv_np.copy()).to(dev)
            u_px = {k: v[..., inv] if k in ("cone", "hemi") else v[inv]
                    for k, v in u.items()}
            chunk = min(61440, n)
            chunks = [torch.arange(min(s + chunk, n) - chunk,
                                   min(s + chunk, n), device=dev)
                      for s in range(0, n, chunk)]
            us = [{k: v[..., c] if k in ("cone", "hemi") else v[c]
                   for k, v in u_px.items()} for c in chunks]
            ktrav.trace.launches = 0
            (rgb_f, cnt_f, traced_f, reqs_f, exh_f), frame_s = host_s(
                lambda: pathtrace.render_frame(
                    world, arrays, cam0.brick_position, cfg, w, h,
                    rays_per_chunk=chunk, chunk_uniforms=us, queue_size=n))
            b2_frame = ktrav.trace.launches
            same = torch.equal(rgb_f, rgb_w) and torch.equal(cnt_f, cnt_w)
            print(f"  render_frame, view 0 in {len(chunks)} chunks of "
                  f"{chunk}: {frame_s * 1e3:.3f} ms (render_wave "
                  f"{wave_s * 1e3:.3f} ms), B2 launches {b2_frame}, "
                  f"{traced_f} rays traced "
                  f"(the wrapped chunk's repeats included), exhausted "
                  f"{exh_f}, {len(reqs_f)} requests (render_wave: "
                  f"{len(reqs_w)}); rgb and count equal to render_wave's "
                  f"on the same per-pixel uniforms: {same}")
            if b2_frame < len(chunks) or exh_f or not same \
                    or set(reqs_f) != set(reqs_w):
                fail("render_frame differs from render_wave")
            del rgb_w, cnt_w, req_w, rgb_f, cnt_f, u, u_px, us

            # The sparse step, sharded over the world of one, against the
            # single-process step on the same inputs.
            K = benchmark.SPARSE_K
            o10, d10, bg10, tgt10 = benchmark.sparse_inverse_rays(
                n, cfg.grid, dev)
            segs = krec.record_segments(o10, d10, world, cfg.grid,
                                        k_segments=K)
            cm10, occ10, alb10 = benchmark.active_fields(world, cfg.grid,
                                                         segs["cells"])
            del segs
            loss_1, (go_1, ga_1) = dsparse.l2_loss_and_grads_sparse(
                o10, d10, world, cm10, occ10, alb10, bg10, tgt10, cfg.grid,
                k_segments=K)
            torch.cuda.synchronize()
            krec.record_segments.launches = 0
            kext.extract_fwd.launches = 0
            kext.extract_bwd.launches = 0
            t0 = time.perf_counter()
            o_s, d_s, bg_s, tgt_s = par.shard_rays(mesh, (o10, d10, bg10,
                                                          tgt10))
            loss_s, go_s, ga_s = par.inverse_train_step_sparse(
                mesh, o_s, d_s, world, cm10, occ10, alb10, bg_s, tgt_s,
                cfg.grid, k_segments=K)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            launches10 = {"B3": krec.record_segments.launches,
                          "B4f": kext.extract_fwd.launches,
                          "B4b": kext.extract_bwd.launches}
            errs = [(float((a - b).abs().max()), float(b.abs().max()))
                    for a, b in ((go_s, go_1), (ga_s, ga_1))]
            print(f"  inverse_train_step_sparse, {n} rays, K = {K}, "
                  f"{occ10.shape[0]} active bricks: {step_s:.3f} s, "
                  f"launches {launches10}; loss {float(loss_s)!r} vs "
                  f"{float(loss_1)!r}; gradient max |diff| / max |grad| "
                  f"{errs}", flush=True)
            if any(v < 1 for v in launches10.values()):
                fail(f"a kernel of the sharded step did not launch: "
                     f"{launches10}")
            if float(loss_s) != float(loss_1) or any(
                    e > 1e-6 * m for e, m in errs):
                fail("the sharded sparse step differs from the "
                     "single-process step")
            del o10, d10, bg10, tgt10, cm10, occ10, alb10, go_1, ga_1
            del go_s, ga_s, o_s, d_s, bg_s, tgt_s

            # The scaling harness at one rank, on the scaling CLI's world
            # and frame (512^2 x 128, 512x288).
            from brickmap_tpu_torch.config import BrickmapConfig, \
                RenderConfig
            scfg = BrickmapConfig(grid=GridConfig(grid_size=512,
                                                  grid_height=128),
                                  render=RenderConfig(width=512, height=288))
            ssc = scene_mod.generate_terrain_scene(scfg.grid, device=dev)
            ktrav.trace.launches = 0
            krec.record_segments.launches = 0
            out10 = scaling.run_scaling_benchmark(
                ssc, scfg, 512, 288, device_counts=[1], verbose=False)
            print(f"  run_scaling_benchmark: {json.dumps(out10)}; B2 "
                  f"launches {ktrav.trace.launches}, B3 "
                  f"{krec.record_segments.launches}", flush=True)
            row = out10["rows"][0]
            if not (out10["platform"] == "gpu" and out10["num_processes"]
                    == 1 and row["forward_efficiency_pct"] == 100.0
                    and row["inverse_rays_per_s"] > 0
                    and ktrav.trace.launches > 0
                    and krec.record_segments.launches > 0):
                fail(f"the scaling harness: {out10}")
            del ssc
            if any(plain_calls.values()):
                fail(f"plain versions ran on the sharded paths: "
                     f"{plain_calls}")
        finally:
            ktrav.trace_rays, krec.record_segments_plain, \
                kext.extract_fwd_plain, kext.extract_bwd_plain = saved10
            dist.destroy_process_group()

        dense = benchmark.run_dense_inverse_benchmark(dev)
        print(f"  dense compositor fwd+bwd (64^3 grid, {dense['rays']} rays, "
              f"max_steps 192): {dense['mrays_per_s']:.4f} Mrays/s, "
              f"{dense['seconds']:.3f} s a call, loss {dense['loss']!r} on "
              f"{dense['device']}", flush=True)
        if not (math.isfinite(dense["loss"]) and dense["mrays_per_s"] > 0):
            fail(f"the dense stage: {dense}")

        krec.record_segments.launches = 0
        small = benchmark.run_sparse_inverse_benchmark_small(dev)
        print(f"  sparse stage on the small world (bench.py::_sparse_bwd_"
              f"bench, 1024^2 x 256, {small['bricks']} bricks, "
              f"{small['rays']} rays, K = {benchmark.SPARSE_K}): full "
              f"{small['full']:.4f} Mrays/s ({small['full_s']:.3f} s), "
              f"cached_step {small['cached_step']:.4f} Mrays/s "
              f"({small['cached_step_s']:.3f} s), loss {small['loss']!r}, "
              f"B3 launches {krec.record_segments.launches} on "
              f"{small['device']}", flush=True)
        if not (math.isfinite(small["loss"]) and small["full"] > 0
                and krec.record_segments.launches > 0):
            fail(f"the small-world sparse stage: {small}")

    for r in records.values():
        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if not math.isfinite(r[k]):
                fail(f"{r['name']}: {k} is not finite")
    print(smi_line())
    print(json.dumps({"kernels": [records[k] for k in
                                  ("B1", "B2", "B3", "B4f", "B4b")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
