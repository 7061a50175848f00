#!/usr/bin/env python3
"""Smoke test of brickmap_tpu_torch on one CUDA card.

    python3 chip_smoke.py [OUT_DIR]

OUT_DIR keeps phase 9's images, metrics and profiler trace (in a new
``viewer_*`` directory); without it they go to a temporary directory that
is removed.  Phases, each printing its seconds; any failure raises and exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels (nvcc, all sources at once, rebuilt even where a
   build exists) and the native heightfield (g++); print the ptxas summary,
   and fail if B1's, B2's, B3's, W0-W5's, R1-R2's or A1's build has a
   stack frame or spills;
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
   that spend the budget; two launches back to back), then on a 600^2 x 120
   terrain whose cell extents (75 x 75 x 15) do not divide by 4, resident
   and part unloaded.  Every output must be equal, ``t`` and ``resume_t``
   included;
5. the main path: the 4096^2 x 512 world built on the card, then the
   9-viewpoint benchmark at 1920x1080, 3 bounces (1 warm-up + 1 timed wave
   per view), with B2 held against its plain version at the main path's
   shape (view 0's primary rays) and timed there beside its bound, with
   its SIMD efficiency and ptxas line.  Then the wave kernels W0-W4 at
   view 0's full shape (2,073,600 lanes in tile order): W1, then for each
   of the wave's 5 traces W0 over the live rows, W2, B2, W0 over the
   exhausted rays and W4, then W3 (4 bounces and the final pass through
   the tile permutation), each from the same state as its plain version
   and equal to it (state, W0's indices and count, B2's inputs and
   outputs, W4's results; NaN equal to NaN; 0 mask flips), each timed
   alone beside its bound (W1, W0 and W2 at bounces 0 and 1, W0 also over
   trace 0's exhausted rows, with ``torch.nonzero`` beside every W0 shape
   and W0 timed both with its launches queued behind a device sleep and by
   events around each call; W2 likewise at bounces 0 and 1, the final
   trace and a count of 0 over the full capacity; W3 at bounces 0 and 1
   and the final pass; W4 at a zero count and on each trace's exhausted
   rays).  W0 and W4 again
   where rays exhaust: view 0's primaries traced
   with a starved budget, rescued with the wave's budget (none left) and
   with a starved one (some left), against the plain rescue passes, and
   W4 timed there.  Under ``torch.cuda.set_sync_debug_mode("error")``
   a first sighting of a wave's key (launched kernel by kernel) and a
   replay of view 0's captured CUDA graph: no synchronising call.
   Each wave of the benchmark must launch B2, W2, W3 and W4 5 times, W0
   10 and W1 once; no plain version may run.  Last, whole waves through
   W0-W4 against the same waves with their plain versions swapped in
   (view 0, view 7 whose primaries all miss, and view 0 with a starved
   trace budget): W2 equal to its plain version at each of the wave's 5
   traces, rgb within rtol 1e-4 / atol 1e-5, count, requests, traced and
   exhausted (0) equal;
5b. the wave as a CUDA graph (``render/wave_graph.py``): the 9 views at
   1920x1080 eagerly (B2's event hook set), then through the graphs on a
   stream of their own (each view's first two waves eager, its third
   captured, its fourth replayed, then a cycle in which view 0, evicted
   from the 8 graphs kept, runs eagerly and views 1-8 replay), every wave
   equal to the eager one bit for bit and ``render_wave``'s eager,
   capture and replay counts as the rule says; the peak allocation of
   each pass and
   the host ms of an eager call and a replay; one profiled replay: one
   ``cudaGraphLaunch``, 36 device kernels (the five draws and the
   graph's 31), no copy to the host, no stream synchronise,
   ``wave.graph_replays`` [1] and a ``wave.trace_rays`` count a trace;
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
   steps, on fields that are views of one interleaved ``field4``).  B3,
   R1, B4f, R2 and B4b must each launch, R1/B4f/R2/B4b once a 16,384-ray
   slice in every step, A1 (Adam + clip) once an Adam step (over the
   fields' one storage),
   no plain version may run, no ray may
   exhaust its budget, the loss must be finite and fall and the gradients
   finite and not all zero.  Then one uncached step through the kernels is
   held against one with their plain versions swapped in (loss equal,
   gradients within 1e-6 of their largest value); one cached step and one
   Adam step on the interleaved fields against the same on contiguous
   copies of them (the loss equal, the gradients within 1e-6 of their
   largest value, A1 over the storage in one launch equal bit for bit to
   A1 a field in two, each step's peak allocation printed), B3 against its plain
   version on the frame's rays (with its SIMD efficiency and ptxas line),
   and R1, B4f, R2 and B4b on the first 16,384-ray slice of the step's
   seg_cache at K = 8 (R1 also on its K = 2 and 4 column cuts, R2 also on
   random values with occupancies at 0, 1 and outside [0, 1]; R1 and R2
   also at 1, 31 and 33 rays, at the rays that fill the R2 warps and the R1
   threads resident at once, one less and one more, and on the step's
   last, partial slice, with each one's launch shape and dynamic shared
   memory printed; R1 also on segments whose crossing counts saturate their
   int32 conversion, where a build of R1 with the sweep on every axis must
   differ, so that the kernel's binary search is shown reached and exact;
   R2 refusing views of its inputs off their 16- and 8-byte alignment; all
   equal bit for bit except B4b, within 1e-6), each timed there, L2 cold, beside
   its bound and, for B4f/B4b, a PyTorch call; one slice is timed by part
   and profiled: its host ms, device busy ms and idle share, at most 6
   kernel launches and no cumprod, addcmul, index_select or index_add_
   kernel.  Last, A1 against its plain version, bit for bit (a NaN as a
   NaN), over steps 1 to 3 on fields of 2^26 + 3 and 3 * 2^26 + 1 elements,
   with gradients at 0, NaN and across the clip's bounds; then at the
   benchmark's field sizes (1,512,833,024 elements, the albedo past 2^32
   bytes): A1 alone beside its bound (28 bytes an element), one profiled
   ``adam_step``, whose only kernel must be A1, one step bit for bit
   against the plain version (run in slices of 2^26 elements and timed
   over all of them), and one ``torch.optim.Adam`` (foreach) step +
   ``clamp_``;
8. streaming: a cold start on the phase-5 world (``run_streaming_
   benchmark``: view 0, 1920x1080, 3 bounces, queue 1024, segments from 16
   rows, 48 waves, each wave's requests serviced before the next).  B2 is
   held against its plain version on wave 0's primary rays over the cold
   scene; every wave must launch B2 and W0-W4, no plain version may run, no
   ray may
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
   page and posts one fly-camera move.  Three PNGs and ``frames`` 3, B2 and
   W0-W4 in every wave launched kernel by kernel (a replayed one launches
   its graph and no wrapper), W5 (the 8-bit present) once a wave and once a
   frame's PNG, no plain version, 0 exhausted, the post applied
   once and followed by a film reset, and the trace file naming
   ``traverse_kernel``.  Then W5 on the films of two view-0 waves at
   960x540 (the live viewer's shape) and 1920x1080, equal to its plain
   version bit for bit, timed alone beside its bound (19 B a pixel) with
   its ptxas line.  Then one view-0 wave under ``torch.profiler``: its
   kernel launches, device-to-host (synchronising) and pageable
   host-to-device copies, the device operations by time and the device's
   idle share of the wave: at most 150 launches, no device-to-host copy
   and no stream synchronise (the wave makes no host round trip), no
   pageable host-to-device copy;
10. the sharded paths at world size 1 over NCCL: ``render_wave_sharded``
   equal to ``wave_for_indices`` on the same pixels and uniforms bit for
   bit; ``render_frame`` in 61,440-ray chunks equal to one
   ``render_wave`` with the same per-pixel uniforms (0 exhausted, the same
   requests; W0-W4 in every chunk, no plain version); ``inverse_train_step_sparse`` at 2,073,600 rays, K = 8 equal
   to ``l2_loss_and_grads_sparse`` (loss equal, gradients within 1e-6 of
   their largest value) through B3, R1, B4f, R2 and B4b;
   ``run_scaling_benchmark``
   at one rank on the scaling CLI's 512^2 x 128 world at 512x288; then the
   dense compositor's fwd+bwd Mrays/s (``run_dense_inverse_benchmark``)
   and the sparse step on the 1024^2 x 256 world
   (``run_sparse_inverse_benchmark_small``, bench.py's small-world stage;
   B3, R1, B4f, R2 and B4b must each launch).

The second-to-last line is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import math
import os
import shutil
import statistics
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
STARVED_STEPS = 16             # a trace budget that leaves rays exhausted
# B2's instructions a step in its SASS (notes/probe_torch_b2.py
# --sass-dir): ~155 on a top step through the empty-space skip (its three
# IEEE divisions ~20 each), the LoD-byte sub-DDA loop 44 (the brick's 49);
# and the H100 SXM's warp schedulers (132 SMs x 4), a warp instruction a
# cycle each.
B2_TOP_STEP_INSTR, B2_DESCEND_STEP_INSTR = 155, 44
ISSUE_SLOTS = 132 * 4


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


def sm_ghz() -> float:
    """The SM clock from a device sleep of 10^8 cycles, in GHz (it differs
    between machines: compare times only within one run)."""
    import torch

    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    torch.cuda.synchronize()
    return 100_000_000 / a.elapsed_time(b) / 1e6


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b2_bound(plain: dict) -> tuple[float, str]:
    """B2's least time on the rays of its plain version's result
    ``plain``: per ray in, origin, direction, entry normal (36 B), tmin (4),
    ok (1); out, hit, request, exhausted (3), t, resume (8), normal (12),
    request_pos (12), steps (4); then each distinct index word (4 B) and
    brick row (64 B) the rays read, once; DDA_STEP_OPS a step."""
    nbytes = plain["hit"].shape[0] * (41 + 39) \
        + 4 * int(plain["cells_read"].sum()) \
        + 64 * int(plain["rows_read"].sum())
    return bound(nbytes, int(plain["ray_iters"].sum()) * DDA_STEP_OPS)


def b2_issue_ms(plain: dict, ghz: float) -> float:
    """B2's steps issued with every lane of each warp busy: top steps
    (index-word reads) at B2_TOP_STEP_INSTR, descend steps at
    B2_DESCEND_STEP_INSTR instructions, over the warp schedulers at the SM
    clock ``ghz``.  An estimate of the issue's share, not a bound: steps
    without a skip are shorter, the brick's sub-DDA step longer."""
    top = int(plain["ray_words"].sum())
    descend = int(plain["ray_iters"].sum()) - top
    instr = (top * B2_TOP_STEP_INSTR + descend * B2_DESCEND_STEP_INSTR) / 32
    return instr / (ISSUE_SLOTS * ghz * 1e9) * 1e3


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


def entry_ptxas(name: str, entry: str) -> str:
    """Registers, stack and spills of the kernel ``entry`` (a part of its
    mangled name) in this run's build of ``name``."""
    from brickmap_tpu_torch.kernels import build

    out, inside = [], False
    for line in build.ptxas_summary.get(name, []):
        if "Compiling entry" in line:
            inside = entry in line
        elif inside and ("spill" in line or "Used" in line):
            out.append(line.split(":")[-1].strip())
    return "; ".join(out)


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


# Float operations a lane of the wave kernels does at the least (a libm
# call counted as one): W1 the camera basis, jitter and disk (~70); W2 the
# slab clip and entry normal (~60); W3 two sky evaluations, the cone and
# hemisphere samples and the hit point (~300).  Bytes bind all three.
W_OPS = {"W1": 70, "W2": 60, "W3": 300}
# Operations of the replay kernels at the least, counted where the data
# needs them.  R1 a valid segment: the slot (~10), the nudged entry, DDA
# set-up and tie windows of 3 axes (~60), and for each of 3 axes x 22 steps
# a 5-step binary search (4 each: add, shift, compare, select) and the
# voxel id and bounds (4): 1,584 + 70; and R1_RANK_OPS a crossing's rank on
# an axis the ray moves along (its time, 3; two crossing counts of 8:
# subtract, divide, add, round, convert, select, 2 clamps; 2 adds and a
# select).  R2 a valid step: forward clip and mask 3, weight 1, colour 6,
# transmittance 2; backward s 5, cotangent 2, suffix 4, weight 1, albedo
# cotangents 3, clip's gradient 4.
R1_OPS = 1654
R1_RANK_OPS = 22
R2_STEP_OPS = 31


def wave_bytes(kind: str, n: int, live: int) -> int:
    """Bytes a wave kernel must move: W1 per lane reads idx, stratum (8 B
    each), jitter, lens (8 each) and writes both rows of the ray buffers
    (48), live (2), the position map (8), accum, sh_color (24), req_mask
    (1), req_pos (12); W2 per ray reads its lane (4) and ray (24) and
    writes the five inputs of B2 (41) and its row (4); W3 per lane reads
    live (2), the extension ray (24), sh_color, accum (24), the request
    (13) and its four uniforms (16) and writes the map (8), both rays
    (48), live (2), sh_color, accum (24), the request (13), plus per live
    ray its row (4) and B2's results (31); W3's final pass reads live,
    sh_color, accum, the request and dst (55) and writes rgb, count, mask,
    pos (29) and the map (8)."""
    if kind == "W1":
        return n * (32 + 95)
    if kind == "W2":
        return n * (28 + 45)
    if kind == "W3":
        return n * (79 + 95) + live * 35
    return n * (55 + 37) + live * 35


def state_rows_differ(a, b) -> int:
    """Rows where two tensors differ (NaN equal to NaN)."""
    import torch

    diff = a != b
    if a.is_floating_point():
        diff &= ~(torch.isnan(a) & torch.isnan(b))
    return int(diff.reshape(a.shape[0], -1).any(1).sum()) if a.dim() \
        else int(diff)


def alone_ms(wrapper, fn, reps: int) -> float:
    """Mean ms of ``wrapper``'s kernel over ``reps`` calls of ``fn``, by
    the CUDA events its hook records around each launch alone (``fn`` may
    restore the kernel's inputs outside them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    wrapper.events = []
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in wrapper.events) / len(
            wrapper.events)
    finally:
        wrapper.events = None


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
    from brickmap_tpu_torch.kernels import traverse as ktrav, wave as kwave
    from brickmap_tpu_torch.ops import wave as owave
    from brickmap_tpu_torch.ops.traverse import trace_clipped_rays, \
        trace_rays
    from brickmap_tpu_torch.render import pathtrace, wave_graph
    from brickmap_tpu_torch.render.camera import Camera, \
        camera_arrays_for, primary_rays_from_arrays
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms
    from brickmap_tpu_torch.single_brick import render_single_brick

    with phase("2 build"):
        native_ok = []
        th = threading.Thread(target=lambda: native_ok.append(
            native.available()))
        th.start()
        # R1 with the sweep on every axis (BM_R1_MERGE=2), for phase 7's
        # check that its saturating segments reach the binary search.
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        sweep_so = os.path.join(build.BUILD_DIR, "libreplay_sweep.so")
        sweep = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-DBM_R1_MERGE=2", "-o",
             sweep_so, os.path.join(build.CSRC, "replay.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            secs = build.build(force=True)
        finally:
            sweep_err = sweep.communicate()[1]
            th.join()
        if sweep.returncode != 0:
            fail(f"nvcc of replay.cu with BM_R1_MERGE=2 failed:\n{sweep_err}")
        print(f"  nvcc build of {list(build.KERNELS)}: {secs:.2f} s")
        for name, lines in build.ptxas_summary.items():
            for line in lines:
                print(f"  ptxas {name}: {line}")
        if not native_ok[0]:
            fail("native heightfield (g++) did not build")
        for name in ("brick", "traverse", "record", "wave", "replay",
                     "adam"):
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

        # A world whose cell extents do not divide by 4 (75 x 75 x 15
        # cells, superchunks of 5 bricks), resident and part unloaded.
        grid_odd = GridConfig(grid_size=600, grid_height=120,
                              supergrid_cell_size=5)
        odd = scene_mod.generate_terrain_scene(grid_odd, device=dev)
        iv_odd = odd.index_volume.clone()
        flip = ((iv_odd & i32(BRICK_FLAG_BITS)) != 0) & (torch.rand(
            iv_odd.shape, generator=gen, device=dev) < 1 / 3)
        iv_odd[flip] = (iv_odd[flip] & BRICK_LOD_BITS) | BRICK_UNLOADED_BIT
        odd_streaming = scene_mod.TorchScene(iv_odd, odd.pool_words,
                                             odd.pool_base)
        lo = torch.tensor([-40.0, -40.0, -20.0], device=dev)
        hi = torch.tensor([640.0, 640.0, 140.0], device=dev)
        o_odd = lo + torch.rand((d_rand.shape[0], 3), generator=gen,
                                device=dev) * (hi - lo)
        for sc_tag, sc in (("resident", odd), ("streaming", odd_streaming)):
            for tag, cam_b, steps in (("random rays", (0, 0, 0), budget),
                                      ("LoD camera (340, 30, 8)",
                                       (340, 30, 8), budget),
                                      ("tiny budget", (0, 0, 0), 16)):
                got = ktrav.trace(o_odd, d_rand, sc, cam_b, grid_odd, steps)
                want = trace_rays(o_odd, d_rand, sc.index_volume,
                                  sc.pool_words, sc.pool_base, cam_b,
                                  grid_odd, max_iters=steps)
                torch.cuda.synchronize()
                check_b2(f"75x75x15-cell world, {sc_tag} {tag}", got, want,
                         b2_err)
        del iv, first, second, odd, odd_streaming, iv_odd, got, want

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
        ray_bytes = nray * (41 + 39)
        b2_bytes = ray_bytes + 4 * cells + 64 * rows
        requested = ray_bytes + 4 * words_read + 64 * bricks_read
        b2_bound_ms, b2_by = b2_bound(want)
        print(f"  B2 at {nray} rays: {b2_ms:.4f} ms per launch (events "
              f"around the launch; plain {b2_plain_ms:.1f} ms); distinct "
              f"reads {cells} index words + {rows} brick rows -> {b2_bytes} "
              f"bytes; {steps} DDA steps -> bound {b2_bound_ms:.4f} ms by "
              f"{b2_by}; bytes requested {requested} ({words_read} "
              f"index-word and {bricks_read} brick-row reads)", flush=True)
        # B2 alone, its launches queued behind a device sleep (the device's
        # time a launch, as a wave pays it), at the main path's shapes:
        # these primaries, then (below) the wave's bounce-1 and shadow
        # traces and a count of 0 over its capacity, and phase 8's cold
        # streaming primaries; beside the bytes bound and the issue
        # estimate at the SM clock.
        ghz5 = sm_ghz()
        b2q = {}    # shape -> (rays, queued ms, bound ms, by, issue ms)

        def time_b2(shape, inputs, count, plain, sc=None):
            sc = world if sc is None else sc
            ms = benchmark.kernel_alone_ms([lambda: ktrav.trace_clipped(
                inputs, count, sc, cam0.brick_position, cfg.grid,
                budget)], 20)
            if plain is None:    # a count of 0: the count's 4 bytes
                b2q[shape] = (0, ms, *bound(4, 0), 0.0)
            else:
                b2q[shape] = (int(count), ms, *b2_bound(plain),
                              b2_issue_ms(plain, ghz5))

        def print_b2(shape):
            m, ms, bms, by, iss = b2q[shape]
            print(f"  B2 alone at {shape} ({m} rays): {ms:.4f} ms queued, "
                  f"bound {bms:.4f} ms by {by} ({100 * bms / ms:.1f}%), "
                  f"issue at full lanes {iss:.4f} ms "
                  f"({100 * iss / ms:.1f}%; SM clock {ghz5:.3f} GHz)",
                  flush=True)

        inputs0, _ = ktrav.launch_inputs(o0, d0, cfg.grid)
        time_b2("view 0 primaries", inputs0,
                torch.full((1,), nray, dtype=torch.int32, device=dev), want)
        print_b2("view 0 primaries")
        del inputs0
        print(f"  B2 schedule at {nray} rays: SIMD efficiency in launch "
              f"order {benchmark.launch_order_simd(want['ray_iters']):.4f}"
              f"; {benchmark.B2_BLOCKS_PER_SM} blocks of 128 an SM on {sms} "
              f"SMs; ptxas "
              f"{ptxas_line('traverse')}", flush=True)
        del got, want

        # W0-W4 at the main path's shape: view 0's wave of 2,073,600 lanes
        # in tile order, every stage on both sides from the same state,
        # the kernel's and the plain version's outputs equal.
        n = w * h
        nb = cfg.render.max_bounces
        u5 = draw_wave_uniforms(n, nb, gen, dev)
        perm5 = pathtrace._tile_order(w, h, dev)
        st, ref = owave.new_state(n, dev), owave.new_state(n, dev)
        w_err = [0.0]
        wrec = {}      # (kernel, shape) -> (ms, plain ms, bound ms, by)
        w_events = {}  # (W1 or W3, shape) -> ms by events around the call

        def w_equal(tag, got, want):
            for k in want:
                bad = state_rows_differ(got[k], want[k])
                if bad:
                    fail(f"{tag}: {k} differs on {bad} rows")
                if got[k].is_floating_point():
                    ok = ~torch.isnan(want[k])
                    if bool(ok.any()):
                        w_err[0] = max(w_err[0], float(
                            (got[k][ok] - want[k][ok]).abs().max()))

        def host_ms(fn, reps=2):
            best = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                best.append((time.perf_counter() - t1) * 1e3)
            return min(best)

        def w_bound(kind, lanes, live=0):
            return bound(wave_bytes(kind, lanes, live),
                         lanes * W_OPS[kind[:2]])

        kwave.primary(perm5, u5, arrays, w, h, st)
        owave.primary_plain(perm5, u5, arrays, w, h, ref)
        torch.cuda.synchronize()
        w_equal("W1", st, ref)
        wrec[("W1", "view 0")] = (
            benchmark.kernel_alone_ms([lambda: kwave.primary(
                perm5, u5, arrays, w, h, st)], 20),
            host_ms(lambda: owave.primary_plain(perm5, u5, arrays, w, h,
                                                ref)), *w_bound("W1", n))
        w_events[("W1", "view 0")] = alone_ms(kwave.primary, lambda: (
            kwave.primary(perm5, u5, arrays, w, h, st)), 5)
        print(f"  W1 at {n} lanes: state equal to the plain version's "
              f"(rays, live, map, accum, requests, counters)", flush=True)
        flips = 0
        # W0 shape -> (rows, set rows, queued ms, events ms, plain ms,
        # torch.nonzero ms); W4 trace -> (rays, ms, bound ms, by)
        w0rec, w4rec = {}, {}
        w2_events = {}   # W2 shape -> ms by events around the call
        w4_err = [0.0]
        w0_err = [0.0]
        rescue_args = pathtrace.rescue_budget(cfg), pathtrace.RESCUE_PASSES
        cam_b = cam0.brick_position

        def w0_equal(tag, mask, limit=None):
            """W0 against its plain version (``torch.nonzero``): the count
            and the indices below it equal."""
            got = kwave.compact(mask, limit)
            want = owave.compact_plain(mask, limit)
            m = int(want[1])
            k = min(m, int(got[1]))
            w0_err[0] = max(w0_err[0], abs(int(got[1]) - m), float(
                (got[0][:k] - want[0][:k]).abs().max()) if k else 0.0)
            if not (torch.equal(got[1], want[1])
                    and torch.equal(got[0][:m], want[0][:m])):
                fail(f"W0 {tag}: count {int(got[1])} against {m}, or the "
                     f"indices below it differ")
            return got

        def w4_equal(tag, res, rows, n_rows, lanes, m, budget_, passes,
                     stats=None):
            """W4 on copies of B2's results against the plain rescue
            passes: every key equal on every row below the trace's count
            ``m``; returns the plain version's results."""
            got = {k: v.clone() for k, v in res.items()}
            want = {k: v.clone() for k, v in res.items()}
            rays = st["rays_o"], st["rays_d"]
            kwave.rescue(got, rows, n_rows, lanes, *rays, world, cam_b,
                         cfg.grid, budget_, passes)
            owave.rescue_plain(want, rows, n_rows, lanes, *rays, world,
                               cam_b, cfg.grid, budget_, passes, stats)
            torch.cuda.synchronize()
            for k in owave.RESCUE_KEYS:
                bad = state_rows_differ(got[k][:m], want[k][:m])
                if bad:
                    fail(f"W4 {tag}: {k} differs on {bad} rows")
                if m and got[k].is_floating_point():
                    w4_err[0] = max(w4_err[0], float(
                        (got[k][:m] - want[k][:m]).abs().max()))
            return want

        def w4_bound(n_w4, stats):
            """W4's least time on ``n_w4`` rays whose passes the plain
            rescue counted in ``stats``: per ray its row and lane (8 B), ray
            (24), resume_t (4) read, B2's seven keys (35) written; then each
            distinct index word (4 B) and brick row (64 B) its passes read;
            12 operations a step.  Returns (ms, by)."""
            nbytes = n_w4 * 71 + 4 * int(stats["cells_read"].sum()) \
                + 64 * int(stats["rows_read"].sum())
            return bound(nbytes, stats["steps"] * DDA_STEP_OPS)

        def time_w4(res, rows, n_rows, lanes, stats):
            """W4 alone on copies of B2's results (restored before each
            launch, outside its events): (rays, ms, bound ms, by)."""
            work = {k: v.clone() for k, v in res.items()}

            def run():
                for k, v in res.items():
                    work[k].copy_(v)
                kwave.rescue(work, rows, n_rows, lanes, st["rays_o"],
                             st["rays_d"], world, cam_b, cfg.grid,
                             *rescue_args)
            n_w4 = int(n_rows)
            return (n_w4, alone_ms(kwave.rescue, run, 3),
                    *w4_bound(n_w4, stats))

        def time_w0(shape, mask, limit=None):
            """W0 alone on ``mask`` (its first ``limit`` rows): launches
            queued behind a device sleep (the device's time a launch, as a
            wave pays it), and CUDA events around each call with the host
            not ahead (mostly the launch's submission); the plain version
            and ``torch.nonzero`` (which synchronises) beside it."""
            rows_ = mask.shape[0] if limit is None else int(limit)
            head = mask[:rows_]
            w0rec[shape] = (
                rows_, int(head.sum()),
                benchmark.kernel_alone_ms(
                    [lambda: kwave.compact(mask, limit)], 50),
                alone_ms(kwave.compact, lambda: kwave.compact(mask, limit),
                         5),
                host_ms(lambda: owave.compact_plain(mask, limit)),
                cuda_ms(lambda: torch.nonzero(head), 5))

        for bounce in range(nb + 2):
            final = bounce == nb + 1
            shape = "final" if final else f"bounce {bounce}"
            lanes, count = w0_equal(f"trace {bounce}", st["live"])
            m = int(count)
            if bounce <= 1:
                time_w0(shape, st["live"])
            inp = kwave.gather_clip(st["rays_o"], st["rays_d"], lanes, count,
                                    cfg.grid, pos=st["pos"])
            inp_p = owave.gather_clip_plain(ref["rays_o"], ref["rays_d"],
                                            lanes, count, cfg.grid,
                                            pos=ref["pos"])
            torch.cuda.synchronize()
            keys = ("clipped", "dirs", "entry_normal", "tminn", "ok")
            w_equal(f"W2 trace {bounce}", dict(
                zip(keys, (a[:m] for a in inp)), pos=st["pos"]), dict(
                zip(keys, (a[:m] for a in inp_p)), pos=ref["pos"]))
            if bounce <= 1 or final:
                # Queued behind a device sleep (the device's time a launch,
                # as a wave pays it); events around the call beside it.
                def run_w2(n_=count):
                    kwave.gather_clip(st["rays_o"], st["rays_d"], lanes, n_,
                                      cfg.grid, pos=st["pos"])
                wrec[("W2", shape)] = (
                    benchmark.kernel_alone_ms([run_w2], 50),
                    host_ms(lambda: owave.gather_clip_plain(
                        ref["rays_o"], ref["rays_d"], lanes, count, cfg.grid,
                        pos=ref["pos"])), *w_bound("W2", m))
                w2_events[shape] = alone_ms(kwave.gather_clip, run_w2, 5)
                if bounce == 0:
                    # A count of 0 over the full capacity: one wave of
                    # blocks that return (its bound reads the count).
                    zero_n = torch.zeros(1, dtype=torch.int32, device=dev)
                    w2_zero = (lanes.shape[0], benchmark.kernel_alone_ms(
                        [lambda: run_w2(zero_n)], 50))
                    time_b2(f"a count of 0 over {lanes.shape[0]} rows", inp,
                            zero_n, None)
                else:
                    time_b2(shape if bounce == 1 else "the shadow trace",
                            inp, count, trace_clipped_rays(
                                *(a[:m] for a in inp), world.index_volume,
                                world.pool_words, world.pool_base, cam_b,
                                cfg.grid, max_iters=budget))
            res = ktrav.trace_clipped(inp, count, world, cam_b, cfg.grid,
                                      budget)
            del inp, inp_p
            rows, n_rows = w0_equal(f"exhausted {bounce}", res["exhausted"],
                                    count)
            if bounce == 0:
                time_w0("the exhausted rows, trace 0", res["exhausted"],
                        count)
                res_cap, rows_cap, lanes_cap = res, rows, lanes
            stats = {}
            w4_equal(f"trace {bounce}", res, rows, n_rows, lanes, m,
                     *rescue_args, stats)
            if int(n_rows):
                w4rec[f"trace {bounce}"] = time_w4(
                    res, rows, n_rows, lanes, stats)
            kwave.rescue(res, rows, n_rows, lanes, st["rays_o"],
                         st["rays_d"], world, cam_b, cfg.grid, *rescue_args)
            print(f"  W0, W2, W4 trace {bounce}: {m} rays of "
                  f"{st['live'].shape[0]} rows, {int(n_rows)} exhausted; "
                  f"W0's indices and count equal to torch.nonzero's, B2's "
                  f"five inputs and the lanes' rows equal to aabb_clip's "
                  f"(plain), W4 equal to the plain rescue passes",
                  flush=True)
            cone = None if final else u5["cone"][bounce]
            hemi = None if final else u5["hemi"][bounce]
            dst = perm5 if final else None
            saved = {k: v.clone() for k, v in st.items()} \
                if bounce <= 1 or final else None
            out = kwave.shade(bounce, st, res, cone, hemi, sun, cfg, final,
                              dst)
            out_p = owave.shade_plain(bounce, ref, res, cone, hemi, sun, cfg,
                                      final, dst)
            torch.cuda.synchronize()
            flips += state_rows_differ(st["live"], ref["live"]) \
                + state_rows_differ(st["req_mask"], ref["req_mask"])
            w_equal(f"W3 {shape}", st, ref)
            if final:
                w_equal("W3 final outputs", {
                    "rgb": out[0], "count": out[1], "mask": out[2]["mask"],
                    "pos": out[2]["pos"]}, {
                    "rgb": out_p[0], "count": out_p[1],
                    "mask": out_p[2]["mask"], "pos": out_p[2]["pos"]})
            print(f"  W3 {shape}: state{' and outputs' if final else ''} "
                  f"equal to the plain version's; traced "
                  f"{int(st['counters'][0])}, exhausted "
                  f"{int(st['counters'][1])}", flush=True)
            if saved is not None:
                tmp = {}

                def restore():
                    for k, v in saved.items():
                        tmp[k] = v.clone()

                def run_w3():
                    restore()
                    kwave.shade(bounce, tmp, res, cone, hemi, sun, cfg,
                                final, dst)

                def run_plain():
                    restore()
                    owave.shade_plain(bounce, tmp, res, cone, hemi, sun, cfg,
                                      final, dst)
                # Queued behind a device sleep, the restoring copies
                # outside the events; events around the call beside it.
                wrec[("W3", shape)] = (
                    benchmark.kernel_alone_ms([lambda: kwave.shade(
                        bounce, tmp, res, cone, hemi, sun, cfg, final, dst)],
                        10, restore), host_ms(run_plain),
                    *w_bound("W3" if not final else "W3f", n, m))
                w_events[("W3", shape)] = alone_ms(kwave.shade, run_w3, 5)
                del tmp, saved
            del res, out, out_p
        if flips:
            fail(f"W3: {flips} mask flips against the plain version")
        for (kind, shape), (ms, pms, bms, by) in wrec.items():
            print(f"  {kind} alone at {shape}: {ms:.4f} ms (plain "
                  f"{pms:.3f} ms), bound {bms:.4f} ms by {by} "
                  f"({100 * bms / ms:.1f}%)", flush=True)
        for shape, ev_ms in w2_events.items():
            print(f"  W2 at {shape}: {wrec[('W2', shape)][0]:.4f} ms queued, "
                  f"{ev_ms:.4f} ms by events around the call", flush=True)
        for (kind, shape), ev_ms in w_events.items():
            print(f"  {kind} at {shape}: {wrec[(kind, shape)][0]:.4f} ms "
                  f"queued, {ev_ms:.4f} ms by events around the call",
                  flush=True)
        for shape in b2q:
            if shape != "view 0 primaries":
                print_b2(shape)
        print(f"  W2 alone at a zero count over {w2_zero[0]} rows: "
              f"{w2_zero[1]:.4f} ms queued, bound {bound(4, 0)[0]:.6f} ms; "
              f"SM clock from a device sleep {sm_ghz():.3f} GHz",
              flush=True)
        for shape, (rows_, set_, ms, ev_ms, pms, nz_ms) in w0rec.items():
            bms, by = bound(rows_ + 4 * set_, 0)
            print(f"  W0 alone at {shape} ({rows_} rows, {set_} set): "
                  f"{ms:.4f} ms queued, {ev_ms:.4f} ms by events around the "
                  f"call (plain {pms:.3f} ms, torch.nonzero {nz_ms:.4f} ms),"
                  f" bound {bms:.4f} ms by {by} ({100 * bms / ms:.1f}%)",
                  flush=True)
        # W4 at a zero count over the capacity (the wave's common case):
        # launches queued behind a device sleep; its bound reads the count.
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        w4_zero_ms = benchmark.kernel_alone_ms([lambda: kwave.rescue(
            res_cap, rows_cap, zero, lanes_cap, st["rays_o"], st["rays_d"],
            world, cam_b, cfg.grid, *rescue_args)], 50)
        bms, by = bound(4, 0)
        print(f"  W4 alone at a zero count over {rows_cap.shape[0]} rows: "
              f"{w4_zero_ms:.4f} ms queued, bound {bms:.6f} ms by {by}",
              flush=True)
        del res_cap, rows_cap, lanes_cap
        for trace, (n_w4, ms, bms, by) in w4rec.items():
            print(f"  W4 alone at {trace}'s {n_w4} exhausted rays: "
                  f"{ms:.4f} ms, bound {bms:.4f} ms by {by} "
                  f"({100 * bms / ms:.1f}%)", flush=True)
        print(f"  W1-W3: 0 mask flips, max |kernel - plain| {w_err[0]}; "
              f"ptxas {ptxas_line('wave')}", flush=True)

        # W0 and W4 where rays do exhaust: view 0's primaries traced with a
        # starved budget, then rescued with the wave's budget (every ray
        # rescued) and with a starved one (rays still exhausted after the
        # passes), each against the plain passes.
        kwave.primary(perm5, u5, arrays, w, h, st)
        lanes, count = w0_equal("starved primaries", st["live"])
        m = int(count)
        res = ktrav.trace_clipped(
            kwave.gather_clip(st["rays_o"], st["rays_d"], lanes, count,
                              cfg.grid), count, world, cam_b, cfg.grid,
            STARVED_STEPS)
        rows, n_rows = w0_equal("starved exhausted", res["exhausted"], count)
        n_exh = int(n_rows)
        w4_stats = {}
        for tag, rb in (("the wave's rescue budget", rescue_args[0]),
                        ("a starved rescue budget", STARVED_STEPS)):
            want = w4_equal(tag, res, rows, n_rows, lanes, m, rb,
                            rescue_args[1],
                            w4_stats if rb == rescue_args[0] else None)
            left = int(want["exhausted"][:m].sum())
            print(f"  W4 on {n_exh} of {m} primaries exhausted at "
                  f"{STARVED_STEPS} steps, {tag} ({rb} steps, "
                  f"{rescue_args[1]} passes): {left} still exhausted; "
                  f"every key equal to the plain passes'", flush=True)
            if not n_exh or (left == 0) != (rb == rescue_args[0]):
                fail(f"W4 {tag}: {n_exh} exhausted, {left} left")
            del want
        saved = {k: v.clone() for k, v in res.items()}

        def run_w4():
            for k, v in saved.items():
                res[k].copy_(v)
            kwave.rescue(res, rows, n_rows, lanes, st["rays_o"],
                         st["rays_d"], world, cam_b, cfg.grid, *rescue_args)

        w4_ms = alone_ms(kwave.rescue, run_w4, 3)
        w4_plain_ms = host_ms(lambda: owave.rescue_plain(
            {k: v.clone() for k, v in saved.items()}, rows, n_rows, lanes,
            st["rays_o"], st["rays_d"], world, cam_b, cfg.grid,
            *rescue_args), reps=1)
        w4_bms, w4_by = w4_bound(n_exh, w4_stats)
        print(f"  W4 alone on the {n_exh} rays: {w4_ms:.4f} ms (plain "
              f"{w4_plain_ms:.1f} ms), {w4_stats['steps']} DDA steps -> "
              f"bound {w4_bms:.4f} ms by {w4_by} "
              f"({100 * w4_bms / w4_ms:.1f}%)", flush=True)
        del res, saved

        # Waves with every synchronising call an error: no host round trip
        # between W1 and the final W3, launched kernel by kernel (the first
        # sighting of a key) and replayed as a CUDA graph.  The mode must
        # refuse a nonzero, or it checks nothing.  A first wave of a frame
        # size copies its tile order and the sky constants to the card
        # once; the third wave in a row of a key captures it (a capture
        # may synchronise).
        for _ in range(3):
            pathtrace.render_wave(world, arrays, cam_b, cfg, w, h,
                                  generator=gen)
        torch.cuda.synchronize()
        cam_moved = (cam_b[0] + 1, *cam_b[1:])
        ways0 = (wave_graph.calls[wave_graph.EAGER],
                 wave_graph.calls[wave_graph.REPLAY])
        torch.cuda.set_sync_debug_mode("error")
        try:
            try:
                torch.nonzero(st["live"])
                fail("set_sync_debug_mode('error') let a nonzero through")
            except RuntimeError:
                pass
            try:
                first = pathtrace.render_wave(world, arrays, cam_moved, cfg,
                                              w, h, generator=gen)
                got = pathtrace.render_wave(world, arrays, cam_b, cfg, w, h,
                                            generator=gen)
            except RuntimeError as e:
                fail(f"a synchronising call inside the wave: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ways = (wave_graph.calls[wave_graph.EAGER] - ways0[0],
                wave_graph.calls[wave_graph.REPLAY] - ways0[1])
        if ways != (1, 1):
            fail(f"under set_sync_debug_mode('error') {ways[0]} eager waves "
                 f"and {ways[1]} replays, not 1 and 1")
        print(f"  a first sighting and a replay of view 0's wave under "
              f"set_sync_debug_mode('error'): no synchronising call; "
              f"{int(first[2]['traced_rays'])} and "
              f"{int(got[2]['traced_rays'])} rays traced, "
              f"{int(first[2]['exhausted_rays'])} and "
              f"{int(got[2]['exhausted_rays'])} exhausted", flush=True)
        del first
        del st, ref, u5, got

        # Count plain-version calls during the main path: there must be none.
        plain_calls = {"B1": 0, "B2": 0, "W0": 0, "W1": 0, "W2": 0, "W3": 0,
                       "W4": 0}

        def counting(mod, attr, key, calls=None):
            """Count calls of ``mod.attr`` in ``calls`` (by default the
            current phase's ``plain_calls``); returns what ``restore``
            puts back."""
            f = getattr(mod, attr)
            calls = plain_calls if calls is None else calls

            def wrapped(*a, **k):
                calls[key] += 1
                return f(*a, **k)
            setattr(mod, attr, wrapped)
            return mod, attr, f

        def count_wave_plain(calls):
            """Count the plain W0-W4 the wrappers would run: the saved
            (module, name, function) triples to put back."""
            return [counting(kwave, "compact_plain", "W0", calls),
                    counting(kwave, "primary_plain", "W1", calls),
                    counting(kwave, "gather_clip_plain", "W2", calls),
                    counting(kwave, "shade_plain", "W3", calls),
                    counting(kwave, "rescue_plain", "W4", calls)]

        def restore(saved):
            for mod, attr, f in saved:
                setattr(mod, attr, f)

        def w_launches():
            """W1, W2, W3, W0, W4 launches so far."""
            return [kwave.primary.launches, kwave.gather_clip.launches,
                    kwave.shade.launches, kwave.compact.launches,
                    kwave.rescue.launches]

        saved_plain = [counting(ktrav, "trace_rays", "B2"),
                       counting(ktrav, "trace_clipped_rays", "B2"),
                       counting(kbrick, "intersect_brick_plain", "B1")]
        saved_plain += count_wave_plain(plain_calls)
        waves = []        # per wave: (view, B2 launches, W launches)
        orig_wave = pathtrace.render_wave
        traces = nb + 2   # bounce traces and the final shadow trace

        def counted_wave(*a, **k):
            before = ktrav.trace.launches
            w_before = w_launches()
            for f in (ktrav.trace, kwave.primary, kwave.gather_clip,
                      kwave.shade, kwave.compact, kwave.rescue):
                f.events.clear()          # launches of this wave only
            out = orig_wave(*a, **k)
            launches = ktrav.trace.launches - before
            wl = [x - y for x, y in zip(w_launches(), w_before)]
            # Every trace launches W0 twice, W2, B2, W4 and W3 once, whether
            # or not a ray is live: the counts stay on the device.
            if launches != traces or wl != [1, traces, traces, 2 * traces,
                                            traces]:
                fail(f"a wave launched B2 {launches} times and W1, W2, W3, "
                     f"W0, W4 {wl} times, not {traces} and [1, {traces}, "
                     f"{traces}, {2 * traces}, {traces}]")
            waves.append((len(images), launches, wl))
            return out

        pathtrace.render_wave = counted_wave
        # View -> image statistics of its timed wave; while a view renders,
        # len(images) is its index.
        images = {}

        def on_wave(vi, rgb):
            t = timer.take()
            images[vi] = (float(rgb.mean()), float(rgb.std()),
                          bool(torch.isfinite(rgb).all()), t)

        def on_view(results):
            r = results[-1]
            m, s, finite, t = images[r["viewpoint"]]
            b2, calls = t["B2"]
            print(f"  view {r['viewpoint']}: {r['avg_ms']:.2f} ms, "
                  f"{r['rays']} rays traced, {r['mrays_per_s']:.3f} Mrays/s,"
                  f" exhausted {r['exhausted']}, B2 kernel {b2:.3f} ms in "
                  f"{calls} launches ({100 * b2 / r['avg_ms']:.1f}% of the "
                  f"wave), " + ", ".join(
                      f"{k} {v[0]:.3f} ms in {v[1]}" for k, v in t.items()
                      if k != "B2") + f"; image mean {m:.5f} std {s:.5f}, "
                  f"finite {finite}", flush=True)

        for f in (ktrav.trace, kbrick.trace_single_brick, kwave.primary,
                  kwave.gather_clip, kwave.shade, kwave.compact,
                  kwave.rescue):
            f.launches = 0
        cams = benchmark.benchmark_cameras()
        try:
            with benchmark.KernelTimes(
                    B2=ktrav.trace, W0=kwave.compact, W1=kwave.primary,
                    W2=kwave.gather_clip, W3=kwave.shade,
                    W4=kwave.rescue) as timer:
                out = benchmark.run_forward_benchmark(
                    world, cfg, waves_per_view=1, warmup_waves=1,
                    verbose=False, on_view=on_view, on_wave=on_wave)
        finally:
            pathtrace.render_wave = orig_wave
            restore(saved_plain)
        b2_launches = ktrav.trace.launches
        w5_launches = w_launches()

        per_wave = [n for _, n, _ in waves]
        print(f"  aggregate {out['mrays_per_s']:.3f} Mrays/s over "
              f"{out['total_rays']} rays in {out['total_seconds']:.3f} s on "
              f"{out['device']}; B2 launches {b2_launches}, per wave "
              f"{per_wave}; W1, W2, W3, W0, W4 launches {w5_launches}, "
              f"per wave "
              f"{[x for _, _, x in waves]}")
        if out["total_exhausted"] != 0:
            fail(f"{out['total_exhausted']} rays exhausted")
        if any(plain_calls.values()):
            fail(f"plain versions ran on the main path: {plain_calls}")
        for vi, (m, s, finite, _) in images.items():
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
            "launches": b2_launches, "max_abs_err": b2_err[0],
            "ms": b2q["view 0 primaries"][1], "plain_ms": b2_plain_ms,
            "bound_ms": b2_bound_ms, "bound_by": b2_by, "library_ms": None}
        # W0-W4 have no Pallas twin: "replaces" names the JAX function XLA
        # fuses; each at its first shape of view 0's wave.
        for kind, name, shape, replaces, launches in (
                ("W1", "primary (W1)", "view 0",
                 "brickmap_tpu/render/pathtrace.py:293", w5_launches[0]),
                ("W2", "gather_clip (W2)", "bounce 0",
                 "brickmap_tpu/ops/traverse.py:73", w5_launches[1]),
                ("W3", "shade (W3)", "bounce 0",
                 "brickmap_tpu/render/pathtrace.py:519", w5_launches[2])):
            ms, pms, bms, by = wrec[(kind, shape)]
            records[kind] = {
                "name": name, "route": "cuda",
                "source": "brickmap_tpu_torch/csrc/wave.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": w_err[0], "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None}
        # W0 at bounce 0's live mask (2N rows, N set): 1 B read a row, 4 B
        # written a set row; the library call is torch.nonzero.  "ms" is
        # compact_kernel's time with its launches queued behind a device
        # sleep (events around a call with the host not ahead time the
        # launch's submission instead).
        rows_, set_, ms, _, pms, nz_ms = w0rec["bounce 0"]
        bms, by = bound(rows_ + 4 * set_, 0)
        records["W0"] = {
            "name": "compact (W0)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/wave.cu",
            "replaces": "brickmap_tpu/render/pathtrace.py:59",
            "launches": w5_launches[3], "max_abs_err": float(w0_err[0]),
            "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": nz_ms}
        records["W4"] = {
            "name": "rescue (W4)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/wave.cu",
            "replaces": "brickmap_tpu/render/pathtrace.py:385",
            "launches": w5_launches[4], "max_abs_err": w4_err[0],
            "ms": w4_ms, "plain_ms": w4_plain_ms, "bound_ms": w4_bms,
            "bound_by": w4_by, "library_ms": None}

        # Whole waves through the kernels against the same waves with the
        # plain W0-W4 swapped in (B2 the kernel in both), on the same
        # uniforms: view 0, view 7 (every primary misses) and view 0 with
        # a starved trace budget (W4 rescues rays in every trace).
        import dataclasses

        starved = cfg.replace(render=dataclasses.replace(
            cfg.render, max_top_steps=STARVED_STEPS, max_brick_steps=0,
            max_byte_steps=0))
        names = ("compact", "primary", "gather_clip", "shade", "rescue")
        plains = (owave.compact_plain, owave.primary_plain,
                  owave.gather_clip_plain, owave.shade_plain,
                  owave.rescue_plain)
        w2_kernel = kwave.gather_clip

        def checked_w2(tag, counts):
            """W2 held bit for bit against its plain version at each trace
            of a wave (the B2 inputs below the count and the lanes' rows;
            NaN equal to NaN); ``counts`` gets each trace's count."""
            def gather_clip(rays_o, rays_d, lanes, count, grid, pos=None):
                pos_p = None if pos is None else pos.clone()
                want = owave.gather_clip_plain(rays_o, rays_d, lanes, count,
                                               grid, pos_p)
                got = w2_kernel(rays_o, rays_d, lanes, count, grid, pos)
                m = int(count)
                keys = ("clipped", "dirs", "entry_normal", "tminn", "ok")
                rows = keys if m else ()     # no row to compare at 0
                maps = ({}, {}) if pos is None else ({"pos": pos},
                                                      {"pos": pos_p})
                w_equal(f"W2 {tag} {len(counts)}", dict(
                    zip(rows, (a[:m] for a in got)), **maps[0]), dict(
                    zip(rows, (a[:m] for a in want)), **maps[1]))
                counts.append(m)
                return got
            # While it is swapped in, the kernel's wrapper counts its launch
            # and looks for its event hook here: these comparison launches
            # are not counted.
            gather_clip.events, gather_clip.launches = None, 0
            return gather_clip

        for vi, cfg_x, tag in ((0, cfg, "view 0"), (7, cfg, "view 7"),
                               (0, starved, "view 0, starved")):
            cam_x = cams[vi]
            arr_x = camera_arrays_for(cam_x, sun, w, h, dev)
            u = draw_wave_uniforms(w * h, nb, gen, dev)
            r0 = kwave.rescue.launches
            w2_checked = []
            kwave.gather_clip = checked_w2(f"{tag} trace", w2_checked)
            try:
                got = pathtrace.render_wave(world, arr_x,
                                            cam_x.brick_position, cfg_x, w,
                                            h, uniforms=u)
            finally:
                kwave.gather_clip = w2_kernel
            if len(w2_checked) != traces:
                fail(f"{tag}: W2 checked at {len(w2_checked)} traces, not "
                     f"{traces}")
            kernels = [getattr(kwave, k) for k in names]
            for k, f in zip(names, plains):
                setattr(kwave, k, f)
            try:
                want = pathtrace.render_wave(world, arr_x,
                                             cam_x.brick_position, cfg_x, w,
                                             h, uniforms=u)
            finally:
                for k, f in zip(names, kernels):
                    setattr(kwave, k, f)
            torch.cuda.synchronize()
            err = float((got[0] - want[0]).abs().max())
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
            same = {k: bool(torch.equal(got[2][k], want[2][k]))
                    for k in ("mask", "pos", "traced_rays", "exhausted_rays")}
            if not (torch.equal(got[1], want[1]) and all(same.values())
                    and int(got[2]["exhausted_rays"]) == 0
                    and kwave.rescue.launches - r0 == traces):
                fail(f"{tag}: the wave through W0-W4 differs from the plain "
                     f"one: count {torch.equal(got[1], want[1])}, {same}, "
                     f"exhausted {int(got[2]['exhausted_rays'])}")
            print(f"  {tag}: W2 equal to the plain version at the wave's "
                  f"{traces} traces ({w2_checked} rays)", flush=True)
            print(f"  {tag}: the wave through W0-W4 against the plain W0-W4 "
                  f"swapped in: rgb max |diff| {err} (equal: "
                  f"{torch.equal(got[0], want[0])}), count, mask, pos, "
                  f"{int(got[2]['traced_rays'])} traced and 0 exhausted "
                  f"equal", flush=True)
            del got, want, u

    # ------------------------------------------------------------------
    with phase("5b the wave as a CUDA graph: views 0-8 at 1920x1080, eager "
               "against graphed"):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from brickmap_tpu_torch.utils import profiling

        cams5b = benchmark.benchmark_cameras()
        arrays5b = [camera_arrays_for(c, sun, w, h, dev) for c in cams5b]
        nv = len(cams5b)

        def wave5b(v):
            """View v's wave from its own seed: (outputs, host ms)."""
            gen.manual_seed(5_000_000_000 + v)
            t = time.perf_counter()
            out = pathtrace.render_wave(world, arrays5b[v],
                                        cams5b[v].brick_position, cfg, w, h,
                                        generator=gen)
            ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            return out, ms

        def flat(out):
            return (out[0], out[1], *(out[2][k] for k in (
                "mask", "pos", "traced_rays", "exhausted_rays")))

        # The eager waves (B2's event hook keeps a wave eager), kept on the
        # host; the peak allocation of each pass over what it started with.
        torch.cuda.synchronize()
        base5b = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ktrav.trace.events = []
        try:
            want, eager_ms = [], []
            for v in range(nv):
                out, ms = wave5b(v)
                want.append([t.cpu() for t in flat(out)])
                eager_ms.append(ms)
        finally:
            ktrav.trace.events = None
        del out
        peak_eager = torch.cuda.max_memory_allocated() - base5b
        # The same waves through the graphs, on a stream (and so a table)
        # of their own: each view's first two waves eager, its third
        # captured, its fourth replayed; then a second cycle, in which view
        # 0 (the least recently used of 9 views over 8 graphs) runs eagerly
        # and views 1-8 replay.
        way_names = (wave_graph.EAGER, wave_graph.CAPTURE, wave_graph.REPLAY)
        ways0 = [wave_graph.calls[k] for k in way_names]
        torch.cuda.reset_peak_memory_stats()
        s5b = torch.cuda.Stream()
        replay_ms, differ = [], []
        with torch.cuda.stream(s5b):
            for cycle, calls in ((0, 4), (1, 1)):
                for v in range(nv):
                    for c in range(calls):
                        out, ms = wave5b(v)
                        if (cycle, c) == (0, 3) or (cycle, v) > (1, 0):
                            replay_ms.append(ms)
                        if not all(torch.equal(a.cpu(), b) for a, b in
                                   zip(flat(out), want[v])):
                            differ.append((cycle, v, c))
            peak_graph = torch.cuda.max_memory_allocated() - base5b
            ways = tuple(wave_graph.calls[k] - b
                         for k, b in zip(way_names, ways0))
            # One replay under the profiler: one graph launch, no copy to
            # the host and no stream synchronise.
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof5b:
                out, _ = wave5b(nv - 1)
        kept5b = profiling.take_counts()
        kinds5b = {"kernel": 0, "DtoH": 0, "DtoD": 0, "other copy": 0,
                   "span": 0}
        calls5b = {}
        for e in prof5b.events():
            if e.device_type == DeviceType.CUDA:
                # "span": the program's spans drawn on the device's track.
                k = ("span" if e.name.startswith("bm.")
                     else "kernel" if not e.name.startswith(("Memcpy",
                                                             "Memset"))
                     else "DtoH" if "DtoH" in e.name
                     else "DtoD" if "DtoD" in e.name else "other copy")
                kinds5b[k] += 1
            elif e.name in ("cudaGraphLaunch", "cudaLaunchKernel",
                            "cudaStreamSynchronize", "cudaDeviceSynchronize",
                            "cudaMemcpyAsync"):
                calls5b[e.name] = calls5b.get(e.name, 0) + 1
        print(f"  9 views x 4 waves, then a cycle of 1: eager, captures, "
              f"replays {ways}; every wave equal to the eager wave bit for "
              f"bit: {not differ} {differ[:6]}; host ms a call (median) "
              f"eager {statistics.median(eager_ms):.3f}, replay "
              f"{statistics.median(replay_ms):.3f}; peak allocation over "
              f"the pass's start: eager {peak_eager} B, graphed "
              f"{peak_graph} B (+{peak_graph - peak_eager} B), "
              f"{torch.cuda.max_memory_allocated()} B in all", flush=True)
        print(f"  one profiled replay (view {nv - 1}): device kernels "
              f"{kinds5b['kernel']}, copies device-to-host "
              f"{kinds5b['DtoH']}, device-to-device {kinds5b['DtoD']}, "
              f"other {kinds5b['other copy']}, span images "
              f"{kinds5b['span']}; host calls {calls5b}; kept "
              f"wave.graph_replays {kept5b.get('wave.graph_replays')}, "
              f"wave.trace_rays {kept5b.get('wave.trace_rays')}", flush=True)
        if differ:
            fail(f"graphed waves differ from the eager ones: {differ}")
        if ways != (2 * nv + 1, nv, 2 * nv - 1):
            fail(f"eager, captures, replays {ways}, not "
                 f"{(2 * nv + 1, nv, 2 * nv - 1)}")
        # The five draws, then the graph: W1, and a W3 and five kernels
        # (W0, W2, B2, W0, W4) a trace.
        if kinds5b["DtoH"] or calls5b.get("cudaStreamSynchronize") \
                or calls5b.get("cudaGraphLaunch") != 1 \
                or kinds5b["kernel"] != 6 + 6 * traces \
                or kept5b.get("wave.graph_replays") != [1] \
                or len(kept5b.get("wave.trace_rays", [])) != traces:
            fail(f"the profiled replay: {kinds5b}, {calls5b}, {kept5b}")
        del want, out, prof5b, arrays5b

    # ------------------------------------------------------------------
    from brickmap_tpu_torch.diff import optim as doptim, sparse as dsparse
    from brickmap_tpu_torch.diff.field4 import field4_of
    from brickmap_tpu_torch.kernels import adam as kadam
    from brickmap_tpu_torch.kernels import extract as kext, record as krec
    from brickmap_tpu_torch.kernels import replay as krep
    from brickmap_tpu_torch.ops.adam import adam_update_plain, step_scalars
    from brickmap_tpu_torch.ops.extract import extract_bwd_plain, \
        extract_fwd_plain, field_index
    from brickmap_tpu_torch.ops.record import record_segments_plain
    from brickmap_tpu_torch.ops.replay import composite_sse_plain, \
        segment_geom_plain

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
        occ6.mul_(0.8)
        alb6.mul_(torch.rand(alb6.shape, generator=gen, device=dev))
        field6 = field4_of(occ6, alb6)
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
        plain_calls = {"B3": 0, "R1": 0, "B4f": 0, "R2": 0, "B4b": 0,
                       "A1": 0}
        saved = [counting(krec, "record_segments_plain", "B3"),
                 counting(krep, "segment_geom_plain", "R1"),
                 counting(kext, "extract_fwd_plain", "B4f"),
                 counting(krep, "composite_sse_plain", "R2"),
                 counting(kext, "extract_bwd_plain", "B4b"),
                 counting(kadam, "adam_update_plain", "A1")]
        train_kernels = {"B3": krec.record_segments,
                         "R1": krep.segment_geom, "B4f": kext.extract_fwd,
                         "R2": krep.composite_sse, "B4b": kext.extract_bwd}
        for f in (*train_kernels.values(), kadam.adam_update):
            f.launches = 0
        out7 = benchmark.run_sparse_inverse_benchmark(world, cfg.grid)
        launches = {k: f.launches for k, f in train_kernels.items()}
        launches["A1"] = kadam.adam_update.launches
        restore(saved)
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
        if launches["A1"] != benchmark.SPARSE_ADAM_STEPS:
            fail(f"A1 launched {launches['A1']} times in "
                 f"{benchmark.SPARSE_ADAM_STEPS} Adam steps, not once a "
                 f"step over the fields' one storage")
        if any(plain_calls.values()):
            fail(f"plain versions ran on the training path: {plain_calls}")
        # A replay slice is R1 -> B4f -> R2 -> B4b: each of the four
        # launches once a slice of 16,384 live rays, in every step.
        per_step = -(-out7["live_rays"] // 16384)
        step_counts = {st: {k: per[k][1] for k in ("R1", "B4f", "R2",
                                                   "B4b")}
                       for st, per in out7["kernels"].items()
                       if st in ("warm-up", "uncached", "cache fill",
                                 "cached")}
        print(f"  replay launches a step ({per_step} slices): {step_counts}")
        if any(set(c.values()) != {per_step} for c in step_counts.values()):
            fail(f"a step did not launch R1, B4f, R2 and B4b once a slice "
                 f"({per_step}): {step_counts}")
        if out7["exhausted"]:
            fail(f"{out7['exhausted']} rays exhausted the record budget")
        losses = out7["losses"]
        if not (all(math.isfinite(v) for v in losses)
                and math.isfinite(out7["loss"]) and losses[-1] < losses[0]):
            fail(f"loss not finite and falling: {losses}")
        if not (out7["grads_finite"] and out7["grads_nonzero"]):
            fail("gradients not finite, or all zero")

        # The whole step against the plain versions on the same inputs (the
        # fields after the Adam steps): one uncached step through B3, R1,
        # B4f, R2 and B4b, one with their plain versions swapped in.  B4b's
        # atomics and the plain version's index_add_ sum in run-dependent
        # orders on the card, so gradients agree to 1e-6 of their largest
        # value; the loss (each ray's SSE from R2, summed by one torch.sum)
        # takes no atomics and must be equal.
        o7, d7 = frame["origins"], frame["dirs"]
        kernel_fns = (dsparse.record_segments, dsparse.segment_geom,
                      dsparse.extract_fwd, dsparse.composite_sse,
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
        dsparse.segment_geom = segment_geom_plain
        dsparse.extract_fwd = extract_fwd_plain
        dsparse.composite_sse = composite_sse_plain
        dsparse.extract_bwd = extract_bwd_plain
        try:
            loss_p, (go_p, ga_p), step_p_s, n_p = full_step()
        finally:
            dsparse.record_segments, dsparse.segment_geom, \
                dsparse.extract_fwd, dsparse.composite_sse, \
                dsparse.extract_bwd = kernel_fns
        grad_errs = [(float((gk - gp).abs().max()), float(gp.abs().max()))
                     for gk, gp in ((go_k, go_p), (ga_k, ga_p))]
        print(f"  whole uncached step, kernels {step_k_s:.3f} s (launches "
              f"B3/R1/B4f/R2/B4b {n_k}) against the plain versions "
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

        # The fields as the program makes them (views of one field4)
        # against contiguous copies of them, as fields from outside the
        # program: one cached step on each (the first replays from the
        # storage, the second from a cat; both scale their dfield in place
        # and return its views), each step's peak allocation over what was
        # allocated before it; then one Adam step on each from zero
        # moments, both with the interleaved step's gradients: A1 over the
        # field4 in one launch against A1 a field, equal bit for bit.
        occ_i, alb_i = frame["occupancy"], frame["albedo"]
        if field4_of(occ_i, alb_i) is None:
            fail("the benchmark's fields are not views of one field4")
        occ_c, alb_c = occ_i.contiguous(), alb_i.contiguous()

        def cached_step(occ, alb):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, grads = dsparse.l2_loss_and_grads_sparse(
                o7, d7, world, frame["cellmap"], occ, alb,
                frame["background"], frame["target"], cfg.grid,
                k_segments=K, seg_cache=frame["seg_cache"])
            torch.cuda.synchronize()
            return (float(loss), grads, before,
                    torch.cuda.max_memory_allocated())

        # Whether each _pack_field call returned the fields' own storage.
        pack_field, packed = dsparse._pack_field, []

        def pack_recorded(occ, alb):
            field = pack_field(occ, alb)
            packed.append(field.data_ptr() == occ.data_ptr())
            return field

        dsparse._pack_field = pack_recorded
        try:
            loss_i, g_i, before_i, peak_i = cached_step(occ_i, alb_i)
            loss_c, g_c, before_c, peak_c = cached_step(occ_c, alb_c)
        finally:
            dsparse._pack_field = pack_field
        g_errs = [(float((a - b).abs().max()), float(b.abs().max()))
                  for a, b in zip(g_i, g_c)]
        g_views = [field4_of(*g) is not None for g in (g_i, g_c)]
        del g_c
        lr_a = benchmark.SPARSE_LR
        opt_i = doptim.make_adam((occ_i, alb_i), lr_a)
        opt_c = doptim.make_adam((occ_c, alb_c), lr_a)
        n0 = kadam.adam_update.launches
        doptim.adam_step(opt_i, (occ_i, alb_i), g_i)
        n_i = kadam.adam_update.launches - n0
        g_ic = tuple(g.contiguous() for g in g_i)
        del g_i
        n0 = kadam.adam_update.launches
        doptim.adam_step(opt_c, (occ_c, alb_c), g_ic)
        n_c = kadam.adam_update.launches - n0
        del g_ic
        torch.cuda.synchronize()
        a1_same = [torch.equal(p, q) and all(
            torch.equal(opt_i.state[p][k], opt_c.state[q][k])
            for k in ("exp_avg", "exp_avg_sq"))
            for p, q in ((occ_i, occ_c), (alb_i, alb_c))]
        print(f"  interleaved fields against contiguous copies, cached "
              f"step: loss {loss_i!r} vs {loss_c!r}; max |dgrad| (max "
              f"|grad|) {g_errs}; gradients views of one dfield: "
              f"{g_views}; _pack_field returned the storage: {packed}; peak "
              f"allocated {peak_i} over {before_i} before it (+"
              f"{peak_i - before_i}) vs contiguous {peak_c} over "
              f"{before_c} (+{peak_c - before_c}) bytes; Adam step: A1 "
              f"launches {n_i} vs {n_c}, p, m and v equal bit for bit "
              f"(occupancy, albedo): {a1_same}", flush=True)
        del opt_i, opt_c, occ_c, alb_c, occ_i, alb_i
        torch.cuda.empty_cache()
        if loss_i != loss_c or any(e > 1e-6 * m for e, m in g_errs) \
                or not all(g_views) or packed != [True, False]:
            fail(f"the step on the interleaved fields differs from the "
                 f"step on contiguous copies: loss {loss_i!r} vs "
                 f"{loss_c!r}, gradients {g_errs}, views {g_views}, "
                 f"_pack_field returned the storage {packed}")
        if (n_i, n_c) != (1, 2) or not all(a1_same):
            fail(f"A1 on the fields' storage ({n_i} launches) against A1 "
                 f"a field ({n_c}): equal {a1_same}")

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

        # R1, B4f, R2 and B4b on the first slice of the replay: the first
        # 16,384 count-sorted live rays of the timed steps' seg_cache at
        # K = 8 (131,072 rows).
        c7 = 16384
        geo7, live7 = frame["seg_cache"]["geo"], frame["seg_cache"]["n_live"]
        sl_in = tuple(a[:c7] for a in geo7)
        cellmap_a = frame["cellmap"]
        field4 = dsparse._pack_field(frame["occupancy"], frame["albedo"])
        del frame, o7, d7
        geom_in = (*sl_in[:6], cellmap_a, cfg.grid)
        bg7, tgt7 = sl_in[6], sl_in[7]
        flat, lin2 = krep.segment_geom(*geom_in)
        want_geom = segment_geom_plain(*geom_in)
        torch.cuda.synchronize()
        check_equal("R1 replay slice", {"slots": flat, "lin2": lin2},
                    dict(zip(("slots", "lin2"), want_geom)))
        # The replay's slices at K = 2 and 4 are column cuts of the [N, 8]
        # record (row stride 8): R1 reads them in place.
        for kc in (2, 4):
            cut = (*sl_in[:2], *(a[:, :kc] for a in sl_in[2:5]), sl_in[5],
                   cellmap_a, cfg.grid)
            check_equal(f"R1 replay slice, K = {kc} columns",
                        dict(zip(("slots", "lin2"), krep.segment_geom(*cut))),
                        dict(zip(("slots", "lin2"), segment_geom_plain(*cut))))
        r1_err = float((lin2 - want_geom[1]).abs().max())
        print(f"  R1 at {c7} rays x K = {K} ({lin2.shape[0]} segments, "
              f"{int((lin2 >= 0).sum())} valid steps; K = 2 and 4 column "
              f"cuts too): slots and visited voxels equal", flush=True)
        del want_geom
        vals = kext.extract_fwd(field4, flat, lin2)
        x7 = vals[:, :nvox][lin2 >= 0]
        sse_k, dv_k = krep.composite_sse(vals, lin2, bg7, tgt7)
        sse_p, dv_p = composite_sse_plain(vals, lin2, bg7, tgt7)
        torch.cuda.synchronize()
        check_equal("R2 replay slice", {"sse": sse_k, "dvals": dv_k},
                    {"sse": sse_p, "dvals": dv_p})
        r2_err = max(float((sse_k - sse_p).abs().max()),
                     float((dv_k - dv_p).abs().max()))
        print(f"  R2 at {c7} rays x {K * nvox} steps (occupancies at 0: "
              f"{int((x7 == 0).sum())}, at 1: {int((x7 == 1).sum())}, in "
              f"between: {int(((x7 > 0) & (x7 < 1)).sum())}): SSE and "
              f"cotangents equal", flush=True)
        # R2 on the slice's steps with occupancies drawn at 0, 1, outside
        # [0, 1] and inside, and albedos outside [0, 1].
        vals_r = torch.rand(vals.shape, generator=gen, device=dev) * 0.4
        pick = torch.randint(0, 16, (vals.shape[0], nvox), generator=gen,
                             device=dev)
        occ_r = vals_r[:, :nvox]
        for code, value in ((0, 0.0), (1, 1.0), (2, -0.25), (3, 1.25)):
            occ_r[pick == code] = value
        vals_r[:, nvox:] = vals_r[:, nvox:] * 3.5 - 0.2
        check_equal("R2 random values on the slice's steps",
                    dict(zip(("sse", "dvals"),
                             krep.composite_sse(vals_r, lin2, bg7, tgt7))),
                    dict(zip(("sse", "dvals"),
                             composite_sse_plain(vals_r, lin2, bg7, tgt7))))
        print("  R2 on random values at the slice's steps (0, 1, outside "
              "[0, 1]): equal", flush=True)
        # R1 and R2 on their launches' edges, over the step's count-sorted
        # live rays at K = 8: 1, 31 and 33 rays, the rays of the R2 warps
        # and of the R1 threads resident at once on the card, one less and
        # one more, and the step's last, partial slice.
        shape7 = krep.launch_shape(K)
        print(f"  R1/R2 launches at K = {K} (threads a block, dynamic shared "
              f"bytes, blocks resident an SM): {shape7}")
        r2_res = shape7["R2"][0] * shape7["R2"][2] * sms
        r1_res = shape7["R1"][0] * shape7["R1"][2] * sms // K
        last7 = (live7 - 1) // c7 * c7
        edges = [(0, n) for n in (1, 31, 33, r2_res - 1, r2_res + 1,
                                  r1_res - 1, r1_res + 1)] + [(last7, live7)]
        for lo7, hi7 in edges:
            sl = [g[lo7:hi7] for g in geo7]
            gin = (*sl[:6], cellmap_a, cfg.grid)
            want_g = segment_geom_plain(*gin)
            check_equal(f"R1 at rays [{lo7}, {hi7})",
                        dict(zip(("slots", "lin2"), krep.segment_geom(*gin))),
                        dict(zip(("slots", "lin2"), want_g)))
            v = kext.extract_fwd(field4, *want_g)
            check_equal(f"R2 at rays [{lo7}, {hi7})",
                        dict(zip(("sse", "dvals"), krep.composite_sse(
                            v, want_g[1], sl[6], sl[7]))),
                        dict(zip(("sse", "dvals"), composite_sse_plain(
                            v, want_g[1], sl[6], sl[7]))))
        print(f"  R1 and R2 at {[hi - lo for lo, hi in edges]} rays (the last "
              f"the step's last slice, rays {last7} to {live7}): equal",
              flush=True)
        del sl, gin, want_g, v
        # R1 where crossing counts saturate their int32 conversion: the
        # first slice's segments, on rays with one direction component of
        # magnitude 1e-12 to 1e-7 and entry distances up to 2,000 cells.
        # The kernel takes merge_offsets' binary search on such axes (the
        # ranks wrap there); a build with the sweep on every axis must
        # differ from the plain version, so the search was reached.
        sat = [g[:c7] for g in geo7[:6]]
        d_sat = sat[1].double()
        ax = torch.randint(0, 3, (c7, 1), generator=gen, device=dev)
        tiny = (10.0 ** (torch.rand((c7, 1), generator=gen, device=dev,
                                    dtype=torch.float64) * 5 - 12)
                * (torch.randint(0, 2, (c7, 1), generator=gen, device=dev)
                   * 2 - 1))
        d_sat.scatter_(1, ax, tiny)
        sat[1] = (d_sat / d_sat.norm(dim=1, keepdim=True)).float()
        sat[3] = torch.rand(sat[3].shape, generator=gen, device=dev) * 2000
        gin = (*sat, cellmap_a, cfg.grid)
        want_g = segment_geom_plain(*gin)
        check_equal("R1 on saturating segments",
                    dict(zip(("slots", "lin2"), krep.segment_geom(*gin))),
                    dict(zip(("slots", "lin2"), want_g)))
        sweep_lib = ctypes.CDLL(sweep_so)
        krep._bind(sweep_lib)
        swept = (torch.empty_like(want_g[0]), torch.empty_like(want_g[1]))
        sargs, skeep = krep.segment_geom_args(
            *gin, swept, torch.cuda.current_stream(dev).cuda_stream)
        build.check(sweep_lib.replay_geom_launch(*sargs),
                    "segment_geom_kernel (BM_R1_MERGE=2)")
        torch.cuda.synchronize()
        n_swept = int((swept[1] != want_g[1]).any(1).sum())
        print(f"  R1 on {c7 * K} saturating segments "
              f"({int((want_g[1] >= 0).sum())} valid steps): equal; the "
              f"sweep-only build differs on {n_swept} rows", flush=True)
        if n_swept == 0:
            fail("R1's saturating segments do not reach the binary search: "
                 "the sweep-only build equals the plain version there")
        del geo7, sat, d_sat, ax, tiny, gin, want_g, swept, sargs, skeep
        # R2 on views of the slice's values and visited voxels 4 bytes off
        # their rows' alignment: the wrapper refuses them (the kernel copies
        # them in 16- and 8-byte pieces).
        for i, arg in enumerate(("vals", "lin2")):
            ins = [vals, lin2]
            ins[i] = torch.empty(ins[i].numel() + 1, dtype=ins[i].dtype,
                                 device=dev)[1:].view(ins[i].shape)
            ins[i].copy_((vals, lin2)[i])
            try:
                krep.composite_sse(*ins, bg7, tgt7)
            except ValueError as e:
                print(f"  R2 on an unaligned view of {arg}: refused ({e})")
            else:
                fail(f"R2 took an unaligned view of {arg}")
            del ins
        del sse_p, dv_p, vals_r, pick, occ_r, x7

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
        # R1 and R2 alike; no single PyTorch call computes either.
        r1_ms, r2_ms, r1_plain_ms, r2_plain_ms = (
            cuda_ms(fn, reps, flush) for fn, reps in (
                (lambda: krep.segment_geom(*geom_in), 10),
                (lambda: krep.composite_sse(vals, lin2, bg7, tgt7), 10),
                (lambda: segment_geom_plain(*geom_in), 3),
                (lambda: composite_sse_plain(vals, lin2, bg7, tgt7), 2)))
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
        # R1: per ray its origin, direction and entry normal (36 B), per
        # segment its cell, nd and ncode (12 B) and the cellmap word of each
        # distinct cell once (4 B), the slot and nvox voxel ids written
        # (4 + 4 nvox B); R1_OPS per valid segment and R1_RANK_OPS per rank
        # of each axis its ray moves along.  R2: the values read and their
        # cotangents written (2 x 16 B a step), lin2 read (4 B a step),
        # background and target read (24 B a ray), the SSE written (4 B);
        # R2_STEP_OPS a valid step.
        cells7 = sl_in[2]
        seg_ok = cells7 >= 0
        cmap_words = int(torch.unique(cells7[seg_ok]).shape[0])
        moving = int((seg_ok * (sl_in[1] != 0).sum(1, keepdim=True)).sum())
        r1_bound, r1_by = bound(
            36 * c7 + 12 * cs + 4 * cmap_words + (4 + 4 * nvox) * cs,
            R1_OPS * int(seg_ok.sum()) + R1_RANK_OPS * (nvox - 1) * moving)
        r2_bound, r2_by = bound(36 * entries + 28 * c7,
                                R2_STEP_OPS * int((lin2 >= 0).sum()))
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
        print(f"  R1 at {cs} segments, L2 cold: {r1_ms:.4f} ms per launch "
              f"(plain {r1_plain_ms:.3f} ms, bound {r1_bound:.4f} ms by "
              f"{r1_by}, {100 * r1_bound / r1_ms:.1f}% of it; "
              f"{cmap_words} cellmap words, ptxas {ptxas_line('replay')})")
        print(f"  R2 at {c7} rays x {K * nvox} steps, L2 cold: {r2_ms:.4f} "
              f"ms per launch (plain {r2_plain_ms:.3f} ms, bound "
              f"{r2_bound:.4f} ms by {r2_by}, "
              f"{100 * r2_bound / r2_ms:.1f}% of it)", flush=True)
        del gidx, valid, gidx_valid, dv_valid, per_voxel, cells7, seg_ok

        # Where one slice's time goes: host clock around synchronised work,
        # each of the four launches alone and the whole slice
        # (_row_chunk_grad).  The device's busy and idle shares come from
        # one profiled call of the slice: the union of its device activities
        # against the host time of that same call, and against the span from
        # its first device activity to its last.
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

        def one_slice():
            dsparse._row_chunk_grad(*sl_in[:6], cellmap_a, dfield, field4,
                                    bg7, tgt7, cfg.grid)

        parts = {
            "R1": host_ms(lambda: krep.segment_geom(*geom_in)),
            "B4f": host_ms(lambda: kext.extract_fwd(field4, flat, lin2)),
            "R2": host_ms(lambda: krep.composite_sse(vals, lin2, bg7, tgt7)),
            "B4b": host_ms(lambda: kext.extract_bwd(dfield, flat, lin2, dv)),
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
        slice_kernels = [e.name for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not e.name.startswith(("Memcpy", "Memset"))]
        print(f"  one profiled call of the slice: {traced_ms:.3f} ms host, "
              f"{n_act} device activities ({len(slice_kernels)} kernel "
              f"launches: {', '.join(sorted(set(slice_kernels)))}) over "
              f"{span_ms:.3f} ms from first to last, {busy_ms:.3f} ms busy "
              f"-> device idle {1 - busy_ms / traced_ms:.3f} of the call, "
              f"{1 - busy_ms / span_ms:.3f} of its device span; top by "
              f"device time:")
        evs = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        for e in sorted(evs, key=dev_us, reverse=True)[:8]:
            print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key[:90]}")
        # A slice is R1 -> B4f -> R2 -> B4b: no eager geometry, cumprod or
        # addcmul loop, and neither of torch's index_select or index_add_
        # kernels (the row gather and the row index_add_ live in B4f/B4b).
        if len(slice_kernels) > 6:
            fail(f"the slice made {len(slice_kernels)} kernel launches: "
                 f"{slice_kernels}")
        eager = [k for k in slice_kernels if any(
            w in k.lower() for w in ("cumprod", "addcmul", "indexselect",
                                     "indexfunc"))]
        if eager:
            fail(f"the slice still runs eager replay kernels: {eager}")
        del dfield, field4, cellmap_a, sl_in, flat, lin2, dv, vals
        del sse_k, dv_k

        # A1, the Adam update with its clip, against its plain version on
        # the card, bit for bit (a NaN as a NaN), over steps 1 to 3: an
        # occupancy-like field of 2^26 + 3 elements and an albedo-like one
        # of 3 * 2^26 + 1 (16-byte words, scalar tails), with gradients at
        # 0, NaN and large enough to cross 0 or 1, parameters at 0 and 1.
        def a1_grad(n):
            g = torch.randn(n, generator=gen, device=dev) * 0.1
            pick = torch.randint(0, 8, (n,), generator=gen, device=dev)
            g[pick == 2] = 0.0
            g[pick == 3] = 50.0
            g[pick == 4] = -50.0
            g[::9973] = float("nan")
            return g

        def a1_leaf(n):
            p = torch.rand(n, generator=gen, device=dev)
            pick = torch.randint(0, 8, (n,), generator=gen, device=dev)
            p[pick == 0] = 0.0
            p[pick == 1] = 1.0
            return [p, a1_grad(n),
                    torch.randn(n, generator=gen, device=dev) * 0.01,
                    torch.rand(n, generator=gen, device=dev) * 1e-3]

        def a1_diff(a, b):
            """Whether ``a`` equals ``b`` bit for bit (a NaN as a NaN), and
            the largest |a - b| over the elements neither holds as NaN."""
            na, nb = torch.isnan(a), torch.isnan(b)
            same = torch.equal(na, nb) and torch.equal(
                torch.where(nb, 0.0, a).view(torch.int32),
                torch.where(nb, 0.0, b).view(torch.int32))
            return same, float(torch.where(na | nb, 0.0,
                                           (a - b).abs()).max())

        def a1_plain(leaves, step):
            for p, g, m, v in leaves:
                adam_update_plain(p, g, m, v, *betas7, eps7,
                                  *step_scalars(lr7, *betas7, step))

        lr7, betas7, eps7 = benchmark.SPARSE_LR, (0.9, 0.999), 1e-8
        a1_n = ((1 << 26) + 3, 3 * (1 << 26) + 1)
        a1_k = [a1_leaf(n) for n in a1_n]
        a1_p = [[t.clone() for t in lf] for lf in a1_k]
        for step in (1, 2, 3):
            for lk, lp in zip(a1_k, a1_p):
                lk[1] = lp[1] = a1_grad(lk[0].shape[0])
            for lf in a1_k:
                kadam.adam_update(*lf, step, lr7, betas7, eps7)
            a1_plain(a1_p, step)
            for i, (lk, lp) in enumerate(zip(a1_k, a1_p)):
                for name, x, y in zip("pmv", lk[:1] + lk[2:],
                                      lp[:1] + lp[2:]):
                    same, err = a1_diff(x, y)
                    if not same:
                        fail(f"A1 step {step}, field {i} ({a1_n[i]} "
                             f"elements): {name} differs from the plain "
                             f"version by up to {err}")
        a1_nan = int(torch.isnan(a1_k[0][0]).sum())
        a1_edges = [int((a1_k[0][0] == x).sum()) for x in (0.0, 1.0)]
        print(f"  A1 at {list(a1_n)} elements, steps 1-3: p, m and v equal "
              f"to the plain version bit for bit (occupancy field after "
              f"step 3: {a1_nan} NaN, {a1_edges[0]} at 0, {a1_edges[1]} at "
              f"1); ptxas {ptxas_line('adam')}", flush=True)
        del a1_k, a1_p

        # A1 at the benchmark's field sizes (the active bricks' occupancy
        # and albedo; the albedo's 4.5 GB pass 2^32 bytes): alone, by events
        # around each launch of adam_step, against its bound (28 bytes an
        # element: p, g, m, v read, p, m, v written); one profiled
        # adam_step, whose only kernel must be A1; then one more step held
        # bit for bit against the plain version on copies of the fields and
        # moments taken before it (in slices of 2^26 elements: the update
        # is per element), the plain version timed over the same elements;
        # beside one torch.optim.Adam (foreach) step + clamp_ on the same
        # tensors, the update A1 replaced.
        n_occ = out7["active_bricks"] * 512
        occ_f = torch.rand(n_occ, generator=gen, device=dev)
        alb_f = torch.rand(3 * n_occ, generator=gen, device=dev)
        grads_f = (torch.randn(n_occ, generator=gen, device=dev) * 1e-3,
                   torch.randn(3 * n_occ, generator=gen, device=dev) * 1e-3)
        for p, g in zip((occ_f, alb_f), grads_f):
            # The last elements, past 2^32 bytes in the albedo: parameters
            # on the clip's bounds pushed outwards, others pushed across
            # them, a zero gradient, a NaN.
            p[-6:-4] = torch.tensor([0.0, 1.0], device=dev)
            g[-6:] = torch.tensor([50.0, -50.0, 50.0, -50.0, 0.0,
                                   float("nan")], device=dev)
        params_f = (occ_f, alb_f)
        opt_f = doptim.make_adam(params_f, lr7)
        doptim.adam_step(opt_f, params_f, grads_f)
        torch.cuda.synchronize()
        kadam.adam_update.events = []
        for _ in range(5):
            doptim.adam_step(opt_f, params_f, grads_f)
        torch.cuda.synchronize()
        a1_ms = sum(a.elapsed_time(b)
                    for a, b in kadam.adam_update.events) / 5
        kadam.adam_update.events = None
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            doptim.adam_step(opt_f, params_f, grads_f)
            torch.cuda.synchronize()
        a1_acts = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        a1_names = sorted({e.name for e in a1_acts})
        a1_prof_ms = sum(e.time_range.end - e.time_range.start
                         for e in a1_acts) / 1e3
        a1_before = [(p.clone(), opt_f.state[p]["exp_avg"].clone(),
                      opt_f.state[p]["exp_avg_sq"].clone())
                     for p in params_f]
        a1_step = int(opt_f.state[occ_f]["step"]) + 1
        doptim.adam_step(opt_f, params_f, grads_f)
        torch.cuda.synchronize()
        a1_err, a1_plain_ms, a1_slice = 0.0, 0.0, 1 << 26
        for i, (p, (p0, m0, v0), g) in enumerate(zip(params_f, a1_before,
                                                      grads_f)):
            got = (p, opt_f.state[p]["exp_avg"], opt_f.state[p]["exp_avg_sq"])
            for lo in range(0, p.numel(), a1_slice):
                hi = min(lo + a1_slice, p.numel())
                t1 = time.perf_counter()
                a1_plain([(p0[lo:hi], g[lo:hi], m0[lo:hi], v0[lo:hi])],
                         a1_step)
                torch.cuda.synchronize()
                a1_plain_ms += (time.perf_counter() - t1) * 1e3
                for name, x, y in zip("pmv", got, (p0, m0, v0)):
                    same, err = a1_diff(x[lo:hi], y[lo:hi])
                    a1_err = max(a1_err, err)
                    if not same:
                        fail(f"A1 at the benchmark's fields, step {a1_step}"
                             f", field {i}, elements {lo}-{hi}: {name} "
                             f"differs from the plain version by up to "
                             f"{err}")
            if not (bool(torch.isnan(p[-1])) and float(p[-5]) == 1.0
                    and float(p[-6]) == 0.0):
                fail(f"A1 at the benchmark's fields, field {i}: the last "
                     f"elements lost their NaN or bounds: "
                     f"{p[-6:].tolist()}")
        del a1_before, got, p0, m0, v0
        del opt_f
        torch.cuda.empty_cache()
        lib_opt = torch.optim.Adam(list(params_f), lr=lr7, betas=betas7,
                                   eps=eps7)

        def lib_step():
            for p, g in zip(params_f, grads_f):
                p.grad = g
            lib_opt.step()
            for p in params_f:
                p.clamp_(0.0, 1.0)

        a1_lib_ms = cuda_ms(lib_step, 3)
        del lib_opt, occ_f, alb_f, grads_f, params_f, p, g
        torch.cuda.empty_cache()
        a1_elems = 4 * n_occ
        a1_bound, a1_by = bound(28 * a1_elems, 0)
        print(f"  A1 at the benchmark's fields ({n_occ} + {3 * n_occ} = "
              f"{a1_elems} elements): step {a1_step} equal to the plain "
              f"version bit for bit (max |err| {a1_err}; plain "
              f"{a1_plain_ms:.4f} ms over the same elements in slices of "
              f"2^26); {a1_ms:.4f} ms alone (profiled {a1_prof_ms:.4f} ms; "
              f"kernels of one adam_step: {a1_names}), bound "
              f"{a1_bound:.4f} ms by {a1_by}, "
              f"{100 * a1_bound / a1_ms:.1f}% of it; torch.optim.Adam "
              f"(foreach) step + clamp_ {a1_lib_ms:.4f} ms", flush=True)
        if len(a1_names) != 1 or "adam_kernel" not in a1_names[0]:
            fail(f"adam_step on the card ran {a1_names}, not A1 alone")

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
        # R1 and R2 have no Pallas twin: "replaces" names the JAX function
        # XLA fuses.
        records["R1"] = {
            "name": "segment geometry (R1)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/replay.cu",
            "replaces": "brickmap_tpu/diff/sparse.py:141",
            "launches": launches["R1"], "max_abs_err": r1_err, "ms": r1_ms,
            "plain_ms": r1_plain_ms, "bound_ms": r1_bound,
            "bound_by": r1_by, "library_ms": None}
        records["R2"] = {
            "name": "composite forward + backward (R2)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/replay.cu",
            "replaces": "brickmap_tpu/diff/sparse.py:293",
            "launches": launches["R2"], "max_abs_err": r2_err, "ms": r2_ms,
            "plain_ms": r2_plain_ms, "bound_ms": r2_bound,
            "bound_by": r2_by, "library_ms": None}
        records["A1"] = {
            "name": "Adam + clip (A1)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/adam.cu",
            "replaces": "brickmap_tpu/diff/optim.py (optax.adam + clip)",
            "launches": launches["A1"], "max_abs_err": a1_err, "ms": a1_ms,
            "plain_ms": a1_plain_ms, "bound_ms": a1_bound,
            "bound_by": a1_by, "library_ms": a1_lib_ms}

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
        perm_np, _ = pathtrace._tile_permutation(w, h)
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
        inputs8, _ = ktrav.launch_inputs(o8, d8, cfg.grid)
        time_b2("the cold streaming primaries", inputs8,
                torch.full((1,), o8.shape[0], dtype=torch.int32, device=dev),
                want, csc)
        print_b2("the cold streaming primaries")
        del cold, csc, got, want, o8, d8, u, inputs8

        plain_calls = {"B2": 0, "W0": 0, "W1": 0, "W2": 0, "W3": 0,
                       "W4": 0}
        saved8 = [counting(ktrav, "trace_rays", "B2"),
                  counting(ktrav, "trace_clipped_rays", "B2"),
                  *count_wave_plain(plain_calls)]
        launches8, requests8, b2_ms8, w8 = [], [], [], []
        w_last = [w_launches()]
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
            now = w_launches()
            w8.append([x - y for x, y in zip(now, w_last[0])])
            w_last[0] = now
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
        w_last[0] = w_launches()
        gc.callbacks.append(gc_timer)
        try:
            with benchmark.KernelTimes(B2=ktrav.trace) as timer8:
                out8 = benchmark.run_streaming_benchmark(
                    truth, cfg, view=0, width=w, height=h, waves=waves8,
                    queue_size=queue, starting_capacity=16, seed=0,
                    device=dev, on_wave=on_wave8)
        finally:
            gc.callbacks.remove(gc_timer)
            restore(saved8)
        b2_launches8 = ktrav.trace.launches
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
              f"{sum(r['grew'] for r in rows8)} growths; W1, W2, W3, W0, W4 "
              f"launches per wave {w8} on {out8['device']}", flush=True)
        sc8 = mgr.device_scene()
        print(f"  device bytes: streaming scene {sc8.nbytes} (pool "
              f"{sc8.pool_words.numel() * 4}) against the resident "
              f"{world.nbytes}", flush=True)
        if b2_launches8 != sum(launches8) or min(launches8) < 1:
            fail(f"a streaming wave did not launch B2: {launches8}")
        if min(min(x) for x in w8) < 1:
            fail(f"a streaming wave did not launch W0-W4: {w8}")
        if any(plain_calls.values()):
            fail(f"plain versions ran in the streaming waves: "
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
    from brickmap_tpu_torch.app import cli, live as live_mod
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
        orig_apply = live_mod._apply_camera_input

        def counted_wave9(*a, **k):
            before, w_before = ktrav.trace.launches, w_launches()
            r_before = wave_graph.calls[wave_graph.REPLAY]
            out = orig_wave(*a, **k)
            waves9.append((ktrav.trace.launches - before,
                           int(out[2]["exhausted_rays"]),
                           [x - y for x, y in zip(w_launches(), w_before)],
                           wave_graph.calls[wave_graph.REPLAY] - r_before))
            return out

        def logged_init(*a, **k):
            events9.append("film_init")
            return orig_init(*a, **k)

        def logged_apply(*a, **k):
            events9.append("camera_input")
            return orig_apply(*a, **k)

        plain_calls = {"B2": 0, "W0": 0, "W1": 0, "W2": 0, "W3": 0,
                       "W4": 0, "W5": 0}
        saved9 = [counting(ktrav, "trace_rays", "B2"),
                  counting(ktrav, "trace_clipped_rays", "B2"),
                  counting(kwave, "blit_plain", "W5"),
                  *count_wave_plain(plain_calls)]
        pathtrace.render_wave, pathtrace.film_init = counted_wave9, \
            logged_init
        live_mod._apply_camera_input = logged_apply
        orig_server, preview.PreviewServer = preview.PreviewServer, Served
        th9 = threading.Thread(target=client_run, daemon=True)
        stdout9 = io.StringIO()
        ktrav.trace.launches = 0
        kwave.blit.launches = 0
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
            live_mod._apply_camera_input = orig_apply
            preview.PreviewServer = orig_server
            restore(saved9)
        b2_launches9 = ktrav.trace.launches
        blit_launches9 = kwave.blit.launches
        line = stdout9.getvalue().strip().splitlines()[-1]
        print(f"  render: rc {rc}, {loop_s:.2f} s; {line}")
        rec9 = json.loads(line)
        pngs = sorted(f for f in os.listdir(out_dir)
                      if f.startswith("view_") and f.endswith(".png"))
        print(f"  B2 launches {b2_launches9}, per wave "
              f"{[n for n, _, _, _ in waves9]}, exhausted "
              f"{[e for _, e, _, _ in waves9]}; W1, W2, W3, W0, W4 per wave "
              f"{[x for _, _, x, _ in waves9]}; replayed "
              f"{[r for _, _, _, r in waves9]}; PNGs {pngs}; film events "
              f"{events9}; served: frame.png {len(got9.get('png', b''))} "
              f"bytes, stats {got9.get('stats')}, POST /camera -> "
              f"{got9.get('post')}", flush=True)
        if rc != 0 or rec9["frames"] != 3 or rec9["waves"] != 6:
            fail(f"the viewer run: rc {rc}, {rec9}")
        if pngs != ["view_000.png", "view_001.png", "view_002.png"]:
            fail(f"the viewer wrote {pngs}")
        # A wave that ran kernel by kernel (or was captured) launched B2
        # and W0-W4; a replayed one launched its graph and no wrapper.
        launched9 = [(n, x) for n, _, x, r in waves9 if not r]
        replayed9 = [(n, x) for n, _, x, r in waves9 if r]
        if len(waves9) != 6 or not launched9 \
                or min(n for n, _ in launched9) < 1 \
                or b2_launches9 != sum(n for n, _, _, _ in waves9):
            fail(f"a viewer wave did not launch B2: {waves9}")
        if min(min(x) for _, x in launched9) < 1:
            fail(f"a viewer wave did not launch W0-W4: {waves9}")
        if any(n or any(x) for n, x in replayed9) \
                or any(r not in (0, 1) for _, _, _, r in waves9):
            fail(f"a replayed viewer wave launched a wrapper: {waves9}")
        if any(plain_calls.values()):
            fail(f"plain versions ran in the viewer: {plain_calls}")
        # The served viewer presents every wave, and each frame's PNG once
        # more: one W5 launch each.
        print(f"  W5 launches in the viewer {blit_launches9}", flush=True)
        if blit_launches9 != rec9["waves"] + rec9["frames"]:
            fail(f"the viewer launched W5 {blit_launches9} times, not "
                 f"{rec9['waves'] + rec9['frames']} (a wave's present and "
                 f"a frame's PNG each)")
        if any(e for _, e, _, _ in waves9):
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

        # W5 on the films of real waves (view 0, two waves, so counts are
        # 2): at the live viewer's 960x540 (render's default) and at this
        # phase's shape, bit-equal to its plain version on the same CUDA
        # tensors, then timed alone beside its bound (16 B read and 3 B
        # written a pixel): launches queued behind a device sleep over
        # copies of the film that exceed the L2, and events around each.
        w5rec = {}
        for ww, hh in ((960, 540), (w, h)):
            arr5 = camera_arrays_for(cam0, sun, ww, hh, dev)
            film5 = pathtrace.film_init(ww, hh, dev)
            for _ in range(2):
                rgb5, cnt5, _ = pathtrace.render_wave(
                    world, arr5, cam0.brick_position, cfg, ww, hh,
                    generator=gen)
                film5 = pathtrace.film_add(film5, rgb5, cnt5)
            n5 = ww * hh
            before5 = kwave.blit.launches
            got5 = kwave.blit(film5["rgb"], film5["count"], ww, hh)
            want5 = owave.blit_plain(film5["rgb"], film5["count"], ww, hh)
            levels5 = int(torch.unique(got5).numel())
            if kwave.blit.launches != before5 + 1 or got5.shape != (
                    hh, ww, 3) or not torch.equal(got5, want5):
                fail(f"W5 at {ww}x{hh}: {kwave.blit.launches - before5} "
                     f"launches, shape {tuple(got5.shape)}, "
                     f"{int((got5 != want5).sum())} bytes differ from the "
                     f"plain version")
            if levels5 < 2:
                fail(f"W5 at {ww}x{hh}: a uniform frame")
            bms5, by5 = bound(19 * n5, 0)
            copies5 = [(film5["rgb"].clone(), film5["count"].clone())
                       for _ in range(benchmark.hbm_copies(19 * n5, dev))]
            q5 = benchmark.kernel_alone_ms(
                [lambda r=r, c=c: kwave.blit(r, c, ww, hh)
                 for r, c in copies5], 200)
            e5 = alone_ms(kwave.blit, lambda: kwave.blit(
                film5["rgb"], film5["count"], ww, hh), 50)
            p5 = host_ms(lambda: owave.blit_plain(
                film5["rgb"], film5["count"], ww, hh))
            w5rec[(ww, hh)] = (q5, e5, p5, bms5, by5)
            print(f"  W5 at {ww}x{hh} ({n5} pixels, {levels5} levels): "
                  f"equal to the plain version bit for bit; {q5:.4f} ms "
                  f"queued over {len(copies5)} copies, {e5:.4f} ms by "
                  f"events around each launch, bound {bms5:.4f} ms by "
                  f"{by5} ({100 * bms5 / q5:.1f}% of it queued), plain "
                  f"{p5:.4f} ms; ptxas blit_kernel: "
                  f"{entry_ptxas('wave', 'blit_kernel')}", flush=True)
            del copies5, film5, rgb5, cnt5, got5, want5
        q5, e5, p5, bms5, by5 = w5rec[(960, 540)]
        records["W5"] = {
            "name": "blit (W5)", "route": "cuda",
            "source": "brickmap_tpu_torch/csrc/wave.cu",
            "replaces": "brickmap_tpu/render/pathtrace.py:52",
            "launches": blit_launches9, "max_abs_err": 0.0, "ms": q5,
            "plain_ms": p5, "bound_ms": bms5, "bound_by": by5,
            "library_ms": None}

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
        kinds = {"kernel": 0, "DtoH": 0, "HtoD pageable": 0, "HtoD": 0,
                 "other copy": 0, "memset": 0}
        api = {}
        for e in prof9.events():
            name = e.name
            if e.device_type == DeviceType.CUDA:
                if name.startswith("Memset"):
                    kinds["memset"] += 1
                elif not name.startswith("Memcpy"):
                    kinds["kernel"] += 1
                elif "DtoH" in name:
                    kinds["DtoH"] += 1
                elif "HtoD" in name:
                    kinds["HtoD pageable" if "Pageable" in name
                          else "HtoD"] += 1
                else:
                    kinds["other copy"] += 1
            elif name.startswith(("cuda", "cu")) and "Synchronize" in name:
                api[name] = api.get(name, 0) + 1
        print(f"  one profiled wave (view 0): {wave_ms:.3f} ms host, "
              f"{n_act} device activities over {span_ms:.3f} ms, "
              f"{busy_ms:.3f} ms busy -> device idle "
              f"{1 - busy_ms / wave_ms:.3f} of the wave; kernel launches "
              f"{kinds['kernel']}, synchronising copies (device to host) "
              f"{kinds['DtoH']}, pageable host-to-device copies "
              f"{kinds['HtoD pageable']}, other host-to-device "
              f"{kinds['HtoD']}, other copies {kinds['other copy']}, "
              f"memsets {kinds['memset']}; synchronise calls {api}; top "
              f"device operations (ms, share of the wave, calls):")

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
        # The wave's launch and copy budget: at most 150 kernels, no
        # device-to-host copy or stream synchronise (the wave makes no host
        # round trip; the window's own torch.cuda.synchronize calls are
        # device synchronises), no pageable host-to-device copy.
        if not 0 < kinds["kernel"] <= 150:
            fail(f"the profiled wave shows {kinds['kernel']} kernel "
                 f"launches, not 1 to 150")
        if kinds["DtoH"] or api.get("cudaStreamSynchronize", 0):
            fail(f"the profiled wave makes {kinds['DtoH']} device-to-host "
                 f"copies and {api.get('cudaStreamSynchronize', 0)} stream "
                 f"synchronises, not 0")
        if kinds["HtoD pageable"]:
            fail(f"the profiled wave makes {kinds['HtoD pageable']} "
                 f"pageable host-to-device copies")

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
            mesh = par.make_mesh(cfg.mesh)
            print(f"  process group: backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, mesh {mesh.size} on "
                  f"{mesh.device}")
            cam0 = benchmark.benchmark_cameras()[0]
            arrays = camera_arrays_for(cam0, sun, w, h, dev)
            u = draw_wave_uniforms(n, cfg.render.max_bounces, gen, dev)
            plain_calls = {"B2": 0, "B3": 0, "R1": 0, "B4f": 0, "R2": 0,
                           "B4b": 0, "W0": 0, "W1": 0, "W2": 0, "W3": 0,
                           "W4": 0}
            saved10 = [counting(ktrav, "trace_rays", "B2"),
                       counting(ktrav, "trace_clipped_rays", "B2"),
                       counting(krec, "record_segments_plain", "B3"),
                       counting(krep, "segment_geom_plain", "R1"),
                       counting(kext, "extract_fwd_plain", "B4f"),
                       counting(krep, "composite_sse_plain", "R2"),
                       counting(kext, "extract_bwd_plain", "B4b"),
                       *count_wave_plain(plain_calls)]

            def host_s(fn):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                return out, time.perf_counter() - t1

            ktrav.trace.launches = 0
            w0 = w_launches()
            (rgb_s, cnt_s, req_s), sharded_s = host_s(
                lambda: par.render_wave_sharded(
                    mesh, world, arrays, cam0.brick_position, cfg, w, h,
                    uniforms=u))
            b2_sharded = ktrav.trace.launches
            w_sharded = [x - y for x, y in zip(w_launches(), w0)]
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
                  f"W1, W2, W3, W0, W4 {w_sharded}, "
                  f"{int(req_s['traced_rays'])} rays traced, equal to "
                  f"wave_for_indices bit for bit: {same}")
            if b2_sharded < 5 or min(w_sharded) < 1 or not same:
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
            w0 = w_launches()
            (rgb_f, cnt_f, traced_f, reqs_f, exh_f), frame_s = host_s(
                lambda: pathtrace.render_frame(
                    world, arrays, cam0.brick_position, cfg, w, h,
                    rays_per_chunk=chunk, chunk_uniforms=us, queue_size=n))
            b2_frame = ktrav.trace.launches
            w_frame = [x - y for x, y in zip(w_launches(), w0)]
            same = torch.equal(rgb_f, rgb_w) and torch.equal(cnt_f, cnt_w)
            print(f"  render_frame, view 0 in {len(chunks)} chunks of "
                  f"{chunk}: {frame_s * 1e3:.3f} ms (render_wave "
                  f"{wave_s * 1e3:.3f} ms), B2 launches {b2_frame}, "
                  f"W1, W2, W3, W0, W4 {w_frame}, {traced_f} rays traced "
                  f"(the wrapped chunk's repeats included), exhausted "
                  f"{exh_f}, {len(reqs_f)} requests (render_wave: "
                  f"{len(reqs_w)}); rgb and count equal to render_wave's "
                  f"on the same per-pixel uniforms: {same}")
            if b2_frame < len(chunks) or exh_f or not same \
                    or w_frame[0] != len(chunks) \
                    or min(w_frame[1:]) < len(chunks) \
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
            for f in train_kernels.values():
                f.launches = 0
            t0 = time.perf_counter()
            o_s, d_s, bg_s, tgt_s = par.shard_rays(mesh, (o10, d10, bg10,
                                                          tgt10))
            loss_s, go_s, ga_s = par.inverse_train_step_sparse(
                mesh, o_s, d_s, world, cm10, occ10, alb10, bg_s, tgt_s,
                cfg.grid, k_segments=K)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            launches10 = {k: f.launches for k, f in train_kernels.items()}
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
            restore(saved10)
            dist.destroy_process_group()

        dense = benchmark.run_dense_inverse_benchmark(dev)
        print(f"  dense compositor fwd+bwd (64^3 grid, {dense['rays']} rays, "
              f"max_steps 192): {dense['mrays_per_s']:.4f} Mrays/s, "
              f"{dense['seconds']:.3f} s a call, loss {dense['loss']!r} on "
              f"{dense['device']}", flush=True)
        if not (math.isfinite(dense["loss"]) and dense["mrays_per_s"] > 0):
            fail(f"the dense stage: {dense}")

        for f in train_kernels.values():
            f.launches = 0
        small = benchmark.run_sparse_inverse_benchmark_small(dev)
        small_launches = {k: f.launches for k, f in train_kernels.items()}
        print(f"  sparse stage on the small world (bench.py::_sparse_bwd_"
              f"bench, 1024^2 x 256, {small['bricks']} bricks, "
              f"{small['rays']} rays, K = {benchmark.SPARSE_K}): full "
              f"{small['full']:.4f} Mrays/s ({small['full_s']:.3f} s), "
              f"cached_step {small['cached_step']:.4f} Mrays/s "
              f"({small['cached_step_s']:.3f} s), loss {small['loss']!r}, "
              f"launches {small_launches} on {small['device']}", flush=True)
        if not (math.isfinite(small["loss"]) and small["full"] > 0
                and min(small_launches.values()) > 0):
            fail(f"the small-world sparse stage: {small}, launches "
                 f"{small_launches}")

    for r in records.values():
        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if not math.isfinite(r[k]):
                fail(f"{r['name']}: {k} is not finite")
    print(smi_line())
    print(json.dumps({"kernels": [records[k] for k in
                                  ("B1", "B2", "B3", "B4f", "B4b", "W0",
                                   "W1", "W2", "W3", "W4", "W5", "R1",
                                   "R2", "A1")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
