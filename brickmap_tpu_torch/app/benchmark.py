"""Scripted-viewpoint benchmark harness.

The port of ``brickmap_tpu/app/benchmark.py``: the reference's nine fixed
camera positions and yaw/pitch angles (``performance_measure.h:4-25``) over
the simplex-noise world, reporting Mrays/s and the reference's avg/min/max
frame statistics (``performance_measure.cpp:82-101``).

The reference has 9 positions but only 8 angle entries (its index 8 reads out
of bounds), so angles wrap modulo 8 here.  Positions 4-8 lie OUTSIDE the
world box (e.g. x=11298 vs grid_size 4096): the scripted camera flies out and
looks back.  Scaling positions by world_size/4096 keeps that geometry for
smaller worlds.

On the card, waves are timed with CUDA events around work that ends in
``torch.cuda.synchronize``; on the CPU (tests) with the host clock.  Each
result names the device it ran on.

:func:`run_sparse_inverse_benchmark` is the port of
``bench.py::_sparse_bwd_full_bench``: one training step of the sparse
inverse renderer over the full world at 1920x1080 rays, timed by host clock
around work that ends in a synchronise.

:func:`run_streaming_benchmark` is the port of ``bench.py::_streaming_bench``:
a cold start from all-unloaded residency, every wave's requests serviced
before the next wave.

:func:`run_dense_inverse_benchmark` is the port of ``bench.py::_bwd_bench``:
forward + backward of the dense compositor over a 64^3 grid at 1920x1080
rays.

:func:`run_sparse_inverse_benchmark_small` is the port of
``bench.py::_sparse_bwd_bench``: the sparse step over the 1024^2 x 256 world
with fields over its whole pool.

:func:`run_brick_benchmark` is the port of ``bench.py::_pallas_brick_bench``
(config 1's stage): kernel B1 on 2M rays through one brick, through its
wrapper as bench.py times it, and the kernel alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import BrickmapConfig
from ..ops import sunsky as ss
from ..render import pathtrace
from ..render.camera import Camera, camera_arrays_for
from ..utils.metrics import FrameTimer

# performance_measure.h:4-14
TEST_POSITIONS = [
    (512.0, 512.0, 300.0),
    (840.254, 832.446, 1169.88),
    (2227.83, 774.886, 204.955),
    (3326.19, 2055.72, 44.7995),
    (7134.6, 1262.44, 5531.79),
    (11298.6, 3113.03, 598.019),
    (10921.4, 4774.14, 267.808),
    (9961.29, 4508.12, 189.59),
    (10835.3, 4160.83, 359.992),
]

# performance_measure.h:16-25 (8 entries; wraps for viewpoint 9)
TEST_ANGLES = [
    (-61863.5, -0.501796),
    (-61864.4, -0.429796),
    (-61863.9, 0.0622036),
    (-61864.2, -0.981796),
    (-61865.2, -0.501796),
    (-61866.3, -0.141796),
    (-61859.4, 0.0142036),
    (-61857.2, -0.261796),
]

SUN_POSITION = (0.05, 0.1)  # variables.cpp:3


def benchmark_cameras(scale: float = 1.0):
    """The nine scripted viewpoints as Camera objects (optionally scaled for
    smaller worlds)."""
    return [Camera.from_angles(tuple(p * scale for p in pos),
                               *TEST_ANGLES[i % len(TEST_ANGLES)])
            for i, pos in enumerate(TEST_POSITIONS)]


class _Clock:
    """Seconds of device work: CUDA events on the card, host clock on CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            torch.cuda.synchronize()
            return self.t0.elapsed_time(t1) / 1000.0
        return time.perf_counter() - self.t0


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def run_forward_benchmark(scene, cfg: BrickmapConfig, *,
                          waves_per_view: int = 2, warmup_waves: int = 1,
                          scale: float = 1.0, seed: int = 0,
                          verbose: bool = True, on_view=None,
                          on_wave=None) -> dict:
    """Path-trace each viewpoint for ``waves_per_view`` timed sample waves
    (after ``warmup_waves``); return per-viewpoint and aggregate Mrays/s +
    frame-time stats.

    It FAILS if any timed ray was truncated by a traversal budget: a
    benchmark that drops rays both biases the image and flatters the timing
    (every reference ray terminates with a defined result,
    voxel.cuh:135-261).

    ``on_view(results)`` runs after each viewpoint; ``on_wave(view, rgb)``
    after each timed wave, outside the timed region of the next one.
    """
    dev = scene.device
    w, h = cfg.render.width, cfg.render.height
    sun_dir = ss.sun_direction_from_position(SUN_POSITION, dev)
    clock = _Clock(dev)
    results = []
    timer = FrameTimer()

    for vi, cam in enumerate(benchmark_cameras(scale)):
        arrays = camera_arrays_for(cam, sun_dir, w, h, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1000 + vi)
        for _ in range(warmup_waves):
            pathtrace.render_wave(scene, arrays, cam.brick_position, cfg, w,
                                  h, generator=gen)

        timer.reset()
        total_rays = total_exhausted = 0
        seconds = 0.0
        for _ in range(waves_per_view):
            clock.start()
            rgb, _, req = pathtrace.render_wave(scene, arrays,
                                                cam.brick_position, cfg, w, h,
                                                generator=gen)
            dt = clock.stop()
            seconds += dt
            timer.add(dt)
            total_rays += int(req["traced_rays"])
            total_exhausted += int(req["exhausted_rays"])
            if on_wave is not None:
                on_wave(vi, rgb)

        stats = timer.stats()
        mrays = total_rays / seconds / 1e6
        results.append({"viewpoint": vi, "mrays_per_s": mrays,
                        "rays": total_rays, "exhausted": total_exhausted,
                        "seconds": seconds, **stats})
        if verbose:
            exh = f"  EXHAUSTED {total_exhausted}" if total_exhausted else ""
            print(f"view {vi}: {mrays:8.2f} Mrays/s  "
                  f"avg {stats['avg_ms']:.1f} ms  fps {stats['fps']:.2f}"
                  f"{exh}")
        if on_view is not None:
            on_view(results)

    agg_rays = sum(r["rays"] for r in results)
    agg_s = sum(r["seconds"] for r in results)
    total_exh = sum(r["exhausted"] for r in results)
    if total_exh:
        raise RuntimeError(
            f"benchmark invalid: {total_exh} rays exhausted their traversal "
            "budget after the rescue passes (render.pathtrace._rescue)")
    return {
        "per_view": results,
        "mrays_per_s": agg_rays / agg_s / 1e6,
        "total_rays": agg_rays,
        "total_exhausted": total_exh,
        "total_seconds": agg_s,
        "resolution": [w, h],
        "bounces": cfg.render.max_bounces,
        "device": device_name(dev),
    }


# The sparse step's segments per ray (bench.py:404), and the learning rate
# and step count of its Adam steps (``inverse --sparse``'s default update).
SPARSE_K = 8
SPARSE_LR = 0.05
SPARSE_ADAM_STEPS = 3


class KernelTimes:
    """CUDA-event times of kernel launches while open: each wrapper's
    ``events`` hook (:mod:`brickmap_tpu_torch.kernels`) is a list inside the
    context and ``None`` again after it."""

    def __init__(self, **wrappers):
        self.wrappers = wrappers

    def __enter__(self):
        for w in self.wrappers.values():
            w.events = []
        return self

    def __exit__(self, *exc):
        for w in self.wrappers.values():
            w.events = None
        return False

    def take(self) -> dict:
        """``{name: (summed ms, launches)}`` since the last call."""
        if self.wrappers:
            torch.cuda.synchronize()
        out = {}
        for name, w in self.wrappers.items():
            out[name] = (sum(a.elapsed_time(b) for a, b in w.events),
                         len(w.events))
            w.events.clear()
        return out


def run_dense_inverse_benchmark(device="cuda", width: int = 1920,
                                height: int = 1080) -> dict:
    """fwd+bwd throughput of the dense differentiable compositor
    (``diff/render.py::l2_loss_and_grads``, max_steps 192) over a 64^3
    occupancy + albedo grid (uniform from ``default_rng(0)``), one ray per
    pixel from (32, 32, 32) - 96 dir with normal-drawn directions, target
    0.5 (``bench.py:277-305``).  One warm-up call, then 3 timed calls by
    host clock around work that ends in a synchronise.  Returns
    ``{"mrays_per_s", "loss", "rays", "seconds", "device"}``."""
    from ..diff.render import l2_loss_and_grads

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    occ = rng.uniform(0, 1, (64, 64, 64)).astype(np.float32)
    alb = rng.uniform(0, 1, (64, 64, 64, 3)).astype(np.float32)
    n = width * height
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([32, 32, 32]) - dirs * 96).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (origins, dirs, occ, alb)]
    args += [torch.zeros((n, 3), device=dev),
             torch.full((n, 3), 0.5, device=dev)]
    loss = float(l2_loss_and_grads(*args, max_steps=192)[0])
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = l2_loss_and_grads(*args, max_steps=192)
        float(out[0])   # waits for the step
    dt = time.perf_counter() - t0
    return {"mrays_per_s": reps * n / dt / 1e6, "loss": loss, "rays": n,
            "seconds": dt / reps, "device": device_name(dev)}


def sparse_inverse_rays(n: int, grid, device, span=(0.25, 0.75)):
    """The sparse benchmarks' frame (seed 0): origins uniform over the
    ``span`` fractions of the world in x and y at z = 500/512 of its height,
    directions ``normal`` with d_z = -|d_z| - 1, normalised; background 0,
    target 0.4.  The default span is ``bench.py::_sparse_bwd_full_bench``'s
    (:402-414; [1024, 3072]^2 at z = 500 in the 4096^2 x 512 world);
    (1/16, 15/16) is ``_sparse_bwd_bench``'s (:336-347; [64, 960]^2 at
    z = 250 in the 1024^2 x 256 world)."""
    rng = np.random.default_rng(0)
    m = float(grid.grid_size)
    ox = rng.uniform(span[0] * m, span[1] * m, n).astype(np.float32)
    oy = rng.uniform(span[0] * m, span[1] * m, n).astype(np.float32)
    oz = np.full(n, grid.grid_height * 500.0 / 512.0, np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = torch.from_numpy(np.stack([ox, oy, oz], 1)).to(device)
    return (origins, torch.from_numpy(dirs).to(device),
            torch.zeros((n, 3), dtype=torch.float32, device=device),
            torch.full((n, 3), 0.4, dtype=torch.float32, device=device))


def schedule_edge_rays(n: int, grid, device, seed: int = 0):
    """Rays that hold kernels B2/B3 to their plain versions where step
    counts differ most within a warp: in every 32 consecutive rays, lanes 0, 4, ... start above the world box pointing up
    and away (no step at all), lanes 1, 5, ... start inside it at 60% of its
    height, almost level (long walks that spend a small budget), and the
    rest start anywhere around the box in random directions.  Returns
    float32 [n, 3] origins and unit directions (numpy seed ``seed``)."""
    rng = np.random.default_rng(seed)
    m, hz = float(grid.grid_size), float(grid.grid_height)
    o = rng.uniform([-0.08 * m, -0.08 * m, -0.15 * hz],
                    [1.08 * m, 1.08 * m, 1.15 * hz], (n, 3))
    d = rng.normal(size=(n, 3))
    lane = np.arange(n) % 32
    miss = lane % 4 == 0
    o[miss] = [-0.1 * m, -0.1 * m, 1.5 * hz]
    d[miss] = [-0.5, -0.5, 0.7]
    graze = lane % 4 == 1
    a = rng.uniform(0.0, 2.0 * np.pi, int(graze.sum()))
    o[graze] = np.stack([rng.uniform(0.0, m, a.shape[0]),
                         rng.uniform(0.0, m, a.shape[0]),
                         np.full(a.shape[0], 0.6 * hz)], 1)
    d[graze] = np.stack([np.cos(a), np.sin(a), np.full(a.shape[0], -0.02)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(device),
            torch.from_numpy(d.astype(np.float32)).to(device))


# Blocks of 128 threads that one H100 SM holds at once (65,536 registers,
# 228 KB of shared memory), from the ptxas register counts in PERF.md:
# B2 at 55 registers, B3 at 40 (its K x 8-byte slots fit 12 blocks up to
# K = 16).
B2_BLOCKS_PER_SM = 9
B3_BLOCKS_PER_SM = 12


def edge_counts(blocks_per_sm: int, sms: int) -> tuple:
    """Ray counts at a launch's edges: one ray, a warp and one ray less or
    more, the threads resident at once (``blocks_per_sm`` blocks of 128 on
    each of ``sms`` SMs) and one less or more (a second wave of blocks),
    and 3.5 times that."""
    resident = blocks_per_sm * sms * 128
    return (1, 31, 33, resident - 1, resident + 1, resident * 7 // 2)


def launch_order_simd(steps: torch.Tensor) -> float:
    """SIMD efficiency of one thread per ray in launch order, from per-ray
    step counts: a warp of 32 consecutive rays issues steps until its
    longest ray ends, so the efficiency is the steps taken over 32 times
    each warp's largest count, summed over warps."""
    s = steps.reshape(-1).to(torch.int64)
    s = torch.cat([s, s.new_zeros((-s.shape[0]) % 32)]).reshape(-1, 32)
    longest = int(s.amax(1).sum())
    return float(s.sum()) / (32 * longest) if longest else 0.0


# GPU clock cycles a device sleep lasts before a run of timed launches
# (~10 ms at the H100's 1.98 GHz boost): the host enqueues the launches
# while the device sleeps, so their events see no gap between launches.
SLEEP_CYCLES = 20_000_000


def hbm_copies(nbytes: int, device) -> int:
    """How many copies of a launch's inputs and outputs (``nbytes`` a copy)
    hold more than twice the card's L2 together: launches that take the
    copies in turn read and write HBM, not a warm L2."""
    l2 = torch.cuda.get_device_properties(torch.device(device)).L2_cache_size
    return 2 * l2 // max(nbytes, 1) + 1


def kernel_alone_ms(runs: list, reps: int = 50) -> float:
    """Mean ms of one launch over ``reps`` launches queued behind a device
    sleep, by CUDA events around the launches; after one warm-up launch of
    each.  ``runs``: callables that each launch the kernel (nothing else on
    the stream) on one copy of the same inputs, taken in turn (see
    :func:`hbm_copies`).  The sleep is doubled until the host has enqueued
    every launch before it ends."""
    for run in runs:
        run()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for k in range(reps):
            runs[k % len(runs)]()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * e0.elapsed_time(a):
            return a.elapsed_time(b) / reps
        cycles *= 2
    raise RuntimeError("the host could not enqueue the launches within the "
                       "device sleep")


def brick_kernel_ms(origins: torch.Tensor, dirs: torch.Tensor, words,
                    reps: int = 50) -> float:
    """Kernel B1 alone on these CUDA rays: :func:`kernel_alone_ms` over
    launches that take :func:`hbm_copies` copies of the rays (24 B in and
    9 B out a ray) in turn, each into outputs allocated once."""
    from ..kernels import brick as kbrick

    n = origins.shape[0]
    runs = [kbrick.prepared_launch(origins.clone(), dirs.clone(), words)[0]
            for _ in range(hbm_copies(33 * n, origins.device))]
    return kernel_alone_ms(runs, reps)


def brick_benchmark_rays(n: int = 1 << 21, seed: int = 0):
    """The inputs of ``bench.py::_pallas_brick_bench`` (bench.py:538-549),
    line for line: one brick at density 0.12 and ``n`` unit directions from
    ``default_rng(seed)``, each ray aimed through the brick's centre from
    distance 20 and moved to its entry face plus 1e-3.  Returns numpy
    (words uint32 [16], origins float32 [n, 3], dirs float32 [n, 3])."""
    from .. import bits

    rng = np.random.default_rng(seed)
    dense = rng.random((8, 8, 8)) < 0.12
    words = bits.brick_words_from_dense(torch.from_numpy(dense)).numpy()
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    start = np.array([4.0, 4.0, 4.0]) - dirs * 20
    with np.errstate(divide="ignore"):
        tenter = np.minimum((0.0 - start) / dirs,
                            (8.0 - start) / dirs).max(1) + 1e-3
    origins = (start + dirs * tenter[:, None]).astype(np.float32)
    return words.view(np.uint32), origins, dirs


def brick_edge_rays(n: int, seed: int = 0):
    """Rays that hold kernel B1 to its plain version where its padded walk
    and its general loop part: about half the components of origins and
    three fifths of those of directions drawn from edge values (origins at
    and around -1, 0, 8, 2^20 and up to 2^31 - 128; directions 0,
    -0, denormal, 2^-126, below 1e-4, 2^126 and up, inf, NaN), the rest
    uniform in [-2, 10)^3 and unit directions (no NaN origin: its cell is
    undefined in C).  Returns float32 numpy
    (origins [n, 3], dirs [n, 3])."""
    rng = np.random.default_rng(seed)
    d_edge = np.array([0.0, -0.0, 1.0, -1.0, 1e-5, -1e-5, 1e-4, -2e-4,
                       1e-20, -1e-30, 1e-40, -1e-40, 2.0 ** -126,
                       -2.0 ** -126, 1.1754942e-38, 8.5e37, 2.0 ** 126,
                       3e38, 0.577, np.inf, -np.inf, np.nan], np.float32)
    o_edge = np.array([0.0, -0.0, 8.0, -1.0, -0.9999999, -1.001, 7.9999,
                       8.05, 0.5, 3.0, 4.5, -5.5, 12.0, 100.25, 1e6,
                       1048575.0, 1048576.0, 1e9, 2147483520.0], np.float32)
    o = rng.uniform(-2.0, 10.0, (n, 3)).astype(np.float32)
    o = np.where(rng.random((n, 3)) < 0.5, rng.choice(o_edge, (n, 3)), o)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(rng.random((n, 3)) < 0.6, rng.choice(d_edge, (n, 3)), d)
    return o.astype(np.float32), d.astype(np.float32)


def run_brick_benchmark(device="cuda", n: int = 1 << 21,
                        calls: int = 8) -> dict:
    """Config 1's stage (``bench.py::_pallas_brick_bench``): kernel B1 on
    :func:`brick_benchmark_rays` through one brick.

    ``brick_mrays_per_s`` (the counterpart of bench.py's
    ``pallas_brick_mrays_per_s``) is timed as bench.py times it: ``calls``
    back-to-back calls of the public wrapper, each summing its hits, one
    synchronise, the best of 3 rounds.  bench.py adds ``(rep*K+k)*1e-6`` to
    the origins so that XLA cannot reuse a result; the port has no such
    cache, so every call takes the same rays.  On the card also
    ``wrapper_host_ms`` (the host's time to issue one wrapper call, behind a
    device sleep) and ``kernel_ms`` (the kernel alone from HBM:
    :func:`brick_kernel_ms`).
    On the CPU the wrapper runs B1's plain version and ``kernel_ms`` is
    None.  Returns ``{"brick_mrays_per_s", "call_ms", "wrapper_host_ms",
    "kernel_ms", "rays", "hits", "device"}``."""
    from ..kernels import brick as kbrick

    dev = torch.device(device)
    words_np, o_np, d_np = brick_benchmark_rays(n)
    words = torch.from_numpy(words_np.view(np.int32)).to(dev)
    o, d = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
    hits = int(kbrick.trace_single_brick(o, d, words)["hit"].sum())
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = None
        for _ in range(calls):
            a = kbrick.trace_single_brick(o, d, words)["hit"].sum()
            acc = a if acc is None else acc + a
        int(acc)  # waits for the calls
        best = min(best, (time.perf_counter() - t0) / calls)
    out = {"brick_mrays_per_s": n / best / 1e6, "call_ms": best * 1e3,
           "wrapper_host_ms": None, "kernel_ms": None, "rays": n,
           "hits": hits, "device": device_name(dev)}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            kbrick.trace_single_brick(o, d, words)
        out["wrapper_host_ms"] = (time.perf_counter() - t0) / calls * 1e3
        torch.cuda.synchronize()
        out["kernel_ms"] = brick_kernel_ms(o, d, words)
    else:
        t0 = time.perf_counter()
        kbrick.trace_single_brick(o, d, words)
        out["wrapper_host_ms"] = (time.perf_counter() - t0) * 1e3
    return out


# bench.py::_sparse_bwd_bench's origins: [64, 960]^2 of the 1024^2 world.
SMALL_SPAN = (1 / 16, 15 / 16)


def run_sparse_inverse_benchmark_small(device="cuda", grid=None, *,
                                       width: int = 1920,
                                       height: int = 1080) -> dict:
    """The sparse step over the small world (``bench.py::_sparse_bwd_bench``):
    the 1024^2 x 256 terrain (``grid``), :func:`sparse_inverse_rays` over
    (1/16, 15/16) of it at width x height rays, fields over the whole pool (occupancy = bitmask *
    0.8, albedo 0.6; no active-brick pre-pass), SPARSE_K segments.  One
    warm-up ``l2_loss_and_grads_sparse``, the best of 2 uncached steps
    (record, sorts, replay), then a ``seg_cache`` fill and the best of 2
    cached steps (replay only), each by host clock around work that ends in
    reading the loss.  Returns ``{"full", "cached_step"}`` in Mrays/s with
    the seconds, the loss, the rays, the pool's bricks and the device."""
    from .. import scene as scene_mod
    from ..config import GridConfig
    from ..diff.sparse import (cell_pool_map, l2_loss_and_grads_sparse,
                               pool_fields_from_bitmask)

    dev = torch.device(device)
    grid = grid if grid is not None else GridConfig(grid_size=1024,
                                                    grid_height=256)
    sc = scene_mod.generate_terrain_scene(grid, device=dev)
    cellmap = cell_pool_map(sc, grid)
    occ, alb = pool_fields_from_bitmask(sc)
    occ, alb = occ * 0.8, alb * 0.6
    n = width * height
    origins, dirs, bg, tgt = sparse_inverse_rays(n, grid, dev,
                                                 span=SMALL_SPAN)

    def run(cache=None):
        loss, _ = l2_loss_and_grads_sparse(origins, dirs, sc, cellmap, occ,
                                           alb, bg, tgt, grid,
                                           k_segments=SPARSE_K,
                                           seg_cache=cache)
        return float(loss)

    def best_of_2(cache=None):
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            run(cache)
            best = min(best, time.perf_counter() - t0)
        return best

    loss = run()
    full_s = best_of_2()
    cache: dict = {}
    run(cache)
    cached_s = best_of_2(cache)
    return {"full": n / full_s / 1e6, "cached_step": n / cached_s / 1e6,
            "full_s": full_s, "cached_step_s": cached_s, "loss": loss,
            "rays": n, "bricks": sc.num_bricks, "device": device_name(dev)}


def active_fields(scene, grid, cells: torch.Tensor):
    """The frame's active-brick set (``bench.py:416-440``): the pool rows of
    the recorded ``cells``, a cellmap remapped onto them, and the fields
    occupancy = bitmask * 0.8, albedo = 0.6 over those rows only (a frame's
    gradients are zero on every brick it never records).
    Returns (cellmap_a [CZ,CY,CX], occ [A,512], alb [A,512,3])."""
    from .. import bits
    from ..diff.sparse import cell_pool_map

    cellmap = cell_pool_map(scene, grid)
    valid = cells >= 0
    c = cells[valid]
    rows = cellmap[(c >> 20) & 0x3FF, (c >> 10) & 0x3FF, c & 0x3FF]
    uniq = torch.unique(rows[rows >= 0])
    a = uniq.shape[0]
    inv = torch.full((scene.num_bricks,), -1, dtype=torch.int32,
                     device=cells.device)
    inv[uniq.long()] = torch.arange(a, dtype=torch.int32, device=cells.device)
    cellmap_a = torch.where(cellmap >= 0,
                            inv[torch.clamp(cellmap, min=0).long()], -1)
    dense = bits.dense_from_brick_words(scene.pool_words[uniq.long()])
    occ = dense.reshape(a, 512).to(torch.float32) * 0.8
    alb = torch.full((a, 512, 3), 0.6, dtype=torch.float32,
                     device=cells.device)
    return cellmap_a, occ, alb


def run_sparse_inverse_benchmark(scene, grid, *, width: int = 1920,
                                 height: int = 1080) -> dict:
    """The sparse inverse-rendering step at full width
    (``bench.py::_sparse_bwd_full_bench``): one frame of width x height
    rays over ``scene``, SPARSE_K segments, the fields restricted to the
    frame's active bricks.  Times by host clock around work that ends in a
    device synchronise: one uncached ``l2_loss_and_grads_sparse`` (record,
    sorts, replay) after a warm-up, one with ``seg_cache`` (replay only),
    then SPARSE_ADAM_STEPS Adam steps with the ``inverse --sparse`` update
    and clip (the update alone timed apart as ``adam_update_s``).

    On the card, the CUDA events of every launch of kernels B3, B4f and B4b
    give ``kernels[stage][name] = (ms, launches)`` for the stages "prepass",
    "warm-up", "uncached", "cache fill", "cached" and "adam".  The result
    names the device.  ``frame`` holds the step's inputs after the Adam
    steps (rays, ``background``, ``target``, ``cellmap``, ``occupancy``,
    ``albedo``) and its filled ``seg_cache``, for checks of the caller.
    """
    from ..diff.optim import adam_step, make_adam
    from ..diff.sparse import l2_loss_and_grads_sparse
    from ..kernels import extract as kext, record as krec

    dev = scene.device
    cuda = dev.type == "cuda"
    n = width * height
    times = KernelTimes(**({"B3": krec.record_segments,
                            "B4f": kext.extract_fwd,
                            "B4b": kext.extract_bwd} if cuda else {}))
    kernels: dict = {}
    current = [None]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def stage(name):
        """Close the current stage's kernel times, start ``name``'s."""
        sync()
        if current[0] is not None:
            kernels[current[0]] = times.take()
        current[0] = name
        return time.perf_counter()

    origins, dirs, bg, tgt = sparse_inverse_rays(n, grid, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def step(cache=None):
        return l2_loss_and_grads_sparse(origins, dirs, scene, cellmap, occ,
                                        alb, bg, tgt, grid,
                                        k_segments=SPARSE_K, seg_cache=cache)

    with times:
        t0 = stage("prepass")
        segs = krec.record_segments(origins, dirs, scene, grid,
                                    k_segments=SPARSE_K)
        cellmap, occ, alb = active_fields(scene, grid, segs["cells"])
        sync()
        prepass_s = time.perf_counter() - t0
        exhausted = int(segs["exhausted"].sum())
        count = segs["count"]
        live = int((count > 0).sum())
        mean_count = float(count[count > 0].float().mean()) if live else 0.0
        del segs, count

        stage("warm-up")
        step()
        t0 = stage("uncached")
        loss, (docc, dalb) = step()
        sync()
        uncached_s = time.perf_counter() - t0
        grads_finite = bool(torch.isfinite(docc).all()) and bool(
            torch.isfinite(dalb).all())
        grads_nonzero = bool((docc != 0).any()) and bool((dalb != 0).any())
        del docc, dalb

        cache: dict = {}
        stage("cache fill")
        step(cache)
        t0 = stage("cached")
        step(cache)
        sync()
        cached_s = time.perf_counter() - t0

        stage("adam")
        opt = make_adam((occ, alb), SPARSE_LR)
        losses, adam_s, update_s = [], [], []
        for _ in range(SPARSE_ADAM_STEPS):
            t0 = time.perf_counter()
            loss_i, grads = step(cache)
            sync()
            t1 = time.perf_counter()
            adam_step(opt, (occ, alb), grads)
            losses.append(float(loss_i))
            sync()
            adam_s.append(time.perf_counter() - t0)
            update_s.append(time.perf_counter() - t1)
        del opt, grads
        stage(None)
    out = {
        "rays": n, "k_segments": SPARSE_K, "active_bricks": int(occ.shape[0]),
        "live_rays": live, "mean_count": mean_count, "exhausted": exhausted,
        "prepass_s": prepass_s, "uncached_step_s": uncached_s,
        "cached_step_s": cached_s, "adam_step_s": adam_s,
        "adam_update_s": update_s, "loss": float(loss), "losses": losses,
        "grads_finite": grads_finite, "grads_nonzero": grads_nonzero,
        "mrays_per_s": n / uncached_s / 1e6,
        "cached_mrays_per_s": n / cached_s / 1e6,
        "kernels": kernels, "device": device_name(dev),
        "frame": {"origins": origins, "dirs": dirs, "background": bg,
                  "target": tgt, "cellmap": cellmap, "occupancy": occ,
                  "albedo": alb, "seg_cache": cache},
    }
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def run_streaming_benchmark(truth, cfg: BrickmapConfig, *, view: int = 0,
                            width: int = 960, height: int = 540,
                            waves: int = 12, queue_size: int = 1024,
                            starting_capacity: int = 16, seed: int = 0,
                            device="cuda", on_wave=None) -> dict:
    """Cold-start streaming from viewpoint ``view`` (``bench.py::
    _streaming_bench``): a :class:`~brickmap_tpu_torch.stream.StreamingScene`
    over ``truth`` on ``device``, then ``waves`` sample waves of width x
    height, each followed by the pull of its requests and their servicing.
    The viewpoint is scaled to the world by grid_size / 4096.

    Wave ``i`` draws its uniforms from a ``torch.Generator`` seeded with
    ``seed + i``.  The wave is timed by CUDA events on the card (host clock
    on the CPU); the pull, the host half of ``process_requests``
    (``plan``: dedupe, cap, slots, growth, payloads) and its device half
    (``install``: the copy, re-base and scatters, ending in a synchronise)
    by host clock.  Returns ``_streaming_bench``'s keys
    (``mrays_during_convergence`` over waves 1.., ``bricks_uploaded``,
    ``upload_bricks_per_s`` over the pull and servicing time, ``waves``),
    per-wave rows in ``per_wave``, the device name and the ``manager`` for
    checks of the caller.  ``on_wave(i, row, requests)`` runs after each
    wave's servicing, outside the timed regions.
    """
    from ..stream import StreamingScene, pull_requests

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    mgr = StreamingScene(truth, cfg.grid, queue_size=queue_size,
                         starting_capacity=starting_capacity, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    cam = benchmark_cameras(cfg.grid.grid_size / 4096.0)[view]
    arrays = camera_arrays_for(
        cam, ss.sun_direction_from_position(SUN_POSITION, dev), width,
        height, dev)
    clock = _Clock(dev)
    rows = []
    for i in range(waves):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + i)
        clock.start()
        _, _, req = pathtrace.render_wave(mgr.device_scene(), arrays,
                                          cam.brick_position, cfg, width,
                                          height, generator=gen)
        wave_s = clock.stop()
        t0 = time.perf_counter()
        got = pull_requests(req, mgr.queue_size)
        t1 = time.perf_counter()
        dropped = mgr.total_dropped
        batch = mgr.plan(got)
        t2 = time.perf_counter()
        if batch is not None:
            mgr.install(batch)
            sync()
        t3 = time.perf_counter()
        row = {"wave": i, "wave_ms": wave_s * 1e3,
               "traced": int(req["traced_rays"]),
               "exhausted": int(req["exhausted_rays"]),
               "requests": len(got),
               "uploads": 0 if batch is None else batch.size,
               "dropped": mgr.total_dropped - dropped,
               "pull_ms": (t1 - t0) * 1e3, "plan_ms": (t2 - t1) * 1e3,
               "install_ms": (t3 - t2) * 1e3,
               "grew": batch is not None and batch.grew,
               "pool_rows": mgr.pool_rows}
        rows.append(row)
        if on_wave is not None:
            on_wave(i, row, got)
    later = rows[1:]      # wave 0 pays the cold pipeline
    service_s = sum(r["pull_ms"] + r["plan_ms"] + r["install_ms"]
                    for r in rows) / 1e3
    uploads = sum(r["uploads"] for r in rows)
    return {
        "mrays_during_convergence": (
            sum(r["traced"] for r in later)
            / (sum(r["wave_ms"] for r in later) / 1e3) / 1e6
            if later else 0.0),
        "bricks_uploaded": uploads,
        "upload_bricks_per_s": uploads / service_s if service_s else 0.0,
        "waves": waves, "init_s": init_s, "per_wave": rows,
        "device": device_name(dev), "manager": mgr,
    }
