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
"""

from __future__ import annotations

import time

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
