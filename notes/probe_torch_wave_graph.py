#!/usr/bin/env python3
"""What ``render_wave``'s CUDA graph costs a wave that does not replay, on
one CUDA card.

    python3 notes/probe_torch_wave_graph.py [--reps 200]

On a 512^2 x 128 terrain at 960x540 (the live cell's frame size):

* in turns, ``render_wave`` with a key that never comes twice in a row
  (the camera's brick moves every call, so every call runs eagerly)
  against the eager wave it runs (``pathtrace._wave``) on the same bricks;
* the pieces the eager call adds, each alone: the table, the eager check,
  the key and the capture rule's step;
* the third call in a row of a new key (a capture, then its first replay)
  against eager calls, and a replay.

Host ms a call, taken before each call's synchronise.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.config import BrickmapConfig, GridConfig, \
        RenderConfig
    from brickmap_tpu_torch.ops import sunsky as ss
    from brickmap_tpu_torch.render import pathtrace, wave_graph
    from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for

    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=200)
    reps = p.parse_args().reps
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    w, h = 960, 540
    cfg = BrickmapConfig(grid=GridConfig(grid_size=512, grid_height=128),
                         render=RenderConfig(width=w, height=h))
    world = scene_mod.generate_terrain_scene(cfg.grid, device=dev)
    sun = ss.sun_direction_from_position((0.05, 0.1), dev)
    d = torch.tensor([196.0, 196.0, -70.0])
    cam = Camera(position=(60.0, 60.0, 110.0),
                 direction=tuple((d / d.norm()).tolist()))
    arrays = camera_arrays_for(cam, sun, w, h, dev)
    gen = torch.Generator(device=dev)
    perm = pathtrace._tile_order(w, h, dev)
    bricks = [(7 + i % 40, 7, 13) for i in range(reps)]

    def timed(fn, keys) -> list:
        out = []
        for k in keys:
            t = time.perf_counter()
            fn(k)
            out.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
        return out

    def eager(b):
        gen.manual_seed(1)
        return pathtrace.render_wave(world, arrays, b, cfg, w, h,
                                     generator=gen)

    def bare(b):
        gen.manual_seed(1)
        return pathtrace._wave(world, perm, arrays, b, cfg, w, h, gen, None,
                               dst=perm)

    timed(eager, bricks[:10])
    timed(bare, bricks[:10])
    e0 = wave_graph.calls[wave_graph.EAGER]
    rows = {"render_wave (eager)": [], "_wave": []}
    for _ in range(3):
        rows["render_wave (eager)"] += timed(eager, bricks)
        rows["_wave"] += timed(bare, bricks)
    for name, ms in rows.items():
        print(f"  {name}: median {statistics.median(ms):.4f} ms, mean "
              f"{statistics.mean(ms):.4f} ms over {len(ms)} calls",
              flush=True)
    print(f"  eager calls counted {wave_graph.calls[wave_graph.EAGER] - e0}"
          f" of {3 * reps}", flush=True)

    table = wave_graph.table(dev)
    key = wave_graph.wave_key(world, perm, bricks[0], cfg, w, h)
    fresh = wave_graph.GraphTable()
    n = 20000
    for name, fn in (
            ("table()", lambda: wave_graph.table(dev)),
            ("eager_only()", lambda: wave_graph.eager_only(None)),
            ("wave_key()", lambda: wave_graph.wave_key(
                world, perm, bricks[0], cfg, w, h)),
            ("GraphTable.step()", lambda: fresh.step(key))):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        print(f"  {name}: {(time.perf_counter() - t) / n * 1e6:.2f} us a "
              f"call", flush=True)

    cap, rep, eag = [], [], []
    for i in range(12):
        b = (60 + i, 7, 13)
        ms = timed(eager, [b, b, b, b])
        eag += ms[:2]
        cap.append(ms[2])
        rep.append(ms[3])
    print(f"  a capture call: median {statistics.median(cap):.4f} ms "
          f"(eager {statistics.median(eag):.4f}, replay "
          f"{statistics.median(rep):.4f}); graphs kept "
          f"{len(table.graphs)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
