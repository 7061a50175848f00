"""Command-line harness of the port: ``python -m brickmap_tpu_torch <cmd>``.

The ``render`` and ``bench`` subcommands of ``brickmap_tpu/app/cli.py``:

* ``render`` — progressive path-traced render of a terrain world to PNG.
* ``bench``  — the 9-viewpoint scripted benchmark (performance_measure.cpp).

Both run on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


class CliError(RuntimeError):
    """User-facing error: printed as a message, not a traceback."""


def _build_world(args, cfg, device):
    from .. import scene as scene_mod

    if args.load:
        if not os.path.exists(args.load):
            raise CliError(f"scene file not found: {args.load}")
        sc = scene_mod.load_scene(args.load, device)
        print(f"loaded {args.load}", file=sys.stderr)
    else:
        t0 = time.perf_counter()
        sc = scene_mod.generate_terrain_scene(cfg.grid, device=device)
        print(f"terrain generated in {time.perf_counter() - t0:.1f}s "
              f"({sc.num_bricks} bricks, {sc.nbytes} bytes on {device})",
              file=sys.stderr)
    if args.save_scene:
        scene_mod.save_scene(args.save_scene, sc)
    return sc


def _camera_for(args):
    from ..render.camera import Camera

    if args.angles:
        h, v = args.angles
        return Camera.from_angles(args.camera, h, v,
                                  focal_distance=args.focal_distance,
                                  lens_radius=args.lens_radius)
    d = np.asarray(args.look, np.float64) - np.asarray(args.camera, np.float64)
    n = np.linalg.norm(d)
    if n < 1e-9:
        raise CliError("--camera and --look coincide; no view direction")
    return Camera(position=tuple(float(p) for p in args.camera),
                  direction=tuple(d / n),
                  focal_distance=args.focal_distance,
                  lens_radius=args.lens_radius)


def _config(args):
    from ..config import BrickmapConfig, GridConfig, RenderConfig

    return BrickmapConfig(
        grid=GridConfig(grid_size=args.world, grid_height=args.world_height),
        render=RenderConfig(width=args.width, height=args.height,
                            max_bounces=args.bounces,
                            max_top_steps=args.max_steps))


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CliError("no CUDA device; pass --device cpu to run on the CPU")
    return dev


def cmd_render(args) -> int:
    from ..ops import sunsky as ss
    from ..render import pathtrace
    from ..render.camera import camera_arrays_for
    from ..utils.image import write_png
    from ..utils.metrics import FrameTimer

    if args.spp < 1:
        raise CliError("--spp must be >= 1")
    dev = _device(args)
    cfg = _config(args)
    sc = _build_world(args, cfg, dev)
    cam = _camera_for(args)
    sun = ss.sun_direction_from_position(args.sun, dev)
    arrays = camera_arrays_for(cam, sun, args.width, args.height, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    film = pathtrace.film_init(args.width, args.height, dev)
    timer = FrameTimer()
    for s in range(args.spp):
        t0 = time.perf_counter()
        rgb, count, req = pathtrace.render_wave(
            sc, arrays, cam.brick_position, cfg, args.width, args.height,
            generator=gen)
        film = pathtrace.film_add(film, rgb, count)
        traced = int(req["traced_rays"])   # waits for the wave
        dt = time.perf_counter() - t0
        timer.add(dt)
        if args.verbose:
            print(f"wave {s}: {dt * 1000:.0f} ms, {traced} rays, "
                  f"{int(req['exhausted_rays'])} exhausted", file=sys.stderr)
    img = pathtrace.tonemap(film, args.width, args.height).cpu().numpy()
    write_png(args.out, img)
    stats = timer.stats()
    stats["waves"] = stats.pop("frames")
    print(json.dumps({"out": args.out, "spp": args.spp,
                      "device": str(dev), **stats}))
    return 0


def cmd_bench(args) -> int:
    from .benchmark import run_forward_benchmark

    dev = _device(args)
    cfg = _config(args)
    sc = _build_world(args, cfg, dev)
    out = run_forward_benchmark(sc, cfg, waves_per_view=args.waves,
                                warmup_waves=args.warmup,
                                scale=args.world / 4096.0, seed=args.seed)
    print(json.dumps({k: v for k, v in out.items() if k != "per_view"}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="brickmap_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, width, height, world, world_height):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for the plain "
                             "versions of the kernels)")
        sp.add_argument("--width", type=int, default=width)
        sp.add_argument("--height", type=int, default=height)
        sp.add_argument("--bounces", type=int, default=3)
        sp.add_argument("--world", type=int, default=world)
        sp.add_argument("--world-height", type=int, default=world_height)
        sp.add_argument("--max-steps", type=int, default=512,
                        help="top-level DDA steps of the traversal budget")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--load", default=None)
        sp.add_argument("--save-scene", default=None)

    pr = sub.add_parser("render", help="path-trace a world to PNG")
    common(pr, 960, 540, 1024, 256)
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--spp", type=int, default=8)
    pr.add_argument("--camera", type=float, nargs=3,
                    default=[128.0, 128.0, 180.0])
    pr.add_argument("--look", type=float, nargs=3,
                    default=[512.0, 512.0, 80.0])
    pr.add_argument("--angles", type=float, nargs=2, default=None,
                    help="yaw pitch instead of --look")
    pr.add_argument("--sun", type=float, nargs=2, default=[0.05, 0.1])
    pr.add_argument("--focal-distance", type=float, default=1.0)
    pr.add_argument("--lens-radius", type=float, default=0.0)
    pr.add_argument("--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="9-viewpoint scripted benchmark")
    common(pb, 1920, 1080, 1024, 256)
    pb.add_argument("--waves", type=int, default=2)
    pb.add_argument("--warmup", type=int, default=1)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
