"""Command-line harness of the port: ``python -m brickmap_tpu_torch <cmd>``.

The ``render``, ``bench``, ``inverse`` and ``info`` subcommands of
``brickmap_tpu/app/cli.py``:

* ``render``  — progressive path-traced render of a terrain world to PNG;
  with ``--streaming`` every brick starts unloaded and each wave's requests
  are serviced before the next (:mod:`brickmap_tpu_torch.stream`).
* ``bench``   — the 9-viewpoint scripted benchmark (performance_measure.cpp).
* ``inverse`` — inverse rendering with Adam: a dense grid, or with
  ``--sparse`` the brick-pool fields of a terrain world.
* ``info``    — residency statistics of a saved scene.

All run on the card unless ``--device cpu`` asks for the CPU.
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
    from ..stream import StreamingScene, pull_requests
    from ..utils.image import write_png
    from ..utils.metrics import FrameTimer, MetricsLogger

    if args.spp < 1:
        raise CliError("--spp must be >= 1")
    dev = _device(args)
    cfg = _config(args)
    sc = _build_world(args, cfg, dev)
    mgr = None
    if args.streaming:
        # The JAX CLI's starting capacity per superchunk segment.
        mgr = StreamingScene(sc, cfg.grid, starting_capacity=256, device=dev)
        sc = mgr.device_scene()
    cam = _camera_for(args)
    sun = ss.sun_direction_from_position(args.sun, dev)
    arrays = camera_arrays_for(cam, sun, args.width, args.height, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    film = pathtrace.film_init(args.width, args.height, dev)
    timer = FrameTimer()
    metrics = MetricsLogger(args.metrics, echo=args.verbose)
    try:
        for s in range(args.spp):
            t0 = time.perf_counter()
            rgb, count, req = pathtrace.render_wave(
                sc, arrays, cam.brick_position, cfg, args.width, args.height,
                generator=gen)
            film = pathtrace.film_add(film, rgb, count)
            traced = int(req["traced_rays"])   # waits for the wave
            dt = time.perf_counter() - t0
            timer.add(dt)
            uploads = 0
            if mgr is not None:
                # The per-frame CPU half of streaming (main.cpp:144 ->
                # Scene::process_load_queue): service this wave's requests;
                # the next wave renders against the new residency.
                got = pull_requests(req, mgr.queue_size)
                if got:
                    uploads = mgr.process_requests(got)
                    sc = mgr.device_scene()
            exhausted = int(req["exhausted_rays"])
            metrics.log(s, wave_s=dt, traced=traced,
                        mrays_s=traced / dt / 1e6, uploads=uploads,
                        exhausted=exhausted)
            if args.verbose:
                extra = f", {uploads} uploads" if mgr is not None else ""
                print(f"wave {s}: {dt * 1000:.0f} ms, {traced} rays, "
                      f"{exhausted} exhausted{extra}", file=sys.stderr)
    finally:
        metrics.close()
    img = pathtrace.tonemap(film, args.width, args.height).cpu().numpy()
    write_png(args.out, img)
    if mgr is not None:
        surf = mgr.surface_stats()
        print(f"streaming: {int(mgr.dump().sum())} bricks resident, "
              f"{mgr.total_uploaded} uploaded, {mgr.total_dropped} dropped",
              file=sys.stderr)
        # The reference's locality invariant (README.md:7): every load is
        # ray-reachable (an air face or a partly filled neighbour).
        print(f"streaming: {surf['loaded_surface']} air-surface + "
              f"{surf['loaded_reachable'] - surf['loaded_surface']} "
              f"behind-partial / {surf['loaded_unreachable']} unreachable "
              f"(world: {surf['surface_total']} surface, "
              f"{surf['reachable_total']} reachable of "
              f"{surf['nonempty_total']} non-empty)", file=sys.stderr)
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


def cmd_inverse(args) -> int:
    """Inverse rendering: fit a dense voxel grid to rendered targets
    (``brickmap_tpu`` cli.py:311-364), or with ``--sparse`` the brick-pool
    fields of a terrain world (:func:`_cmd_inverse_sparse`)."""
    from ..diff.optim import adam_step, make_adam
    from ..diff.render import composite_rays, l2_loss_and_grads

    dev = _device(args)
    if args.sparse:
        return _cmd_inverse_sparse(args, dev)

    rng = np.random.default_rng(args.seed)
    g = args.grid
    # Ground truth: a floating blob of solid voxels with banded albedo.
    occ_true = np.zeros((g, g, g), np.float32)
    c = g // 2
    zz, yy, xx = np.meshgrid(*[np.arange(g)] * 3, indexing="ij")
    occ_true[(zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2 < (g // 3) ** 2] = 1
    alb_true = np.stack([
        0.2 + 0.6 * (zz / g), 0.3 + 0.4 * (yy / g), 0.8 - 0.5 * (xx / g)
    ], -1).astype(np.float32)

    n = args.rays
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([c, c, c]) - dirs * (2.2 * g)).astype(np.float32)

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    origins, dirs = dev_t(origins), dev_t(dirs)
    bg = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    with torch.no_grad():
        target, _, _ = composite_rays(origins, dirs, dev_t(occ_true),
                                      dev_t(alb_true), bg, max_steps=3 * g)

    occ = torch.full((g, g, g), 0.3, device=dev)
    alb = torch.full((g, g, g, 3), 0.5, device=dev)
    opt = make_adam((occ, alb), args.lr)
    t0 = time.perf_counter()
    loss0 = loss = None
    for step in range(args.steps):
        loss, grads = l2_loss_and_grads(origins, dirs, occ, alb, bg, target,
                                        max_steps=3 * g)
        if loss0 is None:
            loss0 = float(loss)
        adam_step(opt, (occ, alb), grads)
        if step % 20 == 0:
            print(f"step {step}: loss {float(loss):.6f}", file=sys.stderr)
    print(json.dumps({
        "steps": args.steps, "loss_first": loss0,
        "loss_final": None if loss is None else float(loss),
        "seconds": time.perf_counter() - t0, "device": str(dev),
    }))
    return 0


def _cmd_inverse_sparse(args, dev) -> int:
    """Inverse rendering over the sparse brick pool (``brickmap_tpu``
    cli.py:367-447): recover per-voxel albedo (and refine occupancy) of a
    terrain world from rendered targets, through segment recording (B3) and
    the bounded-K row replay (B4f/B4b)."""
    from .. import scene as scene_mod
    from ..config import GridConfig
    from ..diff.optim import adam_step, make_adam
    from ..diff.sparse import cell_pool_map, composite_sparse, \
        l2_loss_and_grads_sparse, pool_fields_from_bitmask
    from ..kernels.record import record_segments

    K = 8
    grid = GridConfig(grid_size=args.world, grid_height=args.world_height)
    sc = scene_mod.generate_terrain_scene(grid, device=dev)
    cellmap = cell_pool_map(sc, grid)
    occ_true, _ = pool_fields_from_bitmask(sc)
    print(f"terrain world {args.world}^2x{args.world_height}, "
          f"{occ_true.shape[0]} resident bricks", file=sys.stderr)

    # Ground-truth albedo: height bands over the brick pool's voxels.
    zz, yy, xx = torch.nonzero(cellmap >= 0, as_tuple=True)
    vz = torch.zeros((occ_true.shape[0], 512), dtype=torch.float32,
                     device=dev)
    vz[cellmap[zz, yy, xx].long()] = (
        zz[:, None] * 8 + (torch.arange(512, device=dev) // 64)[None, :]
    ).to(torch.float32) / args.world_height
    alb_true = torch.stack([0.2 + 0.7 * vz, 0.5 + 0.3 * torch.sin(vz * 9.0),
                            0.9 - 0.6 * vz], dim=-1)

    rng = np.random.default_rng(args.seed)
    n = args.rays
    m = float(args.world)
    ox = rng.uniform(0.05 * m, 0.95 * m, n).astype(np.float32)
    oy = rng.uniform(0.05 * m, 0.95 * m, n).astype(np.float32)
    oz = np.full(n, args.world_height - 2.0, np.float32)
    origins = torch.from_numpy(np.stack([ox, oy, oz], 1)).to(dev)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.7
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = torch.from_numpy(dirs).to(dev)
    bg = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    segs = record_segments(origins, dirs, sc, grid, k_segments=K)
    with torch.no_grad():
        target, _ = composite_sparse(segs["o_cells"], dirs, segs, cellmap,
                                     occ_true, alb_true, bg, grid,
                                     k_segments=K)

    occ = occ_true * 0.6    # soft start; recover hardness
    alb = torch.full_like(alb_true, 0.5)
    opt = make_adam((occ, alb), args.lr)
    t0 = time.perf_counter()
    loss0 = loss = None
    seg_cache: dict = {}   # record + sorts are loop-invariant (fixed rays)
    for step in range(args.steps):
        loss, grads = l2_loss_and_grads_sparse(
            origins, dirs, sc, cellmap, occ, alb, bg, target, grid,
            k_segments=K, seg_cache=seg_cache)
        if loss0 is None:
            loss0 = float(loss)
        adam_step(opt, (occ, alb), grads)
        if step % 10 == 0:
            print(f"step {step}: loss {float(loss):.6f}", file=sys.stderr)
    print(json.dumps({
        "mode": "sparse", "world": args.world, "rays": n,
        "bricks": int(occ_true.shape[0]), "steps": args.steps,
        "loss_first": loss0,
        "loss_final": None if loss is None else float(loss),
        "seconds": time.perf_counter() - t0, "device": str(dev),
    }))
    return 0


def cmd_info(args) -> int:
    """The JAX CLI's ``info`` (cli.py:450-462): the saved scene's
    ``scene_summary`` with its keys, without the per-superchunk counts."""
    from .. import scene as scene_mod
    from ..config import GridConfig

    path = args.load or args.path
    if path is None:
        raise CliError("info needs a scene file")
    if not os.path.exists(path):
        raise CliError(f"scene file not found: {path}")
    sc = scene_mod.load_scene(path, _device(args))
    cz, cy, cx = sc.index_volume.shape
    info = scene_mod.scene_summary(sc, GridConfig(grid_size=cx * 8,
                                                  grid_height=cz * 8))
    info.pop("per_superchunk_loaded")
    info.pop("resident_bytes")
    print(json.dumps(info))
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
    pr.add_argument("--metrics", default=None,
                    help="append one JSONL record per wave to this file")
    pr.add_argument("--streaming", action="store_true",
                    help="start with all bricks unloaded and stream residency "
                         "from per-wave requests (reference C6-C8 pipeline)")
    pr.add_argument("--engine", choices=["paged", "xla"], default=None,
                    help="the JAX CLI's traversal choice; no meaning in the "
                         "port and ignored: the traversal is kernel B2 on "
                         "cuda and its plain version on cpu (--device)")
    pr.add_argument("--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="9-viewpoint scripted benchmark")
    common(pb, 1920, 1080, 1024, 256)
    pb.add_argument("--waves", type=int, default=2)
    pb.add_argument("--warmup", type=int, default=1)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("inverse", help="inverse-rendering optimization demo")
    pi.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the plain "
                         "versions of the kernels)")
    pi.add_argument("--grid", type=int, default=24)
    pi.add_argument("--rays", type=int, default=4096)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=0.05)
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--sparse", action="store_true",
                    help="optimize the sparse brick-pool fields of a "
                         "terrain world instead of a dense grid")
    pi.add_argument("--world", type=int, default=256,
                    help="terrain world size for --sparse")
    pi.add_argument("--world-height", type=int, default=128)
    pi.set_defaults(fn=cmd_inverse)

    pn = sub.add_parser("info", help="scene statistics")
    pn.add_argument("path", nargs="?", help="scene .npz (or --load)")
    pn.add_argument("--load", default=None)
    pn.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    pn.set_defaults(fn=cmd_info)

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
