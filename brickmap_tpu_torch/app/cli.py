"""Command-line harness of the port: ``python -m brickmap_tpu_torch <cmd>``.

The subcommands of ``brickmap_tpu/app/cli.py``:

* ``render``  — progressive path-traced render of a terrain world to PNG;
  with ``--streaming`` every brick starts unloaded and each wave's requests
  are serviced before the next (:mod:`brickmap_tpu_torch.stream`);
  ``--turntable`` orbits the camera, ``--serve`` shows the progressive
  frame in a browser with a fly camera (the reference's interactive
  window), ``--profile`` records a ``torch.profiler`` trace.
* ``bench``   — the 9-viewpoint scripted benchmark (performance_measure.cpp).
* ``inverse`` — inverse rendering with Adam: a dense grid, or with
  ``--sparse`` the brick-pool fields of a terrain world.
* ``info``    — residency statistics of a saved scene.
* ``scaling`` — ray-sharded data-parallel scaling efficiency over growing
  ``torch.distributed`` process groups.

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

# The fly-camera step lives with the live frame; re-exported here, where
# the viewer's tests and the JAX package's CLI keep it.
from .live import _apply_camera_input  # noqa: F401


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


def _camera_for(args, position, look):
    from ..render.camera import Camera

    if args.angles:
        h, v = args.angles
        return Camera.from_angles(position, h, v,
                                  focal_distance=args.focal_distance,
                                  lens_radius=args.lens_radius)
    d = np.asarray(look, np.float64) - np.asarray(position, np.float64)
    n = np.linalg.norm(d)
    if n < 1e-9:
        raise CliError("--camera and --look coincide; no view direction")
    return Camera(position=tuple(float(p) for p in position),
                  direction=tuple(d / n),
                  focal_distance=args.focal_distance,
                  lens_radius=args.lens_radius)


def _turntable_camera(args, frame: int):
    """Frame ``frame`` of ``--turntable``: ``--camera`` rotated about the
    vertical axis through ``--look`` by 2 pi frame / N, looking at it."""
    look = np.asarray(args.look, np.float64)
    rel = np.asarray(args.camera, np.float64) - look
    th = 2.0 * np.pi * frame / args.turntable
    rot = np.array([[np.cos(th), -np.sin(th), 0.0],
                    [np.sin(th), np.cos(th), 0.0],
                    [0.0, 0.0, 1.0]])
    return _camera_for(args, tuple(look + rot @ rel), tuple(look))


def _config(args):
    from ..config import BrickmapConfig, GridConfig, RenderConfig

    return BrickmapConfig(
        grid=GridConfig(grid_size=args.world, grid_height=args.world_height),
        render=RenderConfig(width=args.width, height=args.height,
                            max_bounces=args.bounces,
                            max_top_steps=args.max_steps),
        seed=args.seed)


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CliError("no CUDA device; pass --device cpu to run on the CPU")
    return dev


def cmd_render(args) -> int:
    """Progressive render; with --turntable, a scripted camera path whose
    every move resets accumulation (the reference's interactive reset,
    kernel.cu:387-403, driven by waypoints instead of WASD).  With --serve,
    the preview page's WASD/arrow input flies the camera live.  Each wave
    is one :meth:`~brickmap_tpu_torch.app.live.LiveSession.frame`."""
    from ..ops import sunsky as ss
    from ..stream import StreamingScene
    from ..utils.image import write_png
    from ..utils.metrics import FrameTimer, MetricsLogger
    from ..utils.profiling import trace as profile_trace
    from .live import LiveSession

    if args.spp < 1:
        raise CliError("--spp must be >= 1")
    dev = _device(args)
    cfg = _config(args)
    sc = _build_world(args, cfg, dev)
    mgr = None
    if args.streaming:
        # The JAX CLI's starting capacity per superchunk segment.
        sc = mgr = StreamingScene(sc, cfg.grid, starting_capacity=256,
                                  device=dev)
    sun = ss.sun_direction_from_position(args.sun, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)

    server = None
    if args.serve is not None:
        from ..utils.preview import PreviewServer

        server = PreviewServer(args.serve, host=args.serve_host)
        print(f"live preview: http://{args.serve_host}:{server.port}/",
              file=sys.stderr)

    frames = args.turntable if args.turntable else 1

    def scheduled(frame):
        return _turntable_camera(args, frame) if args.turntable \
            else _camera_for(args, args.camera, args.look)

    timer = FrameTimer()
    metrics = MetricsLogger(args.metrics, echo=args.verbose)
    wave_idx = 0
    # Preview fly-camera: once input arrives it overrides the schedule.
    flown = False
    try:
        live = LiveSession(sc, sun, args.width, args.height, cfg, gen,
                           scheduled(0), server=server)
        with profile_trace(args.profile, dev):
            for frame in range(frames):
                if not flown:
                    # Accumulation reset on camera change (kernel.cu:387-403).
                    live.set_camera(scheduled(frame))
                for s in range(args.spp):
                    # Fly-camera input between waves: move the camera and
                    # restart accumulation (the reference applies input per
                    # frame, main.cpp:119-127 + kernel.cu:387-403).
                    deltas = server.pop_camera() if server is not None \
                        else None
                    flown |= deltas is not None
                    preview_now = args.preview_every and \
                        (s + 1) % args.preview_every == 0 and s + 1 < args.spp
                    out = live.frame(deltas,
                                     present=server is not None
                                     or bool(preview_now),
                                     frame=frame, wave=s + 1, spp=args.spp)
                    dt = out.seconds["wave"] + out.seconds["read"]
                    timer.add(dt)
                    metrics.log(wave_idx, wave_s=dt, traced=out.traced,
                                mrays_s=out.traced / dt / 1e6,
                                uploads=out.uploads,
                                exhausted=out.exhausted)
                    if args.verbose:
                        extra = (f", {out.uploads} uploads" if mgr is not None
                                 else "")
                        print(f"frame {frame} wave {s}: {dt * 1000:.0f} ms, "
                              f"{out.traced} rays, {out.exhausted} "
                              f"exhausted{extra}", file=sys.stderr)
                    wave_idx += 1
                    if preview_now:
                        write_png(args.out, out.image)
                img = live.image()
                path = args.out if frames == 1 else \
                    args.out.replace(".png", f"_{frame:03d}.png")
                write_png(path, img)
                if server is not None:
                    server.update(img, frame=frame, wave=args.spp,
                                  spp=args.spp, done=frame + 1 == frames)
    finally:
        metrics.close()
        if server is not None:
            server.close()
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
    # The timer counts timed waves; its "frames" key is not the camera
    # frames.
    stats["waves"] = stats.pop("frames")
    print(json.dumps({"out": args.out, "spp": args.spp, "frames": frames,
                      "device": str(dev), **stats}))
    return 0


def cmd_bench(args) -> int:
    from .benchmark import run_forward_benchmark

    dev = _device(args)
    cfg = _config(args)
    sc = _build_world(args, cfg, dev)
    out = run_forward_benchmark(sc, cfg, waves_per_view=args.waves,
                                warmup_waves=args.warmup,
                                scale=args.world / 4096.0, seed=cfg.seed)
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
    from ..diff.field4 import new_fields
    from ..diff.optim import adam_step, make_adam
    from ..diff.sparse import cell_pool_map, composite_sparse, \
        l2_loss_and_grads_sparse, pool_fields_from_bitmask
    from ..kernels.record import record_segments

    K = 8
    grid = GridConfig(grid_size=args.world, grid_height=args.world_height)
    sc = scene_mod.generate_terrain_scene(grid, device=dev)
    cellmap = cell_pool_map(sc, grid)
    occ_true, alb_true = pool_fields_from_bitmask(sc)
    print(f"terrain world {args.world}^2x{args.world_height}, "
          f"{occ_true.shape[0]} resident bricks", file=sys.stderr)

    # Ground-truth albedo: height bands over the brick pool's voxels.
    zz, yy, xx = torch.nonzero(cellmap >= 0, as_tuple=True)
    vz = torch.zeros((occ_true.shape[0], 512), dtype=torch.float32,
                     device=dev)
    vz[cellmap[zz, yy, xx].long()] = (
        zz[:, None] * 8 + (torch.arange(512, device=dev) // 64)[None, :]
    ).to(torch.float32) / args.world_height
    alb_true.copy_(torch.stack([0.2 + 0.7 * vz,
                                0.5 + 0.3 * torch.sin(vz * 9.0),
                                0.9 - 0.6 * vz], dim=-1))

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

    occ, alb = new_fields(occ_true.shape[0], dev)
    occ.copy_(occ_true).mul_(0.6)    # soft start; recover hardness
    alb.fill_(0.5)
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


def cmd_scaling(args) -> int:
    """Ray-sharded data-parallel scaling efficiency (JAX ``cmd_scaling``):
    forward waves + sparse inverse steps on growing process groups.  With
    --distributed this process joins the world of --num-processes at
    --coordinator; without, the world is this one process."""
    import torch.distributed as dist

    from .scaling import init_distributed, init_single_process, \
        run_scaling_benchmark

    dev = _device(args)
    if args.distributed:
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, dev)
    else:
        init_single_process(dev)
    try:
        cfg = _config(args)
        sc = _build_world(args, cfg, dev)
        counts = [int(c) for c in args.devices.split(",")] if args.devices \
            else None
        out = run_scaling_benchmark(
            sc, cfg, args.width, args.height, device_counts=counts,
            waves=args.waves, inverse_rays=args.inverse_rays,
            skip_inverse=args.skip_inverse, seed=cfg.seed)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
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
    pr.add_argument("--profile", default=None,
                    help="record a torch.profiler trace into this directory "
                         "(open with tensorboard --logdir or Perfetto)")
    pr.add_argument("--streaming", action="store_true",
                    help="start with all bricks unloaded and stream residency "
                         "from per-wave requests (reference C6-C8 pipeline)")
    pr.add_argument("--engine", choices=["paged", "xla"], default=None,
                    help="the JAX CLI's traversal choice; no meaning in the "
                         "port and ignored: the traversal is kernel B2 on "
                         "cuda and its plain version on cpu (--device)")
    pr.add_argument("--preview-every", type=int, default=0,
                    help="write the progressive image to --out every N waves")
    pr.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live progressive preview + stats over HTTP "
                         "on PORT (the reference's interactive window, "
                         "main.cpp:26-190, as a browser view with WASD fly-"
                         "camera input; 0 = any port)")
    pr.add_argument("--serve-host", default="127.0.0.1",
                    help="bind address for --serve (default loopback only; "
                         "set 0.0.0.0 to expose externally)")
    pr.add_argument("--turntable", type=int, default=0,
                    help="render N frames orbiting --look (accumulation "
                         "resets per camera move); frames saved as "
                         "out_###.png")
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

    ps = sub.add_parser(
        "scaling", help="data-parallel scaling-efficiency benchmark over "
        "1/2/4/.../W-rank process groups")
    common(ps, 512, 288, 512, 128)
    ps.add_argument("--waves", type=int, default=2)
    ps.add_argument("--devices", default=None,
                    help="comma-separated rank counts (default 1,2,4,..,W)")
    ps.add_argument("--inverse-rays", type=int, default=65536)
    ps.add_argument("--skip-inverse", action="store_true")
    ps.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed world of --num-processes "
                         "(NCCL on cuda, gloo on cpu)")
    ps.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 for --distributed (default: "
                         "the env:// variables)")
    ps.add_argument("--num-processes", type=int, default=None)
    ps.add_argument("--process-id", type=int, default=None)
    ps.set_defaults(fn=cmd_scaling)

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
