"""Scaling-efficiency harness: ray-sharded data parallelism over growing
process groups (the port of ``brickmap_tpu/app/scaling.py``).

* **forward**: :func:`brickmap_tpu_torch.parallel.render.render_wave_sharded`
  sample waves on the first 1/2/4/.../W ranks of the world;
* **inverse**: :func:`...inverse_train_step_sparse` gradient steps (B3
  record, B4f/B4b replay per shard, gradients averaged over the group).

Efficiency_d = (rays_s[d] / rays_s[1]) / d.  One process per card under
NCCL, or CPU processes under gloo (numbers meaningless there, the plumbing
is what is held); without ``--distributed`` the world is this one process.
"""

from __future__ import annotations

import math
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_distributed", "init_single_process", "run_scaling_benchmark"]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda") -> None:
    """``dist.init_process_group`` over ``tcp://<coordinator>`` (host:port)
    with this world size and rank; without a coordinator, from the
    environment (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as
    ``torchrun`` sets them).  NCCL for a CUDA ``device`` (each rank then
    uses card ``rank % cards``), gloo for the CPU."""
    card = None
    if torch.device(device).type == "cuda":
        rank = int(os.environ.get("RANK", 0)) if process_id is None \
            else process_id
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
    dist.init_process_group(
        "gloo" if card is None else "nccl",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, device_id=card)


def init_single_process(device="cuda") -> None:
    """A world of this one process, on a free local port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device)


def _device_counts(max_devices: int) -> list[int]:
    d, counts = 1, []
    while d <= max_devices:
        counts.append(d)
        d *= 2
    if counts[-1] != max_devices:
        counts.append(max_devices)
    return counts


def run_scaling_benchmark(sc, cfg, width: int, height: int,
                          device_counts: list[int] | None = None,
                          waves: int = 2, inverse_rays: int = 65536,
                          k_segments: int = 8, skip_inverse: bool = False,
                          seed: int = 0, verbose: bool = True) -> dict:
    """Measure forward and sparse-inverse rays/s on growing process groups.

    Every rank of the initialised world calls it with the same ``sc`` (a
    :class:`~brickmap_tpu_torch.scene.TorchScene`).  Device counts are
    capped at the world size; ranks outside a group wait at a barrier.
    Returns, on every rank, a dict with per-count rays/s and efficiency
    percentages (rank 0's clocks).
    """
    from ..diff.field4 import field4_of, field4_views
    from ..diff.sparse import cell_pool_map, pool_fields_from_bitmask
    from ..ops import sunsky as ss
    from ..parallel.render import (inverse_train_step_sparse, make_mesh,
                                   render_wave_sharded, replicate,
                                   shard_rays)
    from ..render.camera import Camera, camera_arrays_for
    from .benchmark import SUN_POSITION, TEST_ANGLES, TEST_POSITIONS, \
        device_name

    world = dist.get_world_size()
    if device_counts is None:
        device_counts = _device_counts(world)
    device_counts = [d for d in device_counts if d <= world]

    grid = cfg.grid
    scale = grid.grid_size / 4096.0
    cam = Camera.from_angles(
        tuple(p * scale for p in TEST_POSITIONS[0]), *TEST_ANGLES[0])

    inv_inputs = None
    if not skip_inverse:
        # The fields travel as their field4, so that they stay its views
        # on every rank's device.
        fields = (cell_pool_map(sc, grid),
                  field4_of(*pool_fields_from_bitmask(sc)))
        rng = np.random.default_rng(0)
        # Divisible by every device count.
        n = inverse_rays - inverse_rays % math.lcm(*device_counts)
        m = float(grid.grid_size)
        ox = rng.uniform(0.05 * m, 0.95 * m, n).astype(np.float32)
        oy = rng.uniform(0.05 * m, 0.95 * m, n).astype(np.float32)
        oz = np.full(n, grid.grid_height - 2.0, np.float32)
        dirs = rng.normal(size=(n, 3)).astype(np.float32)
        dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        rays = tuple(torch.from_numpy(a) for a in (
            np.stack([ox, oy, oz], 1), dirs, np.zeros((n, 3), np.float32),
            np.full((n, 3), 0.4, np.float32)))
        inv_inputs = (rays, fields)

    rows = []
    for d in device_counts:
        mesh = make_mesh(d)
        if not mesh.member:
            dist.barrier()
            continue
        dev = mesh.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        scene = replicate(mesh, sc)
        sun = ss.sun_direction_from_position(SUN_POSITION, dev)
        arrays = camera_arrays_for(cam, sun, width, height, dev)
        gen = torch.Generator(device=dev)
        row = {"devices": d}

        def wave(i):
            gen.manual_seed(seed * 1_000_003 + 1000 * i + mesh.rank)
            return render_wave_sharded(mesh, scene, arrays,
                                       cam.brick_position, cfg, width,
                                       height, generator=gen)

        wave(waves)   # warm-up
        sync()
        rays_traced = 0
        t0 = time.perf_counter()
        for i in range(waves):
            rays_traced += int(wave(i)[2]["traced_rays"])
        sync()
        row["forward_rays_per_s"] = rays_traced / (time.perf_counter() - t0)

        if inv_inputs is not None:
            o_s, d_s, bg_s, tgt_s = shard_rays(mesh, inv_inputs[0])
            cm, field4 = replicate(mesh, inv_inputs[1])
            occ, alb = field4_views(field4)

            def step():
                return inverse_train_step_sparse(
                    mesh, o_s, d_s, scene, cm, occ, alb, bg_s, tgt_s, grid,
                    k_segments=k_segments)

            step()   # warm-up
            sync()
            t0 = time.perf_counter()
            for _ in range(waves):
                step()
            sync()
            row["inverse_rays_per_s"] = \
                waves * inv_inputs[0][0].shape[0] / (time.perf_counter() - t0)

        rows.append(row)
        if verbose and mesh.rank == 0:
            print(f"devices {d}: " + "  ".join(
                f"{k} {v:,.0f}" for k, v in row.items() if k != "devices"),
                file=sys.stderr)
        dist.barrier()

    # Rank 0 is in every group: its rows are the result on every rank.
    box = [None]
    if dist.get_rank() == 0:
        base = rows[0]
        for row in rows:
            for k in ("forward_rays_per_s", "inverse_rays_per_s"):
                if k in row:
                    row[k.replace("rays_per_s", "efficiency_pct")] = round(
                        100.0 * (row[k] / base[k]) / row["devices"], 1)
        box[0] = {
            "device_counts": device_counts,
            "rows": rows,
            "resolution": [width, height],
            "inverse_rays": 0 if skip_inverse else inv_inputs[0][0].shape[0],
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "device": device_name(dev),
            "num_processes": world,
        }
    dist.broadcast_object_list(box, src=0)
    return box[0]
