"""Kernel B3: the segment recorder behind :func:`record_segments`.

The port of ``brickmap_tpu/pallas/record.py::record_segments`` (:353).
:func:`record_segments` clips the rays to the world box with the torch
:func:`~brickmap_tpu_torch.ops.traverse.aabb_clip`, then launches the CUDA
kernel ``csrc/record.cu`` (one thread per ray, keeping its K segments in
shared memory and writing its rows whole) for rays on the card.  For rays
on the CPU it runs the plain version
:func:`brickmap_tpu_torch.ops.record.record_segments_plain`; on any other
device it raises.  ``record_segments.launches`` counts kernel launches;
``record_segments.events`` is the event hook of
:mod:`brickmap_tpu_torch.kernels`.

The result is the JAX contract (record.py:360-372): ``cells``, ``nd``,
``ncode``, ``count``, ``tminn``, ``entry_normal``, ``o_cells``,
``exhausted`` and, with ``with_slots``, ``slot``.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import GridConfig
from ..ops.record import DEFAULT_MAX_STEPS, record_segments_plain
from ..ops.traverse import aabb_clip
from . import build, hooked

__all__ = ["record_segments", "max_segments", "MAX_CELLS"]

_F32, _I32 = torch.float32, torch.int32
_KEYS = ("cells", "nd", "ncode", "count", "tminn", "entry_normal", "o_cells",
         "exhausted")
MAX_CELLS = 1024  # cells an axis that the packed x | y << 10 | z << 20 holds


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.record_launch.argtypes = (
        [i, i, p, p, p, p, p]                # n, K, rays, scene
        + [i] * 6                            # grid, budget
        + [p] * 6 + [p])                     # outputs, stream
    lib.record_launch.restype = i


def max_segments() -> int:
    """The most segments a ray can keep: a block's 128 x K x 8-byte slots
    must fit the shared memory a block can use on sm_90 (227 KB)."""
    return 232_448 // (128 * 8)


def record_segments(origin: torch.Tensor, direction: torch.Tensor, scene,
                    grid: GridConfig, k_segments: int = 16,
                    max_steps: int = DEFAULT_MAX_STEPS,
                    with_slots: bool = False) -> dict:
    """Record each ray's first ``k_segments`` occupied cells front to back.

    ``origin``, ``direction``: float32 [N, 3] world-space rays; ``scene``: a
    :class:`~brickmap_tpu_torch.scene.TorchScene` on their device.
    ``max_steps``: top-level DDA steps per ray; a ray still going after that
    many is ``exhausted``.  The grid may have at most :data:`MAX_CELLS`
    cells an axis, on any device: a packed cell has 10 bits an axis.
    """
    if max(grid.cells, grid.cells_height) > MAX_CELLS:
        raise ValueError(f"a packed cell holds at most {MAX_CELLS} cells an "
                         f"axis; the grid has {grid.cells} x {grid.cells} x "
                         f"{grid.cells_height}")
    dev = origin.device
    keys = _KEYS + (("slot",) if with_slots else ())
    if dev.type == "cpu":
        res = record_segments_plain(origin, direction, scene, grid,
                                    k_segments=k_segments,
                                    max_steps=max_steps,
                                    with_slots=with_slots)
        return {k: res[k] for k in keys}
    if dev.type != "cuda":
        raise ValueError(f"record_segments: unsupported device {dev}")
    n = origin.shape[0]
    if not 1 <= k_segments <= max_segments():
        raise ValueError(f"k_segments must be in [1, {max_segments()}]")
    if n > build.MAX_RAYS:
        raise ValueError(f"at most {build.MAX_RAYS} rays a launch")
    for name, a in (("origin", origin), ("direction", direction)):
        if a.dtype != _F32 or a.shape != (n, 3) or a.device != dev:
            raise ValueError(f"{name} must be float32 [N, 3] on {dev}")
    for name, a in (("index_volume", scene.index_volume),
                    ("pool_base", scene.pool_base)):
        if a.dtype != _I32 or a.device != dev or not a.is_contiguous():
            raise ValueError(f"scene.{name} must be contiguous int32 on {dev}")
    if tuple(scene.index_volume.shape) != (grid.cells_height, grid.cells,
                                           grid.cells):
        raise ValueError("scene.index_volume does not match the grid")

    ok, tminn, clipped, entry_normal = aabb_clip(origin, direction, grid)
    o_cells = (clipped / float(grid.brick_size)).contiguous()
    d = direction.contiguous()
    ok = ok.contiguous()

    K = k_segments
    out = {
        "cells": torch.empty((n, K), dtype=_I32, device=dev),
        "nd": torch.empty((n, K), dtype=_F32, device=dev),
        "ncode": torch.empty((n, K), dtype=_I32, device=dev),
        "slot": torch.empty((n, K) if with_slots else (0,), dtype=_I32,
                            device=dev),
        "count": torch.empty(n, dtype=_I32, device=dev),
        "exhausted": torch.empty(n, dtype=torch.bool, device=dev),
    }
    if n:
        lib = build.load("record", _bind)
        with torch.cuda.device(dev):
            status = hooked(
                record_segments, lib.record_launch, n, K, o_cells.data_ptr(), d.data_ptr(), ok.data_ptr(),
                scene.index_volume.data_ptr(), scene.pool_base.data_ptr(),
                grid.cells, grid.cells, grid.cells_height,
                grid.supergrid_cell_size, grid.supergrid_xy, max_steps,
                out["cells"].data_ptr(), out["nd"].data_ptr(),
                out["ncode"].data_ptr(),
                out["slot"].data_ptr() if with_slots else None,
                out["count"].data_ptr(), out["exhausted"].data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(status, "record_kernel")
        record_segments.launches += 1
    out.update(tminn=tminn, entry_normal=entry_normal, o_cells=o_cells)
    return {k: out[k] for k in keys}


record_segments.launches = 0
record_segments.events = None
