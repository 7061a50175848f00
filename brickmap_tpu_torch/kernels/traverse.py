"""Kernel B2: the hierarchical traversal behind :func:`trace`.

The port of ``brickmap_tpu/pallas/traverse3.py::trace_rays_paged`` (:868).
:func:`trace` clips the rays to the world box with the torch
:func:`~brickmap_tpu_torch.ops.traverse.aabb_clip`, then launches the CUDA
kernel ``csrc/traverse.cu`` (one thread per ray) for rays on the card.  For
rays on the CPU it runs the plain version
:func:`brickmap_tpu_torch.ops.traverse.trace_rays`; on any other device it
raises.  :func:`trace_clipped` launches the same kernel on rays already
clipped (the sample wave's, clipped by kernel W2 of
:mod:`brickmap_tpu_torch.kernels.wave`; plain version
:func:`~brickmap_tpu_torch.ops.traverse.trace_clipped_rays`), whose
count the kernel reads on the device.  ``trace.launches`` counts the
kernel's launches through either; ``trace.events`` is the event hook of
:mod:`brickmap_tpu_torch.kernels`.
:func:`launch_inputs` and :func:`launch_args` build a launcher's inputs and
ctypes arguments (``notes/probe_torch_b2.py`` and the host rehearsal of
``csrc/traverse.cu`` share them); :func:`walk_args` the walk's own, which
the wave's rescue kernel W4 takes too, as it does the checks
:func:`check_scene` and :func:`check_count`.

The result is the ``trace_rays_paged`` contract (traverse3.py:938-947):
``hit``, ``t``, ``normal``, ``request``, ``request_pos``, ``exhausted``,
``resume_t`` and ``iters`` (the most DDA steps any ray took), plus the
per-ray step count ``ray_iters``.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import GridConfig
from ..ops.traverse import aabb_clip, trace_clipped_rays, trace_rays
from . import build, hooked

__all__ = ["trace", "trace_clipped", "launch_inputs", "launch_args",
           "walk_args", "check_count", "check_scene"]

_F32, _I32 = torch.float32, torch.int32
_KEYS = ("hit", "t", "normal", "request", "request_pos", "exhausted",
         "resume_t", "ray_iters", "iters")


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.traverse_launch.argtypes = (
        [i, p, p, p, p, p, p, p, p, p]       # capacity, count, rays, scene
        + [i] * 12 + [f, i]                  # grid, camera, LoD, brick, eps..
        + [p] * 8 + [p])                     # outputs, stream
    lib.traverse_launch.restype = i


def launch_inputs(origins: torch.Tensor, dirs: torch.Tensor,
                  grid: GridConfig):
    """The launcher's per-ray inputs (the rays clipped to the world box,
    contiguous: clipped origins, directions, entry normals, tmin, ok) and
    its outputs, allocated on the rays' device: ``(inputs, out)``."""
    dev = origins.device
    n = origins.shape[0]
    if n > build.MAX_RAYS:
        raise ValueError(f"at most {build.MAX_RAYS} rays a launch")
    for name, a in (("origins", origins), ("dirs", dirs)):
        if a.dtype != _F32 or a.shape != (n, 3) or a.device != dev:
            raise ValueError(f"{name} must be float32 [N, 3] on {dev}")
    ok, tminn, clipped, entry_normal = aabb_clip(origins, dirs, grid)
    inputs = tuple(a.contiguous() for a in (clipped, dirs, entry_normal,
                                            tminn, ok))
    return inputs, _outputs(n, dev)


def _outputs(n: int, dev) -> dict:
    def empty(*shape, dtype=_F32):
        return torch.empty(shape, dtype=dtype, device=dev)

    return {
        "hit": empty(n, dtype=torch.bool), "t": empty(n),
        "normal": empty(n, 3), "request": empty(n, dtype=torch.bool),
        "request_pos": empty(n, 3, dtype=_I32),
        "exhausted": empty(n, dtype=torch.bool), "resume_t": empty(n),
        "ray_iters": empty(n, dtype=_I32),
    }


def walk_args(words: torch.Tensor, scene, cam, grid: GridConfig,
              max_steps: int) -> tuple:
    """The walk's launcher arguments: the index words as the kernel reads
    them (the scene's ``index_volume``; a probe's build may read another
    layout of the same words), the scene's pool and bases, then the grid,
    camera, LoD, brick, epsilon and budget."""
    return (words.data_ptr(), scene.pool_words.data_ptr(),
            scene.pool_base.data_ptr(), grid.cells, grid.cells,
            grid.cells_height, grid.supergrid_cell_size, grid.supergrid_xy,
            grid.num_superchunks, *(int(c) for c in cam),
            grid.lod_distance_8, grid.lod_distance_2, grid.brick_size,
            grid.epsilon, max_steps)


def launch_args(inputs, words: torch.Tensor, scene, cam, grid: GridConfig,
                max_steps: int, out: dict, stream, count) -> tuple:
    """``traverse_launch``'s arguments: the capacity (``inputs``' rows) and
    ``count`` (an int32 [1] tensor on the rays' device: the rays to trace
    are the first ``count`` rows), ``inputs`` and ``out`` from
    :func:`launch_inputs`, :func:`walk_args`, the outputs and the
    stream."""
    return (out["hit"].shape[0], count.data_ptr(),
            *(a.data_ptr() for a in inputs),
            *walk_args(words, scene, cam, grid, max_steps),
            *(out[k].data_ptr() for k in _KEYS[:-1]), stream)


def trace(origins: torch.Tensor, dirs: torch.Tensor, scene, cam_brick,
          grid: GridConfig, max_steps: int) -> dict:
    """Trace [N, 3] float32 world-space rays through ``scene`` (a
    :class:`~brickmap_tpu_torch.scene.TorchScene` on the rays' device).

    ``cam_brick``: 3 ints, the camera position in bricks (LoD origin).
    ``max_steps``: DDA steps per ray shared by the three levels; a ray still
    going after that many is ``exhausted`` with its ``resume_t``.
    """
    dev = origins.device
    cam = tuple(int(c) for c in cam_brick)
    if dev.type == "cpu":
        res = trace_rays(origins, dirs, scene.index_volume, scene.pool_words,
                         scene.pool_base, cam, grid, max_iters=max_steps)
        return {k: res[k] for k in _KEYS}
    check_scene(scene, grid, dev)
    inputs, out = launch_inputs(origins, dirs, grid)
    n = origins.shape[0]
    _launch(inputs, scene, cam, grid, max_steps, out,
            torch.full((1,), n, dtype=_I32, device=dev))
    out["iters"] = out["ray_iters"].amax() if n else torch.zeros(
        (), dtype=_I32, device=dev)
    return out


def trace_clipped(inputs, count, scene, cam_brick, grid: GridConfig,
                  max_steps: int) -> dict:
    """:func:`trace` of rays already clipped to the world box: ``inputs``
    are the launcher's five (clipped origins, directions, entry normals,
    tmin, ok; kernel W2's outputs) over a capacity of rows, of which the
    first ``count`` (int32 [1] on the rays' device, W0's) are traced; the
    kernel reads the count there, so the call makes no host round trip.
    Returns every key of :func:`trace` but ``iters``, over the capacity:
    rows at or past the count are left as they were allocated."""
    dev = inputs[0].device
    cam = tuple(int(c) for c in cam_brick)
    cap = inputs[0].shape[0]
    if dev.type == "cpu":
        m = int(count)
        res = trace_clipped_rays(*(a[:m] for a in inputs), scene.index_volume,
                                 scene.pool_words, scene.pool_base, cam,
                                 grid, max_iters=max_steps)
        out = _outputs(cap, dev)
        for k in _KEYS[:-1]:
            out[k][:m] = res[k]
        return out
    check_scene(scene, grid, dev)
    if cap > build.MAX_RAYS:
        raise ValueError(f"at most {build.MAX_RAYS} rays a launch")
    dtypes = (_F32,) * 4 + (torch.bool,)
    shapes = ((cap, 3),) * 3 + ((cap,),) * 2
    for a, dtype, shape in zip(inputs, dtypes, shapes):
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"trace_clipped: inputs must be contiguous "
                             f"float32 [N, 3] x 3, [N], bool [N] on {dev}")
    check_count(count, dev, "trace_clipped")
    out = _outputs(cap, dev)
    _launch(inputs, scene, cam, grid, max_steps, out, count)
    return out


def check_count(count, dev, name: str) -> None:
    """A device-side count: a contiguous int32 [1] tensor on ``dev``."""
    if count.device != dev or count.dtype != _I32 \
            or tuple(count.shape) != (1,):
        raise ValueError(f"{name}: count must be an int32 [1] tensor on "
                         f"{dev}")


def check_scene(scene, grid: GridConfig, dev) -> None:
    """A scene the walk can read on ``dev``: contiguous int32 arrays on the
    card, the index volume the grid's shape (B2's and W4's wrappers)."""
    if dev.type != "cuda":
        raise ValueError(f"trace: unsupported device {dev}")
    for name, a in (("index_volume", scene.index_volume),
                    ("pool_words", scene.pool_words),
                    ("pool_base", scene.pool_base)):
        if a.dtype != _I32 or a.device != dev or not a.is_contiguous():
            raise ValueError(f"scene.{name} must be contiguous int32 on {dev}")
    if tuple(scene.index_volume.shape) != (grid.cells_height, grid.cells,
                                           grid.cells):
        raise ValueError("scene.index_volume does not match the grid")


def _launch(inputs, scene, cam, grid: GridConfig, max_steps: int,
            out: dict, count) -> None:
    """Launch B2 over ``inputs`` into ``out`` (no launch for 0 rows)."""
    if not inputs[0].shape[0]:
        return
    dev = inputs[0].device
    lib = build.load("traverse", _bind)
    with torch.cuda.device(dev):
        status = hooked(trace, lib.traverse_launch, *launch_args(
            inputs, scene.index_volume, scene, cam, grid, max_steps, out,
            torch.cuda.current_stream(dev).cuda_stream, count))
    build.check(status, "traverse_kernel")
    trace.launches += 1


trace.launches = 0
trace.events = None

