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
:func:`~brickmap_tpu_torch.ops.traverse.trace_clipped_rays`).
``trace.launches`` counts the kernel's launches through either; ``trace.
events`` is the event hook of :mod:`brickmap_tpu_torch.kernels`.
:func:`launch_inputs` and :func:`launch_args` build a launcher's inputs and
ctypes arguments (``notes/probe_torch_b2.py`` and the host rehearsal of
``csrc/traverse.cu`` share them).

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

__all__ = ["trace", "trace_clipped", "launch_inputs", "launch_args"]

_F32, _I32 = torch.float32, torch.int32
_KEYS = ("hit", "t", "normal", "request", "request_pos", "exhausted",
         "resume_t", "ray_iters", "iters")


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.traverse_launch.argtypes = (
        [i, p, p, p, p, p, p, p, p]          # n, rays, scene
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


def launch_args(inputs, words: torch.Tensor, scene, cam, grid: GridConfig,
                max_steps: int, out: dict, stream) -> tuple:
    """``traverse_launch``'s arguments: ``inputs`` and ``out`` from
    :func:`launch_inputs`, the index words as the kernel reads them (the
    scene's ``index_volume``; a probe's build may read another layout of
    the same words), the scene's pool and bases, then the grid, camera,
    LoD, brick, epsilon and budget, the outputs and the stream."""
    return (out["hit"].shape[0], *(a.data_ptr() for a in inputs),
            words.data_ptr(), scene.pool_words.data_ptr(),
            scene.pool_base.data_ptr(), grid.cells, grid.cells,
            grid.cells_height, grid.supergrid_cell_size, grid.supergrid_xy,
            grid.num_superchunks, *(int(c) for c in cam),
            grid.lod_distance_8, grid.lod_distance_2, grid.brick_size,
            grid.epsilon, max_steps,
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
    _check_scene(scene, grid, dev)
    inputs, out = launch_inputs(origins, dirs, grid)
    n = origins.shape[0]
    _launch(inputs, scene, cam, grid, max_steps, out)
    out["iters"] = out["ray_iters"].amax() if n else torch.zeros(
        (), dtype=_I32, device=dev)
    return out


def trace_clipped(inputs, scene, cam_brick, grid: GridConfig,
                  max_steps: int) -> dict:
    """:func:`trace` of rays already clipped to the world box: ``inputs``
    are the launcher's five (clipped origins, directions, entry normals,
    tmin, ok; kernel W2's outputs).  Returns every key of :func:`trace`
    but ``iters``."""
    dev = inputs[0].device
    cam = tuple(int(c) for c in cam_brick)
    if dev.type == "cpu":
        res = trace_clipped_rays(*inputs, scene.index_volume,
                                 scene.pool_words, scene.pool_base, cam,
                                 grid, max_iters=max_steps)
        return {k: res[k] for k in _KEYS[:-1]}
    _check_scene(scene, grid, dev)
    n = inputs[0].shape[0]
    if n > build.MAX_RAYS:
        raise ValueError(f"at most {build.MAX_RAYS} rays a launch")
    dtypes = (_F32,) * 4 + (torch.bool,)
    shapes = ((n, 3),) * 3 + ((n,),) * 2
    for a, dtype, shape in zip(inputs, dtypes, shapes):
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"trace_clipped: inputs must be contiguous "
                             f"float32 [N, 3] x 3, [N], bool [N] on {dev}")
    out = _outputs(n, dev)
    _launch(inputs, scene, cam, grid, max_steps, out)
    return out


def _check_scene(scene, grid: GridConfig, dev) -> None:
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
            out: dict) -> None:
    """Launch B2 over ``inputs`` into ``out`` (no launch for 0 rays)."""
    if not inputs[0].shape[0]:
        return
    dev = inputs[0].device
    lib = build.load("traverse", _bind)
    with torch.cuda.device(dev):
        status = hooked(trace, lib.traverse_launch, *launch_args(
            inputs, scene.index_volume, scene, cam, grid, max_steps, out,
            torch.cuda.current_stream(dev).cuda_stream))
    build.check(status, "traverse_kernel")
    trace.launches += 1


trace.launches = 0
trace.events = None

