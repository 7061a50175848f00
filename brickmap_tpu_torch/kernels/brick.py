"""Kernel B1: every ray against one 8x8x8 brick (BASELINE config 1).

The port of ``brickmap_tpu/pallas/brick.py``.  :func:`trace_single_brick`
launches the CUDA kernel ``csrc/brick.cu`` for rays on the card and runs the
plain torch version :func:`intersect_brick_plain` for rays on the CPU; on any
other device it raises.  ``trace_single_brick.launches`` counts kernel
launches.  :func:`prepared_launch` gives the launch alone, for timing, and
:func:`rcp_mismatches` checks the kernel's reciprocal against IEEE
division.

Semantics are those of ``dda_ref.intersect_brick`` (reference
voxel.cuh:79-133): per ray, at most 22 DDA steps (3*8 - 2) through the
brick's 512 occupancy bits; outputs ``hit``, local ``t`` (0 for a hit in the
entry cell) and the step ``axis`` of the hit face (-1 for the entry cell).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.traverse import BIG
from . import build

__all__ = ["trace_single_brick", "intersect_brick_plain", "prepared_launch",
           "rcp_mismatches", "MAX_STEPS"]

MAX_STEPS = 22  # 3*8 - 2: worst-case voxel visits crossing an 8^3 brick

_F32, _I32 = torch.float32, torch.int32


def _as_words(words, device) -> torch.Tensor:
    """16 occupancy words as an int32 tensor on ``device``."""
    if isinstance(words, np.ndarray):
        words = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    words = words.to(device=device)
    if words.dtype != _I32 or words.numel() != 16:
        raise ValueError("brick words must be 16 int32 bit patterns")
    return words.reshape(16).contiguous()


def intersect_brick_plain(words: torch.Tensor, origins: torch.Tensor,
                          dirs: torch.Tensor):
    """Plain torch version of kernel B1 (the JAX kernel's fixed 22-step,
    lane-masked loop).  Returns (hit bool, t f32, axis int32, steps int32),
    each [N]; ``steps`` counts the occupancy tests each ray made."""
    n = origins.shape[0]
    dev = origins.device
    act = torch.ones(n, dtype=torch.bool, device=dev)

    def setup(o, d):
        p = torch.trunc(o).to(_I32)  # C truncation (origins may sit epsilon
        # outside [0, 8) after the entry nudge)
        stepf = torch.sign(d)
        rd = torch.where(d == 0.0, 0.0, 1.0 / d)
        cb = torch.where(d > 0, p.to(_F32) + 1.0, p.to(_F32))
        t = torch.where(d != 0.0, (cb - o) * rd, BIG)
        pl = torch.where(p >= 0, p % 8, -((-p) % 8))   # C trunc-mod
        return pl, stepf.to(_I32), t, stepf * rd, torch.where(d > 0, 8, -1)

    px, sx, tx, tdx, outx = setup(origins[:, 0], dirs[:, 0])
    py, sy, ty, tdy, outy = setup(origins[:, 1], dirs[:, 1])
    pz, sz, tz, tdz, outz = setup(origins[:, 2], dirs[:, 2])

    axis = torch.full((n,), -1, dtype=_I32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    thit = torch.zeros(n, dtype=_F32, device=dev)
    haxis = axis.clone()
    steps = torch.zeros(n, dtype=_I32, device=dev)
    for _ in range(MAX_STEPS):
        steps += act.to(_I32)
        lin = px + py * 8 + pz * 64
        lin = torch.where((lin >= 0) & (lin < 512), lin, 0)
        word = words[(lin >> 5).long()]
        occ = ((word >> (lin & 31)) & 1) != 0

        new_hit = act & occ
        entered = axis >= 0
        t_ax = torch.where(axis == 0, tx, torch.where(axis == 1, ty, tz))
        td_ax = torch.where(axis == 0, tdx, torch.where(axis == 1, tdy, tdz))
        thit = torch.where(new_hit, torch.where(entered, t_ax - td_ax, 0.0),
                           thit)
        haxis = torch.where(new_hit, axis, haxis)
        hit = hit | new_hit
        act = act & ~occ

        # Step (voxel.cuh:122-130): x iff strictly smallest, y iff <=x and <z.
        ax = torch.where(tx < ty, torch.where(tx < tz, 0, 2),
                         torch.where(ty < tz, 1, 2)).to(_I32)
        pxn = px + torch.where(ax == 0, sx, 0)
        pyn = py + torch.where(ax == 1, sy, 0)
        pzn = pz + torch.where(ax == 2, sz, 0)
        exited = (torch.where(ax == 0, pxn, torch.where(ax == 1, pyn, pzn))
                  == torch.where(ax == 0, outx,
                                 torch.where(ax == 1, outy, outz)))
        txn = tx + torch.where(ax == 0, tdx, 0.0)
        tyn = ty + torch.where(ax == 1, tdy, 0.0)
        tzn = tz + torch.where(ax == 2, tdz, 0.0)
        px = torch.where(act, pxn, px)
        py = torch.where(act, pyn, py)
        pz = torch.where(act, pzn, pz)
        tx = torch.where(act, txn, tx)
        ty = torch.where(act, tyn, ty)
        tz = torch.where(act, tzn, tz)
        axis = torch.where(act, ax, axis)
        act = act & ~exited
    return hit, thit, haxis, steps


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.brick_launch.argtypes = [p, p, p, i, p, p, p, p]
    lib.brick_launch.restype = i
    lib.brick_rcp_mismatches.argtypes = [p, p]
    lib.brick_rcp_mismatches.restype = i


def _check_rays(origins: torch.Tensor, directions: torch.Tensor):
    """The rays as contiguous float32 [N, 3] on one CUDA device."""
    dev, n = origins.device, origins.shape[0]
    for name, a in (("origins", origins), ("directions", directions)):
        if a.dtype != _F32 or a.shape != (n, 3) or a.device != dev:
            raise ValueError(f"{name} must be float32 [N, 3] on {dev}")
    return origins.contiguous(), directions.contiguous()


def _launch(lib, words, o, d, hit, t, axis) -> None:
    with torch.cuda.device(o.device):
        status = lib.brick_launch(
            words.data_ptr(), o.data_ptr(), d.data_ptr(), o.shape[0],
            hit.data_ptr(), t.data_ptr(), axis.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    build.check(status, "brick_kernel")


def trace_single_brick(origins: torch.Tensor, directions: torch.Tensor,
                       words) -> dict:
    """DDA every ray ([N, 3] brick-local voxel origins and directions)
    against one brick's 16 words.  Returns dict(hit bool [N], t f32 [N],
    axis int32 [N])."""
    dev = origins.device
    words = _as_words(words, dev)
    if dev.type == "cpu":
        hit, t, axis, _ = intersect_brick_plain(words, origins, directions)
        return {"hit": hit, "t": t, "axis": axis}
    if dev.type != "cuda":
        raise ValueError(f"trace_single_brick: unsupported device {dev}")
    o, d = _check_rays(origins, directions)
    n = o.shape[0]
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=_F32, device=dev)
    axis = torch.empty(n, dtype=_I32, device=dev)
    if n:
        _launch(build.load("brick", _bind), words, o, d, hit, t, axis)
        trace_single_brick.launches += 1
    return {"hit": hit, "t": t, "axis": axis}


trace_single_brick.launches = 0


def prepared_launch(origins: torch.Tensor, directions: torch.Tensor, words):
    """For timing the kernel alone: checks the CUDA inputs and allocates the
    outputs once, then returns ``(run, out)``; each ``run()`` only launches
    the kernel into ``out`` (dict hit / t / axis), without counting in
    ``trace_single_brick.launches``."""
    if origins.device.type != "cuda":
        raise ValueError("prepared_launch needs CUDA tensors")
    words = _as_words(words, origins.device)
    o, d = _check_rays(origins, directions)
    lib = build.load("brick", _bind)
    n, dev = o.shape[0], o.device
    out = {"hit": torch.empty(n, dtype=torch.bool, device=dev),
           "t": torch.empty(n, dtype=_F32, device=dev),
           "axis": torch.empty(n, dtype=_I32, device=dev)}
    args = (words, o, d, out["hit"], out["t"], out["axis"])
    return (lambda: _launch(lib, *args)), out


def rcp_mismatches(device="cuda") -> int:
    """How many d with 2^-126 <= |d| < 2^126 (every float of that range)
    the reciprocal of B1's padded walk rounds unlike IEEE ``1 / d``: 0 is
    what keeps the walk's ``t`` bit-equal to the plain version's."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("rcp_mismatches runs on a CUDA device")
    lib = build.load("brick", _bind)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        status = lib.brick_rcp_mismatches(
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "rcp_check_kernel")
    return int(count)
