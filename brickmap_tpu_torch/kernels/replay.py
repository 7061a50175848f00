"""Kernels R1 and R2: the sparse replay's slice body around B4f/B4b.

The JAX package leaves these to XLA, which fuses ``_row_chunk_grad``'s
geometry and composite into the one program of ``_row_scan_grads``
(``brickmap_tpu/diff/sparse.py:490``, ``:535``); the port runs them as two
hand-written CUDA kernels (``csrc/replay.cu``), so that a slice is
R1 -> B4f -> R2 -> B4b:

* :func:`segment_geom` (R1, ``segment_geom_kernel``): ``_segment_geom``
  with ``_merge_offsets`` and the -1 poison of the invalid steps —
  ``(slots [C*K] i32, lin2 [C*K, nvox] i32)``, B4f's and B4b's inputs;
* :func:`composite_sse` (R2, ``composite_kernel``): the clip/mask chain and
  ``_composite_core3`` with its analytic backward for the SSE loss —
  ``(sse [C], dvals [C*K, 4*nvox])`` from B4f's values; ``dvals`` is a new
  tensor (``vals`` is left as it was).

For tensors on the CPU each wrapper runs its plain version
(:mod:`brickmap_tpu_torch.ops.replay`); on any other device than the CPU or
CUDA it raises.  Each counts its kernel's launches in ``.launches`` and has
the ``.events`` hook of :mod:`brickmap_tpu_torch.kernels`.
:func:`segment_geom_args` and :func:`composite_sse_args` build the
launchers' ctypes arguments (the host rehearsal of ``csrc/replay.cu``,
``tests/test_torch_replay_host.py``, drives the launchers with them).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import GridConfig
from ..ops.replay import composite_sse_plain, segment_geom_plain
from . import build, hooked

__all__ = ["segment_geom", "composite_sse", "segment_geom_args",
           "composite_sse_args", "launch_shape"]

_F32, _I32 = torch.float32, torch.int32
_BRICK = 8                  # csrc/replay.cu's kBrick
NVOX = 3 * _BRICK - 2


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.replay_geom_launch.argtypes = (
        [i, i, p, p, p, p, i, p, i, p, i, p, i, i, i, f, p, p, p])
    lib.replay_composite_launch.argtypes = [i, i, i] + [p] * 6 + [p]
    lib.replay_launch_shape.argtypes = [i, p]
    for fn in (lib.replay_geom_launch, lib.replay_composite_launch,
               lib.replay_launch_shape):
        fn.restype = i


def _device(dev, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")


def _need(name: str, arg: str, a, dev, dtype, shape) -> None:
    if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape:
        raise ValueError(f"{name}: {arg} must be {dtype} {list(shape)} on "
                         f"{dev}, got {a.dtype} {list(a.shape)} on "
                         f"{a.device}")


# ---- R1 -------------------------------------------------------------------

def segment_geom_args(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                      grid: GridConfig, out: tuple, stream) -> tuple:
    """``(args, keep)``: ``replay_geom_launch``'s arguments (``out`` =
    (slots, lin2)) and the tensors they point into.  The [C, K] record
    arrays go by their row stride; each must have unit column stride."""
    name = "segment_geom"
    dev = cells.device
    if grid.brick_size != _BRICK:
        raise ValueError(f"{name}: the kernel takes bricks of {_BRICK}, "
                         f"not {grid.brick_size}")
    if cells.dim() != 2:
        raise ValueError(f"{name}: cells must be [C, K]")
    c, k = cells.shape
    for arg, a, dtype in (("cells", cells, _I32), ("nd", nd, _F32),
                          ("ncode", ncode, _I32)):
        _need(name, arg, a, dev, dtype, (c, k))
        if k > 1 and a.stride(1) != 1:
            raise ValueError(f"{name}: {arg} must have unit column stride")
    rays3 = []
    for arg, a in (("o_cells", o_cells), ("direction", direction),
                   ("enorm", enorm)):
        _need(name, arg, a, dev, _F32, (c, 3))
        rays3.append(a.contiguous())
    if cellmap.dim() != 3 or cellmap.dtype != _I32 or cellmap.device != dev:
        raise ValueError(f"{name}: cellmap must be int32 [CZ, CY, CX] on "
                         f"{dev}")
    cellmap = cellmap.contiguous()
    if c * k * NVOX >= 2 ** 31 or cellmap.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {c} x {k} segments exceed int32")
    keep = [*rays3, cellmap]
    args = (c * k, k, *(a.data_ptr() for a in rays3),
            cells.data_ptr(), cells.stride(0), nd.data_ptr(), nd.stride(0),
            ncode.data_ptr(), ncode.stride(0), cellmap.data_ptr(),
            cellmap.shape[1], cellmap.shape[2], cellmap.numel(),
            grid.epsilon, *(a.data_ptr() for a in out), stream)
    return args, keep


def segment_geom(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                 grid: GridConfig) -> tuple:
    """R1: ``(slots [C*K] i32, lin2 [C*K, nvox] i32)`` of the ``cells``/
    ``nd``/``ncode`` [C, K] segments of rays ``o_cells``/``direction``/
    ``enorm`` [C, 3] (the record's clipped origins in cells, directions and
    entry normals) over ``cellmap``: slot 0 and every step -1 where the
    segment is not valid, and -1 at each step outside the brick."""
    dev = cells.device
    if dev.type == "cpu":
        return segment_geom_plain(o_cells, direction, cells, nd, ncode,
                                  enorm, cellmap, grid)
    _device(dev, "segment_geom")
    c, k = cells.shape
    out = (torch.empty(c * k, dtype=_I32, device=dev),
           torch.empty((c * k, NVOX), dtype=_I32, device=dev))
    if c * k:
        lib = build.load("replay", _bind)
        with torch.cuda.device(dev):
            args, keep = segment_geom_args(
                o_cells, direction, cells, nd, ncode, enorm, cellmap, grid,
                out, torch.cuda.current_stream(dev).cuda_stream)
            status = hooked(segment_geom, lib.replay_geom_launch, *args)
        build.check(status, "segment_geom_kernel")
        segment_geom.launches += 1
        del keep
    return out


segment_geom.launches = 0
segment_geom.events = None


# ---- R2 -------------------------------------------------------------------

def composite_sse_args(vals, lin2, background, target, out: tuple,
                       stream) -> tuple:
    """``(args, keep)``: ``replay_composite_launch``'s arguments (``out`` =
    (sse, dvals)) and the tensors they point into."""
    name = "composite_sse"
    dev = vals.device
    c = background.shape[0]
    if lin2.dim() != 2 or c == 0 or lin2.shape[0] % c:
        raise ValueError(f"{name}: lin2 must be [C*K, nvox] for {c} rays")
    cs, nvox = lin2.shape
    if nvox != NVOX:
        raise ValueError(f"{name}: the kernel takes rows of {NVOX} steps, "
                         f"not {nvox}")
    _need(name, "vals", vals, dev, _F32, (cs, 4 * nvox))
    _need(name, "lin2", lin2, dev, _I32, (cs, nvox))
    _need(name, "background", background, dev, _F32, (c, 3))
    _need(name, "target", target, dev, _F32, (c, 3))
    if cs * 4 * nvox >= 2 ** 31:
        raise ValueError(f"{name}: {cs} x {4 * nvox} values exceed int32")
    # The kernel copies vals and dvals rows in 16-byte pieces and lin2 rows
    # in 8-byte ones.
    keep = [a.contiguous() for a in (vals, lin2, background, target)]
    for arg, a, align in (("vals", keep[0], 16), ("lin2", keep[1], 8),
                          ("dvals", out[1], 16)):
        if a.data_ptr() % align:
            raise ValueError(f"{name}: {arg} must be {align}-byte aligned")
    args = (c, cs // c, nvox, *(a.data_ptr() for a in keep),
            *(a.data_ptr() for a in out), stream)
    return args, keep


def composite_sse(vals, lin2, background, target) -> tuple:
    """R2: ``(sse [C], dvals [C*K, 4*nvox])`` — each ray's squared error
    over B4f's values ``vals`` (a step valid where ``lin2 >= 0``), and its
    cotangents w.r.t. ``vals`` (see
    :func:`~brickmap_tpu_torch.ops.replay.composite_sse_plain`)."""
    dev = vals.device
    if dev.type == "cpu":
        return composite_sse_plain(vals, lin2, background, target)
    _device(dev, "composite_sse")
    c = background.shape[0]
    out = (torch.empty(c, dtype=_F32, device=dev),
           torch.empty(vals.shape, dtype=_F32, device=dev))
    if c:
        lib = build.load("replay", _bind)
        with torch.cuda.device(dev):
            args, keep = composite_sse_args(
                vals, lin2, background, target, out,
                torch.cuda.current_stream(dev).cuda_stream)
            status = hooked(composite_sse, lib.replay_composite_launch,
                            *args)
        build.check(status, "composite_kernel")
        composite_sse.launches += 1
        del keep
    return out


composite_sse.launches = 0
composite_sse.events = None


def launch_shape(keff: int, device=None) -> dict:
    """Each kernel's launch at K = ``keff`` on a CUDA ``device``: ``{"R1":
    (threads a block, dynamic shared bytes, blocks resident an SM), "R2":
    (...)}``, from the kernels' launchers and the CUDA occupancy API."""
    lib = build.load("replay", _bind)
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        build.check(lib.replay_launch_shape(keff, ctypes.addressof(out)),
                    "replay_launch_shape")
    return {"R1": tuple(out[:3]), "R2": tuple(out[3:])}
