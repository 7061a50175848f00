"""Kernels B4f and B4b behind :func:`extract_rows`.

The port of ``brickmap_tpu/pallas/extract.py::extract_rows_pallas`` (:78-146):
one :class:`torch.autograd.Function` whose forward is B4f (the visited-voxel
values of each gathered field row) and whose backward is B4b (their
transpose into a full row; ``lin2`` takes no gradient).  For tensors on the
card both launch the CUDA kernels of ``csrc/extract.cu``; for tensors on the
CPU they run the plain versions of :mod:`brickmap_tpu_torch.ops.extract`; on
any other device they raise.  ``extract_fwd.launches`` and
``extract_bwd.launches`` count kernel launches; their ``events`` are the
event hook of :mod:`brickmap_tpu_torch.kernels`.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.extract import extract_rows_bwd_plain, extract_rows_plain
from . import build, hooked

__all__ = ["extract_rows", "extract_fwd", "extract_bwd"]

_F32, _I32 = torch.float32, torch.int32


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.extract_fwd_launch.argtypes = [i, i, i, p, p, p, p]
    lib.extract_fwd_launch.restype = i
    lib.extract_bwd_launch.argtypes = [i, i, i, p, p, p, p]
    lib.extract_bwd_launch.restype = i


def _check(name: str, a: torch.Tensor, dtype, cols: int, cs: int, dev):
    if a.dtype != dtype or a.device != dev or a.dim() != 2 \
            or a.shape[0] != cs or a.shape[1] != cols:
        raise ValueError(f"{name} must be {dtype} [{cs}, {cols}] on {dev}")


def extract_fwd(rows2: torch.Tensor, lin2: torch.Tensor) -> torch.Tensor:
    """B4f: ``rows2 [Cs, 4*nv]`` f32, ``lin2 [Cs, nvox]`` i32 ->
    ``vals [Cs, 4*nvox]`` (column ``f*nvox + j``; 0 where lin is out of
    range)."""
    dev = rows2.device
    if dev.type == "cpu":
        return extract_rows_plain(rows2, lin2)
    if dev.type != "cuda":
        raise ValueError(f"extract_fwd: unsupported device {dev}")
    cs, width = rows2.shape
    nvox = lin2.shape[1]
    _check("rows2", rows2, _F32, width, cs, dev)
    _check("lin2", lin2, _I32, nvox, cs, dev)
    rows2, lin2 = rows2.contiguous(), lin2.contiguous()
    vals = torch.empty((cs, 4 * nvox), dtype=_F32, device=dev)
    if cs and nvox:
        lib = build.load("extract", _bind)
        with torch.cuda.device(dev):
            status = hooked(
                extract_fwd, lib.extract_fwd_launch, cs, width // 4, nvox, rows2.data_ptr(), lin2.data_ptr(),
                vals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        build.check(status, "extract_fwd_kernel")
        extract_fwd.launches += 1
    return vals


def extract_bwd(lin2: torch.Tensor, dvals: torch.Tensor,
                width: int) -> torch.Tensor:
    """B4b: ``lin2 [Cs, nvox]`` i32, ``dvals [Cs, 4*nvox]`` f32 ->
    ``drows [Cs, width]``, every cotangent added at its voxel in ascending
    j, zeros elsewhere."""
    dev = dvals.device
    if dev.type == "cpu":
        return extract_rows_bwd_plain(lin2, dvals, width)
    if dev.type != "cuda":
        raise ValueError(f"extract_bwd: unsupported device {dev}")
    cs, nvox = lin2.shape
    _check("lin2", lin2, _I32, nvox, cs, dev)
    _check("dvals", dvals, _F32, 4 * nvox, cs, dev)
    lin2, dvals = lin2.contiguous(), dvals.contiguous()
    drows = torch.empty((cs, width), dtype=_F32, device=dev)
    if cs:
        lib = build.load("extract", _bind)
        with torch.cuda.device(dev):
            status = hooked(
                extract_bwd, lib.extract_bwd_launch, cs, width // 4, nvox, lin2.data_ptr(), dvals.data_ptr(),
                drows.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        build.check(status, "extract_bwd_kernel")
        extract_bwd.launches += 1
    return drows


extract_fwd.launches = extract_bwd.launches = 0
extract_fwd.events = extract_bwd.events = None


class _ExtractRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows2, lin2):
        ctx.save_for_backward(lin2)
        ctx.width = rows2.shape[1]
        return extract_fwd(rows2, lin2)

    @staticmethod
    def backward(ctx, dvals):
        (lin2,) = ctx.saved_tensors
        return extract_bwd(lin2, dvals, ctx.width), None


def extract_rows(rows2: torch.Tensor, lin2: torch.Tensor) -> torch.Tensor:
    """``vals [Cs, 4*nvox]`` from ``rows2 [Cs, 4*nv]`` at ``lin2 [Cs, nvox]``
    (int32; any index outside ``[0, nv)`` yields 0), differentiable in
    ``rows2``: forward B4f, backward B4b."""
    return _ExtractRows.apply(rows2, lin2)
