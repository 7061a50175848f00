"""Kernels B4f and B4b: the brick-row replay's reads from, and gradient adds
into, the pool fields.

The port of ``brickmap_tpu/pallas/extract.py::extract_rows_pallas``
(:78-146) together with the row gather before it and the row scatter-add
after it (``brickmap_tpu/diff/sparse.py:512``, ``:531``).  The fields are
voxel-interleaved, ``field4 [P*512, 4]`` f32 (occupancy, then RGB albedo);
``slots [Cs]`` i32 names each segment's pool row and ``lin2 [Cs, nvox]`` i32
the brick voxels it visits (entry (r, j) is valid when
``0 <= lin2[r, j] < 512`` and ``0 <= slots[r] < P``):

* :func:`extract_fwd` (B4f): ``vals [Cs, 4*nvox]``, column ``f*nvox + j``;
* :func:`extract_bwd` (B4b): adds the cotangents ``dvals [Cs, 4*nvox]`` of
  the valid entries into ``dfield4`` in place;
* :func:`extract_field`: the two as one autograd Function, differentiable in
  ``field4``.

For tensors on the card the wrappers launch the CUDA kernels of
``csrc/extract.cu``; for tensors on the CPU they run the plain versions of
:mod:`brickmap_tpu_torch.ops.extract`; on any other device they raise.
``extract_fwd.launches`` and ``extract_bwd.launches`` count kernel launches;
their ``events`` are the event hook of :mod:`brickmap_tpu_torch.kernels`.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.extract import BRICK_VOXELS, extract_bwd_plain, extract_fwd_plain
from . import build, hooked

__all__ = ["extract_fwd", "extract_bwd", "extract_field"]

_F32, _I32 = torch.float32, torch.int32


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.extract_fwd_launch.argtypes = [i, i, i, p, p, p, p, p]
    lib.extract_fwd_launch.restype = i
    lib.extract_bwd_launch.argtypes = [i, i, i, p, p, p, p, p]
    lib.extract_bwd_launch.restype = i


def _check(name: str, field4, slots, lin2, dvals=None):
    """Raise unless the kernel takes these tensors; returns (cs, nvox, P)."""
    dev = field4.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not (field4.dtype == _F32 and field4.dim() == 2
            and field4.shape[1] == 4 and field4.shape[0] % BRICK_VOXELS == 0
            and field4.is_contiguous() and field4.data_ptr() % 16 == 0):
        raise ValueError(f"{name}: the field must be a contiguous, 16-byte "
                         f"aligned float32 [P*{BRICK_VOXELS}, 4] tensor")
    if lin2.dim() != 2:
        raise ValueError(f"{name}: lin2 must be [Cs, nvox]")
    cs, nvox = lin2.shape
    for arg, a, dtype, shape in (("slots", slots, _I32, (cs,)),
                                 ("lin2", lin2, _I32, (cs, nvox)),
                                 ("dvals", dvals, _F32, (cs, 4 * nvox))):
        if a is not None and (a.dtype != dtype or a.device != dev
                              or tuple(a.shape) != shape):
            raise ValueError(f"{name}: {arg} must be {dtype} {list(shape)} "
                             f"on {dev}")
    if cs * nvox >= 2 ** 31:
        raise ValueError(f"{name}: {cs} x {nvox} entries exceed int32")
    return cs, nvox, field4.shape[0] // BRICK_VOXELS


def extract_fwd(field4: torch.Tensor, slots: torch.Tensor,
                lin2: torch.Tensor) -> torch.Tensor:
    """B4f: ``vals [Cs, 4*nvox]``, ``vals[r, f*nvox + j] =
    field4[slots[r]*512 + lin2[r, j], f]``, 0 where the entry is invalid."""
    if field4.device.type == "cpu":
        return extract_fwd_plain(field4, slots, lin2)
    cs, nvox, pool = _check("extract_fwd", field4, slots, lin2)
    slots, lin2 = slots.contiguous(), lin2.contiguous()
    dev = field4.device
    vals = torch.empty((cs, 4 * nvox), dtype=_F32, device=dev)
    if cs and nvox:
        lib = build.load("extract", _bind)
        with torch.cuda.device(dev):
            status = hooked(
                extract_fwd, lib.extract_fwd_launch, cs, nvox, pool,
                field4.data_ptr(), slots.data_ptr(), lin2.data_ptr(),
                vals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        build.check(status, "extract_fwd_kernel")
        extract_fwd.launches += 1
    return vals


def extract_bwd(dfield4: torch.Tensor, slots: torch.Tensor,
                lin2: torch.Tensor, dvals: torch.Tensor) -> torch.Tensor:
    """B4b, in place: adds ``dvals[r, f*nvox + j]`` into
    ``dfield4[slots[r]*512 + lin2[r, j], f]`` for every valid entry; returns
    ``dfield4``.  On the card the adds are atomics in no fixed order."""
    if dfield4.device.type == "cpu":
        return extract_bwd_plain(dfield4, slots, lin2, dvals)
    cs, nvox, pool = _check("extract_bwd", dfield4, slots, lin2, dvals)
    slots, lin2, dvals = slots.contiguous(), lin2.contiguous(), \
        dvals.contiguous()
    dev = dfield4.device
    if cs and nvox:
        lib = build.load("extract", _bind)
        with torch.cuda.device(dev):
            status = hooked(
                extract_bwd, lib.extract_bwd_launch, cs, nvox, pool,
                dfield4.data_ptr(), slots.data_ptr(), lin2.data_ptr(),
                dvals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        build.check(status, "extract_bwd_kernel")
        extract_bwd.launches += 1
    return dfield4


extract_fwd.launches = extract_bwd.launches = 0
extract_fwd.events = extract_bwd.events = None


class _ExtractField(torch.autograd.Function):
    @staticmethod
    def forward(ctx, field4, slots, lin2):
        ctx.save_for_backward(slots, lin2)
        ctx.field_shape = field4.shape
        return extract_fwd(field4, slots, lin2)

    @staticmethod
    def backward(ctx, dvals):
        slots, lin2 = ctx.saved_tensors
        dfield4 = torch.zeros(ctx.field_shape, dtype=dvals.dtype,
                              device=dvals.device)
        return extract_bwd(dfield4, slots, lin2, dvals), None, None


def extract_field(field4: torch.Tensor, slots: torch.Tensor,
                  lin2: torch.Tensor) -> torch.Tensor:
    """:func:`extract_fwd`, differentiable in ``field4``: its backward
    allocates a zero field gradient and adds into it with
    :func:`extract_bwd`."""
    return _ExtractField.apply(field4, slots, lin2)
