"""The sparse fields' one layout: ``field4``, a contiguous float32
[P*512, 4] with one 16-byte row per voxel (occupancy, r, g, b).

Occupancy [P, 512] and albedo [P, 512, 3] are its column views
``field4[:, 0]`` and ``field4[:, 1:]`` (:func:`field4_views`).  Every
maker of sparse fields in the program returns them so
(``diff/sparse.py::pool_fields_from_bitmask``, ``app/benchmark.py::
active_fields``); the replay reads ``field4`` itself, the sparse step
returns its gradients as the same views of one ``dfield``, ``ClippedAdam``
steps the pair as one tensor and ``parallel/render.py::_pmean_`` reduces
it once.  :func:`field4_of` tells such a pair from fields made elsewhere.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def field4_views(field4: torch.Tensor):
    """(occupancy [P, 512], albedo [P, 512, 3]): the column views of a
    contiguous float32 ``field4`` [P*512, 4]."""
    p = field4.shape[0] // 512
    return field4[:, 0].view(p, 512), field4[:, 1:].view(p, 512, 3)


def new_fields(rows: int, device):
    """(occupancy, albedo) for ``rows`` bricks: the views of one new
    ``field4``, uninitialised."""
    return field4_views(torch.empty((rows * 512, 4), dtype=_F32,
                                    device=device))


def field4_of(occupancy: torch.Tensor, albedo: torch.Tensor):
    """The contiguous float32 ``field4`` whose :func:`field4_views` are
    exactly ``occupancy`` and ``albedo``, else None."""
    p = occupancy.shape[0]
    if (occupancy.dtype != _F32 or albedo.dtype != _F32
            or occupancy.shape != (p, 512) or albedo.shape != (p, 512, 3)
            or occupancy.stride() != (2048, 4)
            or albedo.stride() != (2048, 4, 1)
            or albedo.storage_offset() != occupancy.storage_offset() + 1
            or albedo.untyped_storage().data_ptr()
            != occupancy.untyped_storage().data_ptr()):
        return None
    return occupancy.as_strided((p * 512, 4), (4, 1))
