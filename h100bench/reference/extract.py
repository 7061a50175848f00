# Frozen copy of brickmap_tpu_torch/ops/extract.py, the
# benchmark's plain reference: it imports nothing of the port, and later
# changes to the port do not reach it.  Only its imports were changed.
"""Visited-voxel extraction in torch: the plain versions of kernels B4f/B4b.

The port of the function pair of ``brickmap_tpu/pallas/extract.py``
(``_fwd_kernel`` :35, ``_bwd_kernel`` :55).  ``lin2 [Cs, nvox]`` names the
brick voxels a segment visits, in visiting order.

The replay reads the voxel-interleaved pool fields ``field4 [P*512, 4]``
(occupancy, then RGB albedo); ``slots [Cs]`` names each segment's pool row,
and entry (r, j) is valid when ``0 <= lin2[r, j] < 512`` and
``0 <= slots[r] < P``:

* :func:`extract_fwd_plain` (B4f): ``vals [Cs, 4*nvox]``, column
  ``f*nvox + j`` = ``field4[slots[r]*512 + lin2[r, j], f]``, 0 where invalid;
  the gather of one ``[4*512]`` row per segment and its extraction in one.
* :func:`extract_bwd_plain` (B4b): its transpose, added into ``dfield4`` in
  place by one ``index_add_`` of the valid entries in ascending (r, j).

The JAX package's row contract, held against ``extract_rows_pallas`` by the
tests (a field row is ``[4*nv]`` wide, column ``f*nv + v``):

* :func:`extract_rows_plain` gathers ``vals [Cs, 4*nvox]`` from gathered rows
  ``rows2 [Cs, 4*nv]``, 0 where ``lin2[:, j]`` lies outside ``[0, nv)``.
* :func:`extract_rows_bwd_plain` is its transpose: every cotangent added into
  a zero row at its voxel, duplicates summed in ascending j.
"""

from __future__ import annotations

import torch

__all__ = ["BRICK_VOXELS", "field_index", "extract_fwd_plain",
           "extract_bwd_plain", "extract_rows_plain", "extract_rows_bwd_plain"]

BRICK_VOXELS = 512     # field rows per pool slot: the 8^3 voxels of a brick


def field_index(slots: torch.Tensor, lin2: torch.Tensor, rows: int):
    """(``gidx [Cs, nvox]`` int64 field rows, 0 where invalid; ``valid``
    bool) for a field of ``rows`` voxel rows."""
    pool = rows // BRICK_VOXELS
    valid = (lin2 >= 0) & (lin2 < BRICK_VOXELS) \
        & ((slots >= 0) & (slots < pool))[:, None]
    gidx = slots.long()[:, None] * BRICK_VOXELS + lin2.long()
    return torch.where(valid, gidx, 0), valid


def extract_fwd_plain(field4: torch.Tensor, slots: torch.Tensor,
                      lin2: torch.Tensor) -> torch.Tensor:
    """``field4 [P*512, 4]``, ``slots [Cs]``, ``lin2 [Cs, nvox]`` int32 ->
    ``vals [Cs, 4*nvox]``."""
    cs, nvox = lin2.shape
    gidx, valid = field_index(slots, lin2, field4.shape[0])
    vals = field4.index_select(0, gidx.reshape(-1)).reshape(cs, nvox, 4)
    vals = torch.where(valid[..., None], vals, 0.0)
    return vals.permute(0, 2, 1).reshape(cs, 4 * nvox)


def extract_bwd_plain(dfield4: torch.Tensor, slots: torch.Tensor,
                      lin2: torch.Tensor, dvals: torch.Tensor) -> torch.Tensor:
    """Adds ``dvals [Cs, 4*nvox]`` at the valid entries into
    ``dfield4 [P*512, 4]`` in place; returns ``dfield4``."""
    cs, nvox = lin2.shape
    gidx, valid = field_index(slots, lin2, dfield4.shape[0])
    dv = dvals.reshape(cs, 4, nvox).permute(0, 2, 1)        # [Cs, nvox, 4]
    return dfield4.index_add_(0, gidx[valid], dv[valid])


def extract_rows_plain(rows2: torch.Tensor, lin2: torch.Tensor) -> torch.Tensor:
    """``rows2 [Cs, 4*nv]``, ``lin2 [Cs, nvox]`` int32 -> ``[Cs, 4*nvox]``."""
    nv = rows2.shape[1] // 4
    valid = (lin2 >= 0) & (lin2 < nv)
    idx = torch.where(valid, lin2, 0).long()
    vals = [torch.where(valid, torch.gather(rows2[:, f * nv:(f + 1) * nv], 1,
                                            idx), 0.0)
            for f in range(4)]
    return torch.cat(vals, dim=1)


def extract_rows_bwd_plain(lin2: torch.Tensor, dvals: torch.Tensor,
                           width: int) -> torch.Tensor:
    """``lin2 [Cs, nvox]``, ``dvals [Cs, 4*nvox]`` -> ``drows [Cs, width]``."""
    nv = width // 4
    nvox = lin2.shape[1]
    vox = torch.arange(nv, dtype=lin2.dtype, device=lin2.device)
    acc = torch.zeros((lin2.shape[0], 4, nv), dtype=dvals.dtype,
                      device=dvals.device)
    for j in range(nvox):
        sel = (lin2[:, j:j + 1] == vox)[:, None, :]          # [Cs, 1, nv]
        dv = dvals[:, j::nvox][:, :, None]                   # [Cs, 4, 1]
        acc = acc + torch.where(sel, dv, 0.0)
    return acc.reshape(lin2.shape[0], width)
