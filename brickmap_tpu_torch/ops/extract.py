"""Visited-voxel extraction in torch: the plain versions of kernels B4f/B4b.

The port of the function pair of ``brickmap_tpu/pallas/extract.py``
(``_fwd_kernel`` :35, ``_bwd_kernel`` :55).  A field row is ``[4*nv]`` wide,
column ``f*nv + v`` for field f (occupancy, then RGB albedo) and brick voxel
v; ``lin2 [Cs, nvox]`` names the voxels a segment visits, in visiting order.

* :func:`extract_rows_plain` gathers them: ``vals [Cs, 4*nvox]``, column
  ``f*nvox + j`` = ``rows2[:, f*nv + lin2[:, j]]``, or 0 where ``lin2[:, j]``
  lies outside ``[0, nv)``.
* :func:`extract_rows_bwd_plain` is its transpose: every cotangent added into
  a zero row at its voxel, duplicates summed in ascending j.
"""

from __future__ import annotations

import torch

__all__ = ["extract_rows_plain", "extract_rows_bwd_plain"]


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
