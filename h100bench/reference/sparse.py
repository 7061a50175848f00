"""The reference training step: the sparse inverse renderer's loss and
gradients over the plain versions of B3, R1, B4f, R2 and B4b, and Adam
written out.

Frozen copies of ``brickmap_tpu_torch/diff/sparse.py``'s row replay (the
page sort, the record, the count sort, the K tiers and the slices of
16,384 rays) and of ``app/benchmark.py::active_fields``.  Adam follows
``torch.optim.Adam``'s update with optax's defaults (beta 0.9 / 0.999,
eps 1e-8), written as plain tensor arithmetic, then the clip to [0, 1].
:func:`follow` runs the first steps of a training run from the inputs and
returns what the comparison reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import bits
from .config import BRICK_INDEX_BITS, BRICK_LOADED_BIT, GridConfig, i32
from .extract import extract_bwd_plain, extract_fwd_plain
from .record import record_segments_plain
from .replay import composite_sse_plain, ray_sse_plain, segment_geom_plain

__all__ = ["cell_pool_map", "active_fields", "loss_and_grads", "follow",
           "leaf_norms"]

_F32, _I32 = torch.float32, torch.int32
SLICE = 16384
BETAS, EPS = (0.9, 0.999), 1e-8


def cell_pool_map(world, grid: GridConfig) -> torch.Tensor:
    """int32 [CZ, CY, CX]: brick cell -> pool row, -1 where none."""
    iv = world.index_volume
    cz, cy, cx = iv.shape
    s, sxy = grid.supergrid_cell_size, grid.supergrid_xy
    dev = iv.device
    zz = torch.arange(cz, device=dev)[:, None, None] // s
    yy = torch.arange(cy, device=dev)[None, :, None] // s
    xx = torch.arange(cx, device=dev)[None, None, :] // s
    sc = xx + yy * sxy + zz * sxy * sxy
    slot = world.pool_base[sc] + (iv & BRICK_INDEX_BITS)
    return torch.where((iv & i32(BRICK_LOADED_BIT)) != 0, slot, -1).to(_I32)


def active_fields(world, grid: GridConfig, cells: torch.Tensor,
                  occ_scale: float, albedo: float):
    """The bricks the recorded ``cells`` reach, a cellmap onto them, and
    the fields over them: occupancy = bitmask * ``occ_scale``, albedo =
    ``albedo``.  Returns (cellmap_a, occ [A, 512], alb [A, 512, 3])."""
    cellmap = cell_pool_map(world, grid)
    c = cells[cells >= 0]
    rows = cellmap[(c >> 20) & 0x3FF, (c >> 10) & 0x3FF, c & 0x3FF]
    uniq = torch.unique(rows[rows >= 0])
    a = uniq.shape[0]
    inv = torch.full((world.num_bricks,), -1, dtype=_I32, device=cells.device)
    inv[uniq.long()] = torch.arange(a, dtype=_I32, device=cells.device)
    cellmap_a = torch.where(cellmap >= 0,
                            inv[torch.clamp(cellmap, min=0).long()], -1)
    dense = bits.dense_from_brick_words(world.pool_words[uniq.long()])
    occ = dense.reshape(a, 512).to(_F32) * occ_scale
    alb = torch.full((a, 512, 3), albedo, dtype=_F32, device=cells.device)
    return cellmap_a, occ, alb


def _page_sort(origin, direction, background, target, grid: GridConfig):
    s16 = float(grid.brick_size * grid.supergrid_cell_size)
    q = torch.clamp((origin / s16).to(_I32), 0,
                    max(grid.supergrid_xy, grid.supergrid_z) - 1)
    page = (q[:, 0] + q[:, 1] * grid.supergrid_xy
            + q[:, 2] * grid.supergrid_xy ** 2)
    octant = ((direction[:, 0] > 0).to(_I32)
              + 2 * (direction[:, 1] > 0).to(_I32)
              + 4 * (direction[:, 2] > 0).to(_I32))
    order = torch.argsort(page * 8 + octant, stable=True)
    return tuple(a[order] for a in (origin, direction, background, target))


def segments(origin, direction, background, target, world, grid, k: int):
    """The record and both sorts (what the program keeps in its segment
    cache): (o_cells, dirs, cells, nd, ncode, enorm, bg, tgt) with the rays
    that have a segment first, and their count."""
    origin, direction, background, target = _page_sort(
        origin, direction, background, target, grid)
    segs = record_segments_plain(origin, direction, world, grid,
                                 k_segments=k)
    cells = segs["cells"]
    cnt = (cells >= 0).sum(dim=1)
    order = torch.argsort(-cnt, stable=True)
    geo = tuple(a[order] for a in (segs["o_cells"], direction, cells,
                                   segs["nd"], segs["ncode"],
                                   segs["entry_normal"], background, target))
    return geo, int((cells[:, 0] >= 0).sum())


def loss_and_grads(geo, n_live: int, cellmap, occ, alb, grid: GridConfig,
                   k: int, quant=None, on_slice=None):
    """Mean squared error over the N x 3 pixel values and its gradients
    w.r.t. (occ [A, 512], alb [A, 512, 3]), by slices of live rays through
    R1, B4f, R2 and B4b's plain versions.  ``quant``, when given, rounds
    the field, each slice's values, errors and cotangents and the
    accumulated gradient (the control's lower precision).  ``on_slice(cells,
    direction, lin2)``, when given, sees each replayed slice's segments and
    R1's visited voxels."""
    q = quant if quant is not None else (lambda t: t)
    n = geo[0].shape[0]
    field4 = q(torch.cat([occ.reshape(-1, 1), alb.reshape(-1, 3)], dim=1))
    dfield = torch.zeros_like(field4)
    bg, tgt = geo[6], geo[7]
    idx = torch.arange(n, device=bg.device)
    err = torch.sum((bg - tgt) ** 2, dim=1)
    sse_sky = torch.sum(torch.where(idx >= n_live, err, 0.0))
    keffs = [kk for kk in (2, 4) if kk < k] + [k]
    thresholds = [0] + keffs[:-1]
    live = [a[:n_live] for a in geo]
    chunk = min(SLICE, -(-n // 1024) * 1024)
    counts = (live[2] >= 0).sum(dim=1)
    maxima = F.pad(counts, (0, (-n_live) % chunk)).reshape(-1, chunk) \
        .amax(dim=1).tolist()
    sses = []
    for i, mx in enumerate(maxima):
        sl = slice(i * chunk, (i + 1) * chunk)
        tier = sum(mx > t for t in thresholds)
        if tier == 0:
            sses.append(ray_sse_plain(live[6][sl], live[7][sl]))
            continue
        ke = keffs[tier - 1]
        slots, lin2 = segment_geom_plain(
            live[0][sl], live[1][sl], live[2][sl, :ke], live[3][sl, :ke],
            live[4][sl, :ke], live[5][sl], cellmap, grid)
        if on_slice is not None:
            on_slice(live[2][sl, :ke], live[1][sl], lin2)
        vals = q(extract_fwd_plain(field4, slots, lin2))
        sse, dvals = composite_sse_plain(vals, lin2, live[6][sl],
                                         live[7][sl])
        extract_bwd_plain(dfield, slots, lin2, q(dvals))
        dfield.copy_(q(dfield))
        sses.append(q(sse))
    sse = torch.sum(torch.cat(sses)) if sses else torch.zeros(
        (), device=bg.device)
    inv = torch.tensor(1.0 / (n * 3), dtype=_F32, device=bg.device)
    docc = (dfield[:, 0] * inv).reshape(occ.shape)
    dalb = (dfield[:, 1:] * inv).reshape(alb.shape)
    return (sse + sse_sky) * inv, (docc, dalb)


def _adam(params, grads, state, step: int, lr: float, quant) -> None:
    """One Adam update (torch.optim.Adam's arithmetic) and the clip."""
    b1, b2 = BETAS
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    for p, g, (m, v) in zip(params, grads, state):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v.sqrt() / math.sqrt(bc2)).add_(EPS)
        p.addcdiv_(m, denom, value=-lr / bc1)
        p.clamp_(0.0, 1.0)
        if quant is not None:
            for t in (p, m, v):
                t.copy_(quant(t))


def leaf_norms(tensors, block: int = 1 << 26) -> list:
    """The L2 norm of each leaf, its squares summed in float64 by blocks."""
    out = []
    for t in tensors:
        flat = t.reshape(-1)
        acc = 0.0
        for i in range(0, flat.shape[0], block):
            acc += float(torch.sum(flat[i:i + block].double() ** 2))
        out.append(math.sqrt(acc))
    return out


def follow(world, grid: GridConfig, origin, direction, background, target,
           k: int, lr: float, occ_scale: float, albedo: float,
           steps: int = 3, quant=None, on_slice=None) -> dict:
    """The first ``steps`` steps of the fixed-ray training run from its
    inputs: the active set and fields worked out from the rays, each step's
    loss, the first gradient's leaf norms (as Adam's first moment after one
    step gives it), the leaves' change after the steps, and each leaf's
    gradient norm on the first step (which leaves count).  ``on_slice`` sees
    the first step's slices (:func:`loss_and_grads`)."""
    geo, n_live = segments(origin, direction, background, target, world,
                           grid, k)
    cellmap, occ, alb = active_fields(world, grid, geo[2], occ_scale, albedo)
    params = (occ, alb)
    if quant is not None:
        for p in params:
            p.copy_(quant(p))
    start = [p.clone() for p in params]
    state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    losses, grad_norms = [], None
    for i in range(steps):
        loss, grads = loss_and_grads(geo, n_live, cellmap, occ, alb, grid, k,
                                     quant, on_slice if i == 0 else None)
        losses.append(float(loss))
        _adam(params, grads, state, i + 1, lr, quant)
        del grads
        if i == 0:
            grad_norms = [x / (1.0 - BETAS[0])
                          for x in leaf_norms(m for m, _ in state)]
    del state
    change = [leaf_norms([p - s])[0] for p, s in zip(params, start)]
    return {"active": int(occ.shape[0]), "losses": losses,
            "grad_norms": grad_norms, "change_norms": change}
