# Frozen copy of brickmap_tpu_torch/ops/record.py, the
# benchmark's plain reference: it imports nothing of the port, and later
# changes to the port do not reach it.  Only its imports were changed.
"""Segment recorder in torch: kernel B3's plain version.

The port of the contract of ``brickmap_tpu/pallas/record.py::record_segments``
(:353-472).  Every ray lists its first K occupied brick cells front to back:
the packed cell ``x | y << 10 | z << 20``, the entry distance ``nd`` in cell
units from the clipped origin, and the entry-face axis code (-1 where the ray
starts in the cell).  The compositor of :mod:`brickmap_tpu_torch.diff.sparse`
replays those segments.

The TPU kernel marches superchunk pages picked by a tile-wide vote and crosses
empty pages by page-level jumps; none of that is carried over.  All rays
advance in lockstep over ``index_volume``, one top-level DDA step per loop
iteration, with the traversal's arithmetic (:func:`..ops.traverse.aabb_clip`,
:func:`..ops.traverse._sel_axis`) and its Chebyshev empty-space skip from the
index word (bits 28:20).  A cell is occupied when any flag bit is set
(``BRICK_FLAG_BITS``, as ``pallas/paged.py:147`` builds the page bit rows);
LoD does not apply.  Recording does not stop a ray: it ends after its K-th
segment, on leaving the grid, or when its step budget ``max_steps`` runs out
(``exhausted``).

Beyond the JAX contract it reports, for the kernel's bound, the index words
each ray read (``ray_words``) and the distinct cells read (``cells_read``).
"""

from __future__ import annotations

import torch

from .config import BRICK_DIST_SHIFT, BRICK_FLAG_BITS, BRICK_INDEX_BITS, \
    BRICK_LOADED_BIT, GridConfig, i32
from .traverse import BIG, _sel3, _sel_axis, aabb_clip

__all__ = ["record_segments_plain", "DEFAULT_MAX_STEPS"]

_F32, _I32 = torch.float32, torch.int32

# Top-level steps per ray.  A step advances at least one cell along the ray,
# and a ray crosses at most cells_x + cells_y + cells_z cells (1,088 in the
# 4096^2 x 512 world), so this budget never runs out on the supported worlds.
DEFAULT_MAX_STEPS = 2048


def record_segments_plain(origin, direction, scene, grid: GridConfig,
                          k_segments: int = 16,
                          max_steps: int = DEFAULT_MAX_STEPS,
                          with_slots: bool = False) -> dict:
    """Record each ray's first ``k_segments`` occupied cells.

    ``scene`` is a :class:`~brickmap_tpu_torch.scene.TorchScene` on the rays'
    device.  Returns dict(cells [N,K] i32 (-1 = unused), nd [N,K] f32,
    ncode [N,K] i32 (-1 = start cell or unused), count [N] i32, tminn [N],
    entry_normal [N,3], o_cells [N,3] (clipped origin in cells),
    exhausted [N] bool, ray_words [N] i32, cells_read [CZ*CY*CX] bool), and
    with ``with_slots`` also slot [N,K] i32: ``pool_base[sc] + (word &
    0xFFF)`` for loaded cells, -1 otherwise.
    """
    dev = origin.device
    n = origin.shape[0]
    K = k_segments
    cx_max, cy_max, cz_max = grid.cells, grid.cells, grid.cells_height
    s = grid.supergrid_cell_size
    iv_flat = scene.index_volume.reshape(-1)

    ok, tminn, clipped, entry_normal = aabb_clip(origin, direction, grid)
    o_cells = clipped / float(grid.brick_size)
    dx, dy, dz = (direction[:, k].to(_F32) for k in range(3))

    def setup(o, d):
        """Step sign, crossing increment, start cell and first crossing t."""
        si = torch.sign(d).to(_I32)
        rd = torch.where(d == 0.0, 0.0, 1.0 / d)
        p = torch.trunc(o).to(_I32)
        cb = torch.where(d > 0, p.to(_F32) + 1.0, p.to(_F32))
        return si, si.to(_F32) * rd, p, \
            torch.where(d != 0.0, (cb - o) * rd, BIG)

    six, tdx, px, tx = setup(o_cells[:, 0], dx)
    siy, tdy, py, ty = setup(o_cells[:, 1], dy)
    siz, tdz, pz, tz = setup(o_cells[:, 2], dz)
    alive = ok & (px >= 0) & (px < cx_max) & (py >= 0) & (py < cy_max) \
        & (pz >= 0) & (pz < cz_max)

    cells = torch.full((n, K), -1, dtype=_I32, device=dev)
    nd = torch.zeros((n, K), dtype=_F32, device=dev)
    ncode = torch.full((n, K), -1, dtype=_I32, device=dev)
    slot = torch.full((n, K), -1, dtype=_I32, device=dev) if with_slots \
        else None
    count = torch.zeros(n, dtype=_I32, device=dev)
    axis0 = torch.full((n,), -1, dtype=_I32, device=dev)
    ray_words = torch.zeros(n, dtype=_I32, device=dev)
    n_cells = iv_flat.shape[0]
    cells_read = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)

    it = 0
    while it < max_steps and bool(alive.any()):
        it += 1
        ray_words = ray_words + alive.to(_I32)
        cell = ((torch.clamp(pz, 0, cz_max - 1) * cy_max
                 + torch.clamp(py, 0, cy_max - 1)) * cx_max
                + torch.clamp(px, 0, cx_max - 1)).long()
        cells_read.index_fill_(0, torch.where(alive, cell, n_cells), True)
        word = iv_flat[cell]
        occ0 = alive & ((word & i32(BRICK_FLAG_BITS)) != 0)

        # Append (cell, nd, ncode[, slot]) at column `count` (record.py:237-276).
        rows = occ0.nonzero().squeeze(1)
        if rows.numel():
            cols = count[rows].long()
            entered = axis0[rows] >= 0
            a = axis0[rows]
            t_ax = _sel3(a, tx[rows], ty[rows], tz[rows])
            td_ax = _sel3(a, tdx[rows], tdy[rows], tdz[rows])
            cells[rows, cols] = px[rows] | (py[rows] << 10) | (pz[rows] << 20)
            nd[rows, cols] = torch.where(entered, t_ax - td_ax, 0.0)
            ncode[rows, cols] = torch.where(entered, a, -1)
            if with_slots:
                w = word[rows]
                sc = (px[rows] // s + (py[rows] // s) * grid.supergrid_xy
                      + (pz[rows] // s) * grid.supergrid_xy ** 2).long()
                gslot = scene.pool_base[sc] + (w & BRICK_INDEX_BITS)
                slot[rows, cols] = torch.where(
                    (w & i32(BRICK_LOADED_BIT)) != 0, gslot, -1)
        count = count + occ0.to(_I32)
        alive = alive & (count < K)

        # Step (recording does not stop the ray), with the empty-space skip.
        skip_r = torch.clamp(((word >> BRICK_DIST_SHIFT) & 0x1FF) - 1, min=0)
        use_skip = alive & ~occ0 & (skip_r >= 1)
        rf = skip_r.to(_F32)
        t_exit = torch.minimum(
            torch.minimum(torch.where(dx != 0, tx + rf * tdx, BIG),
                          torch.where(dy != 0, ty + rf * tdy, BIG)),
            torch.where(dz != 0, tz + rf * tdz, BIG))

        def k_axis(d, tt, td):
            k = torch.where(
                d != 0.0,
                torch.floor((t_exit - tt) / torch.where(td == 0, 1.0, td))
                .to(_I32) + 1, 0)
            return torch.minimum(torch.clamp(k, min=0), skip_r + 1)

        ax = _sel_axis(tx, ty, tz)
        kx1, ky1, kz1 = ((ax == a).to(_I32) for a in range(3))
        kx = torch.where(use_skip, k_axis(dx, tx, tdx), kx1)
        ky = torch.where(use_skip, k_axis(dy, ty, tdy), ky1)
        kz = torch.where(use_skip, k_axis(dz, tz, tdz), kz1)
        stuck = use_skip & (kx + ky + kz == 0)
        kx = torch.where(stuck, kx1, kx)
        ky = torch.where(stuck, ky1, ky)
        kz = torch.where(stuck, kz1, kz)

        pxn, pyn, pzn = px + six * kx, py + siy * ky, pz + siz * kz
        txn = tx + kx.to(_F32) * tdx
        tyn = ty + ky.to(_F32) * tdy
        tzn = tz + kz.to(_F32) * tdz
        tlx = torch.where(kx > 0, txn - tdx, -BIG)
        tly = torch.where(ky > 0, tyn - tdy, -BIG)
        tlz = torch.where(kz > 0, tzn - tdz, -BIG)
        t_axis = torch.where(tlx > tly, torch.where(tlx > tlz, 0, 2),
                             torch.where(tly > tlz, 1, 2)).to(_I32)
        exited = (((dx > 0) & (pxn >= cx_max)) | ((dx < 0) & (pxn < 0))
                  | ((dy > 0) & (pyn >= cy_max)) | ((dy < 0) & (pyn < 0))
                  | ((dz > 0) & (pzn >= cz_max)) | ((dz < 0) & (pzn < 0)))
        stepping = alive
        alive = alive & ~exited
        px = torch.where(stepping, pxn, px)
        py = torch.where(stepping, pyn, py)
        pz = torch.where(stepping, pzn, pz)
        tx = torch.where(stepping, txn, tx)
        ty = torch.where(stepping, tyn, ty)
        tz = torch.where(stepping, tzn, tz)
        axis0 = torch.where(stepping, t_axis, axis0)

    out = dict(cells=cells, nd=nd, ncode=ncode, count=count, tminn=tminn,
               entry_normal=entry_normal, o_cells=o_cells, exhausted=alive,
               ray_words=ray_words, cells_read=cells_read[:n_cells])
    if with_slots:
        out["slot"] = slot
    return out
