"""The numbers that decide ``correct``: each compares what the program
produced with what the reference worked out from the same inputs.

Every function takes plain tensors and numbers; none reads the program's
state beyond the outputs it is handed.
"""

from __future__ import annotations

import statistics

import torch

from .config import BRICK_INDEX_BITS, i32

__all__ = ["world_cells_differ", "pixels_differ", "relative_gap",
           "leaf_gap", "PIXEL_ATOL", "PIXEL_RTOL", "LEAF_FLOOR"]

# A pixel agrees when every channel is within PIXEL_ATOL + PIXEL_RTOL * |ref|
# and its sample count is equal: the kernels are bit-equal to their plain
# versions on the card, so only a different world or a different path
# moves a pixel past this.
PIXEL_ATOL, PIXEL_RTOL = 1e-6, 1e-5
# Leaves whose first gradient in the reference is under this share of the
# median leaf's move under Adam by round-off alone: they are left out.
LEAF_FLOOR = 1e-3


def _rows(iv, pool_words, pool_base, grid, cells):
    s, sxy = grid.supergrid_cell_size, grid.supergrid_xy
    cz, cy, cx = iv.shape
    z, rem = cells // (cy * cx), cells % (cy * cx)
    y, x = rem // cx, rem % cx
    sc = (x // s) + (y // s) * sxy + (z // s) * sxy * sxy
    slot = pool_base[sc].long() + (iv.reshape(-1)[cells] & BRICK_INDEX_BITS)
    return pool_words[slot.clamp(0, pool_words.shape[0] - 1)]


def world_cells_differ(scene, world, grid, block: int = 1 << 22) -> int:
    """Brick cells whose index word (its flags, LoD byte and skip
    distance; not the slot, which shifts with any brick before it) or
    whose brick row differs between the program's ``scene`` and the
    reference's ``world``."""
    a, b = scene.index_volume, world.index_volume
    if a.shape != b.shape:
        return int(b.numel())
    keep = i32(~BRICK_INDEX_BITS & 0xFFFF_FFFF)
    fa, fb = a.reshape(-1), b.reshape(-1)
    bad = 0
    for start in range(0, fa.shape[0], block):
        wa, wb = fa[start:start + block], fb[start:start + block]
        differ = (wa & keep) != (wb & keep)
        both = ~differ & (wa < 0)           # loaded in both: bit 31
        cells = torch.nonzero(both).squeeze(1) + start
        ra = _rows(a, scene.pool_words, scene.pool_base, grid, cells)
        rb = _rows(b, world.pool_words, world.pool_base, grid, cells)
        bad += int(differ.sum()) + int((ra != rb).any(dim=1).sum())
    return bad


def pixels_differ(rgb, count, rgb_ref, count_ref) -> float:
    """The share of pixels whose colour or sample count differs."""
    tol = PIXEL_ATOL + PIXEL_RTOL * rgb_ref.abs()
    off = ((rgb - rgb_ref).abs() > tol) | (torch.isnan(rgb)
                                           != torch.isnan(rgb_ref))
    bad = off.any(dim=1) | (count != count_ref)
    return float(bad.sum()) / bad.shape[0]


def relative_gap(got: float, want: float) -> float:
    """|got - want| / |want| (|got - want| where want is 0)."""
    return abs(got - want) / abs(want) if want else abs(got - want)


def leaf_gap(got: list, want: list, ref_grads: list) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's;
    leaves whose reference gradient is under LEAF_FLOOR of the median
    leaf's are left out."""
    med_g = statistics.median(ref_grads)
    med = statistics.median(want)
    gaps = [abs(g - w) / max(w, med) if max(w, med) else abs(g - w)
            for g, w, rg in zip(got, want, ref_grads)
            if rg >= LEAF_FLOOR * med_g]
    return max(gaps) if gaps else 0.0
