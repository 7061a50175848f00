"""The world, built again: the simplex-fBm terrain and its two-level grid.

Frozen copies of ``brickmap_tpu_torch/noise.py`` (the NumPy heightfield,
written here as torch operations so that it runs on the card in well under
a second) and of ``brickmap_tpu_torch/scene.py``'s layer packing, slot
assignment and Chebyshev distance field.  The port evaluates the heights
with its native C++ library (``csrc/worldgen.cpp``, built with
``-march=native``), whose float rounding differs from this one's in a few
columns: the worlds agree brick for brick except there, which is what
``h100bench/reference/compare.py::world_cells_differ`` reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import bits
from .config import BRICK_DIST_SHIFT, GridConfig

__all__ = ["World", "terrain_heights", "build_world"]

# Ken Perlin's reference permutation table (noise.py's PERM).
PERM = [
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
]
_F2 = 0.366025403
_G2 = 0.211324865


@dataclass(frozen=True)
class World:
    """The three int32 tensors the traversal reads (the port's
    ``TorchScene`` without its optional fields)."""

    index_volume: torch.Tensor   # int32 [CZ, CY, CX]
    pool_words: torch.Tensor     # int32 [P, 16]
    pool_base: torch.Tensor      # int32 [num_superchunks]

    @property
    def device(self) -> torch.device:
        return self.index_volume.device

    @property
    def num_bricks(self) -> int:
        return self.pool_words.shape[0]


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _simplex2(x, y, perm):
    """noise.py's ``simplex2``, operation for operation in float32."""
    f32 = torch.float32
    dev = x.device
    s = (x + y) * _f32(_F2).to(dev)
    i = torch.floor(x + s).to(torch.int32)
    j = torch.floor(y + s).to(torch.int32)
    g2 = _f32(_G2).to(dev)
    t = (i + j).to(f32) * g2
    x0 = x - (i.to(f32) - t)
    y0 = y - (j.to(f32) - t)
    lower = x0 > y0
    i1 = lower.to(torch.int32)
    j1 = 1 - i1
    x1 = x0 - i1.to(f32) + g2
    y1 = y0 - j1.to(f32) + g2
    one, g22 = _f32(1.0).to(dev), _f32(2.0 * _G2).to(dev)
    x2 = x0 - one + g22
    y2 = y0 - one + g22

    def h(k):
        return perm[(k & 255).long()]

    gi0 = h(i + h(j))
    gi1 = h(i + i1 + h(j + j1))
    gi2 = h(i + 1 + h(j + 1))

    def grad2(hh, gx, gy):
        hh = hh & 0x3F
        low = hh < 4
        u = torch.where(low, gx, gy)
        v = torch.where(low, gy, gx)
        su = torch.where((hh & 1) != 0, -u, u)
        sv = torch.where((hh & 2) != 0, -2.0 * v, 2.0 * v)
        return su + sv

    def corner(gi, cx, cy):
        tt = _f32(0.5).to(dev) - cx * cx - cy * cy
        tt2 = tt * tt
        n = tt2 * tt2 * grad2(gi, cx, cy)
        return torch.where(tt < 0, torch.zeros((), device=dev), n)

    n = corner(gi0, x0, y0) + corner(gi1, x1, y1) + corner(gi2, x2, y2)
    return _f32(45.23065).to(dev) * n


def terrain_heights(grid: GridConfig, octaves: int = 8,
                    feature_scale: float = 2048.0, device="cuda",
                    rows_per_block: int = 512) -> torch.Tensor:
    """float32 [G, G] heights[y, x] = fbm(x / scale, y / scale) * H/2 + H/2
    (noise.py's ``terrain_height``), in blocks of rows."""
    g = grid.grid_size
    perm = torch.tensor(PERM, dtype=torch.int32, device=device)
    out = torch.empty((g, g), dtype=torch.float32, device=device)
    xs = torch.arange(g, dtype=torch.float32, device=device)
    scale = _f32(feature_scale).to(device)
    half = _f32(grid.grid_height / 2.0).to(device)
    for r0 in range(0, g, rows_per_block):
        wy, wx = torch.meshgrid(xs[r0:r0 + rows_per_block], xs,
                                indexing="ij")
        x, y = wx / scale, wy / scale
        acc, denom, freq, amp = None, 0.0, 1.0, 1.0
        for _ in range(octaves):
            f = _f32(freq).to(device)
            term = _f32(amp).to(device) * _simplex2(x * f, y * f, perm)
            acc = term if acc is None else acc + term
            denom += amp
            freq *= 2.0
            amp *= 0.5
        out[r0:r0 + rows_per_block] = (acc / _f32(denom).to(device)) * half \
            + half
    return out


def _column_counts(heights: torch.Tensor, brick_z0: int,
                   brick_size: int) -> torch.Tensor:
    """Solid-voxel count per column within one brick layer: voxel z is solid
    iff ``z + brick_z0 < h`` (Scene.cpp:90), so the count is
    ``clamp(ceil(h) - brick_z0, 0, brick_size)``."""
    return torch.clamp(torch.ceil(heights).to(torch.int32) - brick_z0,
                       0, brick_size)


def _pack_layer(counts: torch.Tensor, grid: GridConfig):
    """Pack one brick layer from per-column counts [G(y), G(x)] in [0, 8].

    Returns (words [CY, CX, 16] int32, lod [CY, CX] int32, nonempty [CY, CX]).
    Plane z of a brick is 64 bits = 2 words with bit ``x + 8*(y%4)``; word
    ``2z`` holds rows y < 4 (scene.py:150-163 of the JAX package).
    """
    b = grid.brick_size
    cy, cx = counts.shape[0] // b, counts.shape[1] // b
    c = counts.reshape(cy, b, cx, b).permute(0, 2, 1, 3)      # [CY, CX, y, x]
    shifts = torch.arange(32, device=counts.device, dtype=torch.int64)
    planes = [((c > z).reshape(cy, cx, 2, 32).to(torch.int64) << shifts).sum(-1)
              for z in range(b)]                              # [CY, CX, 2] each
    words = bits.wrap_i32(torch.stack(planes, 2).reshape(cy, cx,
                                                         grid.cell_members))

    # LoD byte: half-cell (hx, hy, hz) occupied iff any column of its 4x4 xy
    # block has count > hz*4; bit = hx + 2*hy + 4*hz (Scene.cpp:95).
    h = b // 2
    cmax = c.reshape(cy, cx, 2, h, 2, h).amax(dim=(3, 5))    # [CY, CX, hy, hx]
    lod = torch.zeros((cy, cx), dtype=torch.int32, device=counts.device)
    for hz in range(2):
        occ = cmax > hz * h
        for hy in range(2):
            for hx in range(2):
                lod |= occ[..., hy, hx].to(torch.int32) << (hx + 2 * hy + 4 * hz)
    nonempty = cmax.amax(dim=(2, 3)) > 0
    return words, lod, nonempty


def chebyshev_distance_field(nonempty: torch.Tensor,
                             cap: int = 511) -> torch.Tensor:
    """L-inf distance to the nearest non-empty cell, clamped to ``cap``, by
    iterated separable 3x3x3 dilation: a cell first covered at dilation k has
    distance k.  All cells within L-inf distance (d-1) of an empty cell with
    distance d are empty: the empty-space-skip radius."""
    dist = torch.full(nonempty.shape, cap, dtype=torch.int32,
                      device=nonempty.device)
    dist[nonempty] = 0
    cover = nonempty.clone()
    for k in range(1, cap + 1):
        if bool(cover.all()):
            break
        prev = cover
        for ax in range(3):
            a = cover
            n = a.shape[ax]
            left = torch.zeros_like(a)
            right = torch.zeros_like(a)
            left.narrow(ax, 0, n - 1).copy_(a.narrow(ax, 1, n - 1))
            right.narrow(ax, 1, n - 1).copy_(a.narrow(ax, 0, n - 1))
            cover = a | left | right
        dist[cover & ~prev] = k
    return dist


def _superchunk_major(a: torch.Tensor, grid: GridConfig) -> torch.Tensor:
    """[CZ, CY, CX, ...] -> [S, s^3, ...] in the reference's fill order:
    superchunks z-major, then (z, y, x) inside each (Scene.cpp:78-104)."""
    s, sxy, sz = grid.supergrid_cell_size, grid.supergrid_xy, grid.supergrid_z
    tail = a.shape[3:]
    r = a.reshape(sz, s, sxy, s, sxy, s, *tail)
    r = r.permute(0, 2, 4, 1, 3, 5, *range(6, r.dim()))
    return r.reshape(sz * sxy * sxy, s ** 3, *tail)


def _assemble(grid: GridConfig, words: torch.Tensor, lod: torch.Tensor,
              nonempty: torch.Tensor, residency: str):
    """Build index volume + linear pool from packed layers [CZ, CY, CX(, 16)].

    Slot within a superchunk = running count of non-empty bricks in fill order
    (the JAX package's stable argsort of ``sc_id * s^3 + local_rank``, whose
    keys are all distinct, so it is exactly this reshape)."""
    cz, cy, cx = grid.cells_height, grid.cells, grid.cells
    s, sxy, sz = grid.supergrid_cell_size, grid.supergrid_xy, grid.supergrid_z
    dev = nonempty.device

    ne_sorted = _superchunk_major(nonempty, grid)             # [S, s^3]
    csum = torch.cumsum(ne_sorted.to(torch.int64), dim=1)
    per_sc = csum[:, -1]
    if int(per_sc.max()) > 4096:
        raise ValueError("superchunk overflows the 12-bit slot space")
    pool_base = torch.zeros(grid.num_superchunks, dtype=torch.int64,
                            device=dev)
    pool_base[1:] = torch.cumsum(per_sc, 0)[:-1]
    slots = (csum - 1).reshape(sz, sxy, sxy, s, s, s).permute(
        0, 3, 1, 4, 2, 5).reshape(cz, cy, cx)

    pool = _superchunk_major(words, grid)[ne_sorted]          # [total, 16]
    if pool.shape[0] == 0:
        pool = torch.zeros((1, grid.cell_members), dtype=torch.int32,
                           device=dev)

    loaded = residency == "full"
    # Streaming init mirrors the reference (Scene.cpp:160): word = unloaded |
    # lod, slot assigned only once the brick becomes resident.
    packed = bits.pack_index_word(slots if loaded else torch.zeros_like(slots),
                                  lod, loaded=loaded, unloaded=not loaded)
    # Empty cells carry the Chebyshev skip distance in bits 28:20.
    dist = chebyshev_distance_field(nonempty)
    index_volume = torch.where(nonempty, packed, dist << BRICK_DIST_SHIFT)
    return index_volume, pool.contiguous(), pool_base.to(torch.int32)



def build_world(grid: GridConfig, device="cuda", quant=None) -> World:
    """The terrain world with every non-empty brick resident (the port's
    ``generate_terrain_scene`` with ``residency="full"``).  ``quant``, when
    given, rounds the heights (the control's lower precision)."""
    heights = terrain_heights(grid, device=device)
    if quant is not None:
        heights = quant(heights)
    layers = [_pack_layer(_column_counts(heights, czi * grid.brick_size,
                                         grid.brick_size), grid)
              for czi in range(grid.cells_height)]
    del heights
    words = torch.stack([w for w, _, _ in layers])
    lod = torch.stack([l for _, l, _ in layers])
    nonempty = torch.stack([ne for _, _, ne in layers])
    del layers
    return World(*_assemble(grid, words, lod, nonempty, "full"))
