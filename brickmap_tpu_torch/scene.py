"""Scene construction: two-level sparse voxel grid as torch tensors.

The port's counterpart of ``brickmap_tpu/scene.py``.  Flat tensors on one
device, no pointer chasing:

* ``index_volume`` — int32 ``[cells_z, cells_y, cells_x]`` packed index words
  (uint32 bit patterns; layout in :mod:`brickmap_tpu_torch.config`).
* ``pool_words``   — int32 ``[pool_capacity, 16]`` linear brick pool; a brick's
  global pool slot is ``pool_base[superchunk] + (word & 0xFFF)``.
* ``pool_base``    — int32 ``[num_superchunks]`` segment base offsets.

Worldgen evaluates the heightfield on the host (native C++ or NumPy) and runs
the rest — per-column counts, bit-plane packing, slot assignment and the
Chebyshev distance field — as torch ops on the scene's device.  The result is
bit-identical to ``brickmap_tpu.scene.generate_terrain_scene`` (tested).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from . import bits, noise
from .config import BRICK_DIST_SHIFT, BRICK_FLAG_BITS, BRICK_LOADED_BIT, \
    GridConfig, i32

__all__ = ["TorchScene", "generate_terrain_scene", "scene_from_dense",
           "scene_from_numpy", "fields_from_numpy", "to_numpy", "save_scene",
           "load_scene",
           "chebyshev_distance_field", "scene_summary"]


@dataclass(frozen=True)
class TorchScene:
    """Device-side scene: three flat int32 tensors on one device.

    ``occupancy`` / ``albedo`` are the optional differentiable fields of the
    JAX package's ``VoxelScene`` (per pool voxel, as that package stores
    them); ``None`` for the classic binary renderer.  They are carried and
    persisted, not read by the traversal.
    """

    index_volume: torch.Tensor   # int32 [CZ, CY, CX]
    pool_words: torch.Tensor     # int32 [P, 16]
    pool_base: torch.Tensor      # int32 [num_superchunks]
    occupancy: torch.Tensor | None = None   # e.g. float32 [P, 8, 8, 8]
    albedo: torch.Tensor | None = None      # e.g. float32 [P, 8, 8, 8, 3]

    @property
    def device(self) -> torch.device:
        return self.index_volume.device

    @property
    def num_bricks(self) -> int:
        return self.pool_words.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.index_volume, self.pool_words, self.pool_base))

    def to(self, device) -> "TorchScene":
        return TorchScene(*(None if t is None else t.to(device) for t in (
            self.index_volume, self.pool_words, self.pool_base,
            self.occupancy, self.albedo)))


# ---------------------------------------------------------------------------
# Worldgen
# ---------------------------------------------------------------------------

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


def _heights(grid: GridConfig, octaves: int, feature_scale: float,
             use_native: bool) -> np.ndarray:
    g = grid.grid_size
    heights = None
    if use_native:
        from . import native

        heights = native.terrain_heights(g, grid.grid_height, octaves,
                                         feature_scale)
    if heights is None:
        xs = np.arange(g, dtype=np.float32)
        wy, wx = np.meshgrid(xs, xs, indexing="ij")  # heights[y, x]
        heights = np.asarray(noise.terrain_height(
            wx, wy, grid.grid_height, octaves=octaves,
            feature_scale=feature_scale))
    return heights


def generate_terrain_scene(grid: GridConfig, residency: str = "full",
                           octaves: int = 8, feature_scale: float = 2048.0,
                           use_native: bool = True,
                           device="cuda") -> TorchScene:
    """Generate the simplex-fBm terrain world (Scene::generate semantics).

    residency="full": every non-empty brick resident with the loaded bit set.
    residency="streaming": index words start ``unloaded | lod`` like the
    reference's GPU init (Scene.cpp:157-175).

    The heightfield is evaluated on the host by the native library (NumPy
    fallback with ``use_native=False`` or without g++); everything after it
    runs on ``device``.
    """
    heights = torch.from_numpy(
        _heights(grid, octaves, feature_scale, use_native)).to(device)
    layers = [_pack_layer(_column_counts(heights, czi * grid.brick_size,
                                         grid.brick_size), grid)
              for czi in range(grid.cells_height)]
    del heights
    words = torch.stack([w for w, _, _ in layers])
    lod = torch.stack([l for _, l, _ in layers])
    nonempty = torch.stack([ne for _, _, ne in layers])
    del layers
    return TorchScene(*_assemble(grid, words, lod, nonempty, residency))


def scene_from_dense(dense, grid: GridConfig, residency: str = "full",
                     device="cuda") -> TorchScene:
    """Build a scene from a dense bool occupancy volume [Z, Y, X] (NumPy or
    torch; tests, IO, voxelized meshes).  Shapes must match ``grid``."""
    dense = torch.as_tensor(dense, device=device).to(torch.bool)
    gz, gy, gx = dense.shape
    if (gx, gy, gz) != (grid.grid_size, grid.grid_size, grid.grid_height):
        raise ValueError(f"dense shape {tuple(dense.shape)} does not match "
                         f"the grid ({grid.grid_height}, {grid.grid_size}, "
                         f"{grid.grid_size})")
    b = grid.brick_size
    blk = dense.reshape(grid.cells_height, b, grid.cells, b, grid.cells,
                        b).permute(0, 2, 4, 1, 3, 5)     # [CZ, CY, CX, z, y, x]
    words = bits.brick_words_from_dense(blk)
    lod = bits.lod_byte_from_dense(blk)
    nonempty = blk.reshape(*blk.shape[:3], -1).any(dim=-1)
    return TorchScene(*_assemble(grid, words, lod, nonempty, residency))


# ---------------------------------------------------------------------------
# Carrying state across packages, and persistence
# ---------------------------------------------------------------------------

def scene_from_numpy(index_volume, pool_words, pool_base,
                     device="cuda") -> TorchScene:
    """A TorchScene from the JAX package's ``VoxelScene`` arrays as NumPy
    (uint32 index words and pool, int32 bases), bit for bit."""
    def words(a):
        a = np.ascontiguousarray(a)
        if a.dtype not in (np.uint32, np.int32):
            raise TypeError(f"expected 32-bit words, got {a.dtype}")
        return torch.from_numpy(a.view(np.int32)).to(device)

    return TorchScene(words(index_volume), words(pool_words),
                      torch.from_numpy(np.ascontiguousarray(
                          pool_base, dtype=np.int32)).to(device))


def fields_from_numpy(occupancy, albedo, device="cuda"):
    """The differentiable renderer's fields (occupancy [..., 512] or a dense
    grid, albedo [..., 3]) from the JAX package's NumPy arrays, as float32
    tensors on ``device``."""
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) \
            .to(device)

    return f32(occupancy), f32(albedo)


def to_numpy(scene: TorchScene):
    """(index_volume uint32, pool_words uint32, pool_base int32) as NumPy: the
    inverse of :func:`scene_from_numpy`."""
    return (scene.index_volume.cpu().numpy().view(np.uint32),
            scene.pool_words.cpu().numpy().view(np.uint32),
            scene.pool_base.cpu().numpy())


def save_scene(path: str, scene: TorchScene) -> None:
    """Write the JAX package's ``.npz`` layout (same keys and dtypes), the
    optional ``occupancy``/``albedo`` fields included when present."""
    iv, pool, base = to_numpy(scene)
    arrays = {"index_volume": iv, "pool_words": pool, "pool_base": base}
    for name in ("occupancy", "albedo"):
        field = getattr(scene, name)
        if field is not None:
            arrays[name] = field.cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_scene(path: str, device="cuda") -> TorchScene:
    """Read an ``.npz`` of either package; fields keep their stored dtype."""
    with np.load(path) as data:
        scene = scene_from_numpy(data["index_volume"], data["pool_words"],
                                 data["pool_base"], device)
        fields = {name: torch.from_numpy(np.ascontiguousarray(data[name]))
                  .to(device) for name in ("occupancy", "albedo")
                  if name in data}
    return dataclasses.replace(scene, **fields)


def scene_summary(scene: TorchScene, grid: GridConfig) -> dict:
    """Residency statistics (Scene::dump analog, Scene.cpp:254-259): the JAX
    package's keys, ``per_superchunk_loaded`` as an int64 NumPy array
    ``[sz, sy, sx]``, plus the bytes of the scene's index tensors."""
    iv = scene.index_volume
    loaded = (iv & i32(BRICK_LOADED_BIT)) != 0
    s = grid.supergrid_cell_size
    cz, cy, cx = iv.shape
    per_sc = loaded.reshape(cz // s, s, cy // s, s, cx // s, s).sum(
        dim=(1, 3, 5), dtype=torch.int64)
    return {
        "num_bricks": scene.num_bricks,
        "nonempty_bricks": int(((iv & i32(BRICK_FLAG_BITS)) != 0).sum()),
        "loaded_bricks": int(loaded.sum()),
        "per_superchunk_loaded": per_sc.cpu().numpy(),
        "pool_bytes": scene.pool_words.numel() * 4,
        "resident_bytes": scene.nbytes,
    }
