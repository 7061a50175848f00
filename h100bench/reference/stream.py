"""Brick streaming as the reference renderer defines it, written out plainly.

Written from the reference's semantics (stijnherfst/BrickMap; SURVEY.md
C6-C8), not from the port's ``stream.py``.  A frame's traversal marks each
unloaded brick a ray meets and queues a request (voxel.cuh:228-245); after
the kernels the host reads the requests, stages the payloads and grows each
superchunk's pool segment to the next power of two (Scene.cpp:200-252);
``upload`` scatters the batch on the device (kernel.cu:141-151).  Where the
reference's queue order is that of its atomics, the order here is
deterministic, as the port's contract states it:

* :func:`pull`: the first ``4 * queue`` requesting lanes in lane order
  (row-major pixels);
* :class:`Manager`: those requests deduplicated by first occurrence, the
  unloaded ones kept up to ``queue`` (the rest dropped, to be asked for
  again), slots given in request order within each superchunk, each
  segment grown to the next power of two that holds its bricks, bases the
  running sum of the capacities, and each installed brick's index word and
  payload the truth's;
* :func:`wave`: ``view.wave``'s sample wave, also returning the wave's
  request mask and positions (pixel order).

The pool's row count is the port's layout, which the comparison of shapes
needs: the capacities' sum padded to a power of two of at least 16.
Plain Python, NumPy and torch; nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import BRICK_DIST_MASK, BRICK_FLAG_BITS, BRICK_INDEX_BITS, \
    BRICK_LOADED_BIT, BRICK_LOD_BITS, BRICK_UNLOADED_BIT, BrickmapConfig, \
    GridConfig
from .view import _trace
from .wave import new_state, primary_plain, shade_plain
from .world import World

__all__ = ["pull", "Manager", "wave", "state_differ", "requests_differ",
           "TOTALS"]

TOTALS = ("total_requests", "total_uploaded", "total_dropped",
          "total_rebases")


def pull(req: dict, queue: int) -> list:
    """The (x, y, z) bricks of a wave's first ``4 * queue`` requesting
    lanes, in lane order (``req["mask"]`` bool [N], ``req["pos"]`` [N, 3])."""
    lanes = torch.nonzero(req["mask"]).squeeze(1)[:4 * queue]
    return [tuple(int(c) for c in p) for p in req["pos"][lanes].tolist()]


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Manager:
    """Residency over a truth held as NumPy: ``truth_iv`` uint32 [CZ, CY,
    CX], ``truth_pool`` uint32 [P, cell_members], ``truth_base`` [S]."""

    def __init__(self, truth_iv, truth_pool, truth_base, grid: GridConfig,
                 queue: int, starting_capacity: int):
        self.grid, self.queue = grid, queue
        self.starting_capacity = starting_capacity
        self.shape = truth_iv.shape
        self.truth_iv = np.asarray(truth_iv, np.uint32).reshape(-1)
        self.truth_pool = np.asarray(truth_pool, np.uint32)
        self.truth_base = np.asarray(truth_base, np.int64)
        # Cold words (Scene.cpp:157-175): a non-empty brick is unloaded with
        # its LoD byte, an empty cell keeps its skip distance.
        flags = self.truth_iv & np.uint32(BRICK_FLAG_BITS)
        self.cold = np.where(
            flags != 0,
            np.uint32(BRICK_UNLOADED_BIT)
            | (self.truth_iv & np.uint32(BRICK_LOD_BITS)),
            self.truth_iv & np.uint32(BRICK_DIST_MASK)).astype(np.uint32)
        self.reset()

    def reset(self) -> None:
        """Cold: every brick unloaded, each segment at its starting
        capacity, the totals zero."""
        self.iv = self.cold.copy()
        s = self.grid.num_superchunks
        self.capacity = np.full(s, self.starting_capacity, np.int64)
        self.highest = np.zeros(s, np.int64)
        self.installed: list = []       # (superchunk, slot, truth row)
        self.totals = dict.fromkeys(TOTALS, 0)

    def _cell(self, x: int, y: int, z: int) -> int:
        cz, cy, cx = self.shape
        return (z * cy + y) * cx + x

    def _superchunk(self, x: int, y: int, z: int) -> int:
        s, sxy = self.grid.supergrid_cell_size, self.grid.supergrid_xy
        return x // s + (y // s) * sxy + (z // s) * sxy * sxy

    def _distinct(self, requests) -> list:
        """The requests deduplicated, each at its first occurrence."""
        seen, out = set(), []
        for r in requests:
            if r not in seen:
                seen.add(r)
                out.append(r)
        return out

    def _unloaded(self, bricks) -> list:
        return [b for b in bricks
                if self.iv[self._cell(*b)] & np.uint32(BRICK_UNLOADED_BIT)]

    def process(self, requests) -> int:
        """Service one frame's pulled requests; returns the bricks
        installed."""
        requests = [tuple(int(c) for c in r) for r in requests]
        self.totals["total_requests"] += len(requests)
        wanted = self._unloaded(self._distinct(requests))
        self.totals["total_dropped"] += max(len(wanted) - self.queue, 0)
        wanted = wanted[:self.queue]
        grew = False
        for x, y, z in wanted:
            cell, sc = self._cell(x, y, z), self._superchunk(x, y, z)
            slot = int(self.highest[sc])
            self.highest[sc] += 1
            if self.highest[sc] > self.capacity[sc]:
                self.capacity[sc] = _pow2_at_least(int(self.highest[sc]))
                grew = True
            word = int(self.truth_iv[cell])
            self.iv[cell] = np.uint32(BRICK_LOADED_BIT | (word & BRICK_LOD_BITS)
                                      | slot)
            self.installed.append(
                (sc, slot, int(self.truth_base[sc]) + (word & BRICK_INDEX_BITS)))
        self.totals["total_uploaded"] += len(wanted)
        self.totals["total_rebases"] += int(grew)
        return len(wanted)

    def state(self) -> dict:
        """The residency state in the keys of the port's ``state()``."""
        base = np.zeros(self.grid.num_superchunks, np.int64)
        base[1:] = np.cumsum(self.capacity)[:-1]
        rows = _pow2_at_least(max(int(self.capacity.sum()), 16))
        pool = np.zeros((rows, self.grid.cell_members), np.uint32)
        if self.installed:
            sc, slot, row = (np.array(c, np.int64)
                             for c in zip(*self.installed))
            pool[base[sc] + slot] = self.truth_pool[row]
        return {"index_volume": self.iv.reshape(self.shape).copy(),
                "pool_words": pool, "pool_base": base.astype(np.int32),
                "capacity": self.capacity.copy(),
                "highest": self.highest.copy(), **self.totals}

    def world(self, device) -> World:
        """The state as a :class:`~.world.World` on ``device``."""
        st = self.state()
        return World(*(torch.from_numpy(st[k].view(np.int32)).to(device)
                       for k in ("index_volume", "pool_words", "pool_base")))


def wave(world, pixels, uniforms: dict, camera_arrays: dict, cam_brick,
         cfg: BrickmapConfig, width: int, height: int, quant=None):
    """``view.wave`` over every pixel (``pixels`` the tile permutation),
    returning (rgb [W*H, 3], count, traced, exhausted, req) with ``req``'s
    ``mask`` and ``pos`` in row-major pixel order."""
    n = pixels.shape[0]
    sun_dir = camera_arrays["sun_direction"]
    st = new_state(n, world.device)
    primary_plain(pixels, uniforms, camera_arrays, width, height, st)

    def rounded(keys):
        if quant is not None:
            for k in keys:
                st[k].copy_(quant(st[k]))

    rounded(("rays_o", "rays_d"))
    for bounce in range(cfg.render.max_bounces + 1):
        res = _trace(st, world, cam_brick, cfg, quant, [])
        shade_plain(bounce, st, res, uniforms["cone"][bounce],
                    uniforms["hemi"][bounce], sun_dir, cfg)
        rounded(("rays_o", "rays_d", "accum", "sh_color"))
    res = _trace(st, world, cam_brick, cfg, quant, [])
    rgb, count, req = shade_plain(cfg.render.max_bounces + 1, st, res, None,
                                  None, sun_dir, cfg, final=True, dst=pixels)
    if quant is not None:
        rgb = quant(rgb)
    return (rgb, count, int(req["traced_rays"]), int(req["exhausted_rays"]),
            req)


def _differ(a, b) -> int:
    """Entries that differ between two flat arrays, the longer one's extra
    entries counted as differing."""
    a = np.asarray(a).astype(np.int64).reshape(-1)
    b = np.asarray(b).astype(np.int64).reshape(-1)
    n = min(a.shape[0], b.shape[0])
    return int((a[:n] != b[:n]).sum()) + abs(a.shape[0] - b.shape[0])


def state_differ(got: dict, want: dict) -> int:
    """Index words, pool rows (a row differs where any word does), bases,
    capacities, resident counts and totals that differ between two
    residency states."""
    n = sum(_differ(got[k], want[k])
            for k in ("index_volume", "pool_base", "capacity", "highest"))
    pa, pb = np.asarray(got["pool_words"]), np.asarray(want["pool_words"])
    m = min(pa.shape[0], pb.shape[0])
    n += int((pa[:m] != pb[:m]).any(axis=1).sum()) + abs(pa.shape[0]
                                                         - pb.shape[0])
    return n + sum(int(got.get(k) != want[k]) for k in TOTALS)


def requests_differ(got: list, want: list) -> float:
    """The share of positions at which two pulled lists differ, over the
    longer one's length (0 where both are empty)."""
    n = max(len(got), len(want))
    if n == 0:
        return 0.0
    same = sum(tuple(a) == tuple(b) for a, b in zip(got, want))
    return (n - same) / n
