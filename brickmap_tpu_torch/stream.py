"""Brick residency streaming over a :class:`~.scene.TorchScene`.

The port of ``brickmap_tpu/stream.py`` (the reference's C5-C8 pipeline,
SURVEY.md §2): traversal marks unloaded bricks with a per-ray request
(kernel B2's ``request``/``request_pos`` outputs, voxel.cuh:228-245); the
host pulls a wave's requests, dedupes them, services at most ``queue_size``
a wave (brick_load_queue_size = 1024, variables.h:35; the overflow is dropped
and requested again by later waves, voxel.cuh:237-240), grows each
superchunk's pool segment by powers of two (Scene.cpp:235-250) and installs
the payloads with O(requests) scatters into persistent device tensors
(kernel.cu:141-151's role).

The semantics are the JAX package's step for step, so the same request lists
leave the same residency state bit for bit: the same first-occurrence dedupe,
the same cap on raw request lanes before it, slots assigned in request
order.  What differs is mechanism: one device-to-host copy per pull, one
host-to-device copy per batch, and a pool re-based on the device by one
gather when a segment grows (the JAX package re-uploads its host mirror).
The truth scene's arrays stay on the host as NumPy, in the role of the
reference's CPU supergrid (Scene.h:19-29); the device holds only the index
volume and the resident bricks.  The JAX package's paged layout and
``block_words`` are TPU mechanisms that the port's B2 does not read.

:meth:`StreamingScene.reset` takes the residency back to cold (every brick
unloaded, each segment at its starting capacity) without reading the truth
again: a viewer that reopens its world or jumps to another region.  Spans
(``utils/profiling.py``): ``bm.stream.pull`` around the whole of
:func:`pull_requests` (its device-to-host copy in ``bm.sync.pull_requests``),
``bm.stream.plan``, ``bm.stream.install`` (the re-base inside it in
``bm.stream.rebase``) and ``bm.stream.reset``.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from .config import BRICK_DIST_MASK, BRICK_FLAG_BITS, BRICK_INDEX_BITS, \
    BRICK_LOADED_BIT, BRICK_LOD_BITS, BRICK_UNLOADED_BIT, GridConfig
from .scene import TorchScene
from .utils.profiling import annotate

__all__ = ["RequestRows", "StreamingScene", "compact_requests",
           "pull_requests"]


def compact_requests(mask: torch.Tensor, pos: torch.Tensor, cap: int):
    """The first ``cap`` requesting lanes of a wave, on the mask's device.

    ``mask`` bool [N] and ``pos`` int [N, 3] are a wave's ray-resolution
    request outputs, in row-major pixel order.  Returns ``(total, rows,
    valid)``: the number of requesting lanes (int64 scalar tensor), the
    ``pos`` rows of the first ``min(total, cap)`` of them in lane order
    (int32 [cap, 3], the rest filled with lane 0's row), and which rows are
    real (bool [cap]).  No host sync: the k-th requesting lane is found by a
    binary search of the mask's running count.
    """
    dev = mask.device
    n = mask.shape[0]
    running = torch.cumsum(mask.to(torch.int64), 0)
    total = running[-1] if n else torch.zeros((), dtype=torch.int64,
                                               device=dev)
    want = torch.arange(1, cap + 1, dtype=torch.int64, device=dev)
    lanes = torch.searchsorted(running, want)
    valid = want <= total
    rows = pos[torch.where(valid, lanes, 0)] if n else torch.zeros(
        (cap, 3), dtype=torch.int32, device=dev)
    return total, rows.to(torch.int32), valid


class RequestRows(Sequence):
    """A wave's pulled requests as int32 [n, 3] rows, read-only, with the
    contract of a list of (x, y, z) tuples of Python ints: ``len``, an
    index gives a tuple (a slice a list of them), iteration gives tuples
    built lazily, ``==`` compares as a list of tuples, and
    ``np.asarray`` gives the rows themselves, with no copy.  The rows make
    no Python object a lane until a caller iterates or indexes them.
    """

    __slots__ = ("_rows",)
    __hash__ = None

    def __init__(self, rows: np.ndarray):
        rows = rows.reshape(-1, 3)
        rows.flags.writeable = False
        self._rows = rows

    def __len__(self) -> int:
        return self._rows.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(map(tuple, self._rows[i].tolist()))
        return tuple(self._rows[i].tolist())

    def __iter__(self):
        return map(tuple, self._rows.tolist())

    def __eq__(self, other):
        if not isinstance(other, Sequence):
            return NotImplemented
        return list(self) == list(other)

    def __array__(self, dtype=None, copy=None):
        rows = self._rows
        if dtype is None or np.dtype(dtype) == rows.dtype:
            return rows.copy() if copy else rows
        if copy is False:
            raise ValueError(f"the rows are {rows.dtype}: {np.dtype(dtype)} "
                             "needs a copy")
        return rows.astype(dtype)

    def __repr__(self) -> str:
        return f"RequestRows({self._rows.tolist()!r})"


def pull_requests(req: dict, queue_size: int = 1024) -> RequestRows:
    """The (x, y, z) brick coordinates a wave requested, as the host's
    int32 rows in lane order (:class:`RequestRows`, which reads like a list
    of tuples and hands :meth:`StreamingScene.plan` the array itself).

    Takes the first ``4 * queue_size`` requesting lanes in lane order (the
    JAX package's cap on raw lanes, ahead of the manager's dedupe), with one
    device-to-host copy: the count and the rows travel in one int32 tensor.
    """
    with annotate("bm.stream.pull"):
        cap = 4 * queue_size
        total, rows, _ = compact_requests(req["mask"], req["pos"], cap)
        packed = torch.cat([torch.clamp(total, max=cap).to(torch.int32).view(
            1), rows.reshape(-1)])
        with annotate("bm.sync.pull_requests"):
            packed = packed.cpu().numpy()
        return RequestRows(packed[1:1 + 3 * int(packed[0])])


def _u32(mask: int) -> np.uint32:
    return np.uint32(mask)


@dataclass
class RequestBatch:
    """One serviced batch, planned on the host (:meth:`StreamingScene.plan`)
    and installed on the device (:meth:`StreamingScene.install`).

    ``rows`` is int32 [n, cell_members + 3]: each brick's payload words,
    then its flat index-volume cell, its new index word and its global pool
    row, so that one host-to-device copy carries the whole batch.
    """

    rows: np.ndarray
    grew: bool             # a segment grew: re-base the pool first
    old_base: np.ndarray   # int64 [S] segment bases before the growth
    kept: np.ndarray       # int64 [S] resident bricks before the batch

    @property
    def size(self) -> int:
        return self.rows.shape[0]


class StreamingScene:
    """Host-side residency manager around persistent device tensors.

    ``truth`` is a fully built scene on any device (every brick's payload and
    slot known).  The managed scene starts with every non-empty brick
    ``unloaded | lod`` and no payloads, and empty cells keep their skip
    distance (Scene.cpp:157-175); each superchunk's segment starts at
    ``starting_capacity`` rows.  :meth:`device_scene` is the scene to trace
    on ``device``; call it again after :meth:`process_requests` and
    :meth:`reset`, which may replace the pool tensor.

    Totals, host integers: ``total_requests`` (request lanes handed to
    :meth:`plan`), ``total_listed`` (those of them :meth:`plan` had to
    build from Python objects, not take as an array: 0 where every batch
    comes from :func:`pull_requests`), ``total_uploaded``,
    ``total_dropped`` (distinct unloaded bricks beyond the cap),
    ``total_rebases`` (batches whose segment growth re-based the pool) and
    ``total_rebased_rows`` (the resident rows those re-bases moved) count
    since the last :meth:`reset`; ``total_resets`` counts the resets.
    ``total_listed`` and ``total_rebased_rows`` are no part of
    :meth:`state`.
    """

    def __init__(self, truth: TorchScene, grid: GridConfig,
                 queue_size: int = 1024, starting_capacity: int = 16,
                 device="cuda"):
        self.grid = grid
        self.queue_size = queue_size
        self.device = torch.device(device)
        self._truth_iv = truth.index_volume.cpu().numpy().view(np.uint32)
        self._truth_pool = truth.pool_words.cpu().numpy().view(np.uint32)
        self._truth_base = truth.pool_base.cpu().numpy().astype(np.int64)

        iv = self._truth_iv
        nonempty = (iv & _u32(BRICK_FLAG_BITS)) != 0
        self._iv = np.where(nonempty,
                            _u32(BRICK_UNLOADED_BIT) | (iv & _u32(
                                BRICK_LOD_BITS)),
                            iv & _u32(BRICK_DIST_MASK)).astype(np.uint32)

        self.starting_capacity = starting_capacity
        self._clear_residency()
        self.total_resets = 0

        dev = self.device
        self._dev_iv = torch.from_numpy(self._iv.view(np.int32)).to(
            dev, copy=True)
        self._dev_pool = self._empty_pool()
        self._dev_base = torch.from_numpy(self.pool_base).to(dev, copy=True)

    def _clear_residency(self) -> None:
        """The host's segments and totals as they are cold."""
        s = self.grid.num_superchunks
        self.capacity = np.full(s, self.starting_capacity, np.int64)
        self.highest = np.zeros(s, np.int64)      # gpu_index_highest
        self._rebase()
        self._loaded = []   # the cells each batch loaded, int32 arrays
        self.total_requests = 0
        self.total_listed = 0
        self.total_uploaded = 0
        self.total_dropped = 0
        self.total_rebases = 0
        self.total_rebased_rows = 0

    def _empty_pool(self) -> torch.Tensor:
        return torch.zeros((self._padded_total(), self.grid.cell_members),
                           dtype=torch.int32, device=self.device)

    def reset(self) -> None:
        """Every brick unloaded again and every segment back at
        ``starting_capacity`` rows: afterwards :meth:`state` equals a fresh
        manager's over the same truth, the totals cleared, except
        ``total_resets``, which counts this reset.

        The truth is not read: the words of the cells loaded since the last
        reset go back to ``unloaded | lod`` (the LoD byte is kept in the
        loaded word), so the host's work is O(bricks loaded), and the
        device's is one copy and scatter of those words plus a new zeroed
        pool."""
        with annotate("bm.stream.reset"):
            if self._loaded:
                cells = np.concatenate(self._loaded)
                flat = self._iv.reshape(-1)
                words = _u32(BRICK_UNLOADED_BIT) | (flat[cells]
                                                     & _u32(BRICK_LOD_BITS))
                flat[cells] = words
                rows = torch.from_numpy(np.stack(
                    [cells, words.view(np.int32)])).to(self.device)
                self._dev_iv.view(-1).index_copy_(0, rows[0].long(), rows[1])
            self._clear_residency()
            self.total_resets += 1
            self._dev_pool = self._empty_pool()
            self._dev_base.copy_(torch.from_numpy(self.pool_base))

    # -- bookkeeping --------------------------------------------------------

    def _padded_total(self) -> int:
        """Pool rows: the segments' capacities summed and padded to a power
        of two of at least 16, so the pool's shape changes only on the
        log-many global doublings (the JAX package's layout)."""
        total = int(self.capacity.sum())
        return int(2 ** np.ceil(np.log2(max(total, 16))))

    def _rebase(self) -> None:
        self.pool_base = np.zeros(self.grid.num_superchunks, np.int32)
        self.pool_base[1:] = np.cumsum(self.capacity)[:-1].astype(np.int32)

    def _sc_id(self, x, y, z):
        s = self.grid.supergrid_cell_size
        return (x // s + (y // s) * self.grid.supergrid_xy
                + (z // s) * self.grid.supergrid_xy ** 2)

    def device_scene(self) -> TorchScene:
        """The current scene on the device (persistent tensors)."""
        return TorchScene(self._dev_iv, self._dev_pool, self._dev_base)

    @property
    def pool_rows(self) -> int:
        return self._dev_pool.shape[0]

    # -- the per-frame CPU half (Scene::process_load_queue) -----------------

    def process_requests(self, requests) -> int:
        """Service up to ``queue_size`` brick requests; returns uploads done.

        ``requests``: (x, y, z) brick coordinates in request order: the
        rows of :func:`pull_requests`, any array of [n, 3], or an iterable
        of triples.  Duplicates, resident and empty bricks are
        ignored; distinct bricks beyond the cap are dropped and counted in
        ``total_dropped`` (later waves request them again).
        """
        batch = self.plan(requests)
        if batch is not None:
            self.install(batch)
        return 0 if batch is None else batch.size

    def plan(self, requests) -> RequestBatch | None:
        """The host half of :meth:`process_requests`: dedupe, cap, slot
        assignment, segment growth and the payloads from the truth.  Updates
        the host bookkeeping; :meth:`install` must follow with the batch."""
        with annotate("bm.stream.plan"):
            if hasattr(requests, "__array__"):
                req = np.asarray(requests, np.int64).reshape(-1, 3)
            else:
                req = np.asarray(list(requests), np.int64).reshape(-1, 3)
                self.total_listed += req.shape[0]
            self.total_requests += req.shape[0]
            cz, cy, cx = self._iv.shape
            if ((req < 0) | (req >= np.array([cx, cy, cz]))).any():
                raise ValueError("a request lies outside the brick grid")
            lin = (req[:, 2] * cy + req[:, 1]) * cx + req[:, 0]
            _, first = np.unique(lin, return_index=True)
            lin = lin[np.sort(first)]              # first-occurrence order
            unloaded = self._iv.reshape(-1)[lin] & _u32(BRICK_UNLOADED_BIT)
            lin = lin[unloaded != 0]
            self.total_dropped += max(lin.shape[0] - self.queue_size, 0)
            lin = lin[:self.queue_size]
            n = lin.shape[0]
            if n == 0:
                return None

            # Slot assignment in request order + pow-2 segment growth
            # (Scene.cpp:222-250).
            z, rem = np.divmod(lin, cy * cx)
            y, x = np.divmod(rem, cx)
            scs = self._sc_id(x, y, z)
            kept = self.highest.copy()
            order = np.argsort(scs, kind="stable")
            ranked = scs[order]
            group_start = np.searchsorted(ranked, ranked)
            slots = np.empty(n, np.int64)
            slots[order] = kept[ranked] + np.arange(n) - group_start
            self.highest += np.bincount(scs, minlength=self.highest.shape[0])
            grow = self.highest > self.capacity
            old_base = self.pool_base.astype(np.int64)
            if grow.any():
                self.capacity[grow] = (2 ** np.ceil(np.log2(
                    self.highest[grow]))).astype(np.int64)
                self._rebase()

            twords = self._truth_iv.reshape(-1)[lin]
            tslots = self._truth_base[scs] + (twords & _u32(BRICK_INDEX_BITS))
            new_words = (_u32(BRICK_LOADED_BIT)
                         | (twords & _u32(BRICK_LOD_BITS))
                         | slots.astype(np.uint32))
            self._iv.reshape(-1)[lin] = new_words
            self._loaded.append(lin.astype(np.int32))
            rows = np.empty((n, self.grid.cell_members + 3), np.int32)
            rows[:, :-3] = self._truth_pool[tslots].view(np.int32)
            rows[:, -3] = lin
            rows[:, -2] = new_words.view(np.int32)
            rows[:, -1] = self.pool_base[scs] + slots
            self.total_uploaded += n
            return RequestBatch(rows, bool(grow.any()), old_base, kept)

    def install(self, batch: RequestBatch) -> None:
        """The device half of :meth:`process_requests`: one host-to-device
        copy of the batch, the pool re-based if a segment grew, then the
        index words and payload rows scattered in place."""
        with annotate("bm.stream.install"):
            dev = self.device
            rows = torch.from_numpy(batch.rows).to(dev)
            if batch.grew:
                self._rebase_device(batch.old_base, batch.kept)
            self._dev_iv.view(-1).index_copy_(0, rows[:, -3].long(),
                                              rows[:, -2])
            self._dev_pool.index_copy_(0, rows[:, -1].long(), rows[:, :-3])

    def _rebase_device(self, old_base: np.ndarray, kept: np.ndarray) -> None:
        """Move every segment's resident rows to its new base (every segment
        moves, grown or not: the bases are a running sum) with one gather
        from the old pool into a new zeroed one."""
        with annotate("bm.stream.rebase"):
            dev = self.device
            n_kept = int(kept.sum())
            pool = self._empty_pool()
            if n_kept:
                meta = torch.from_numpy(np.stack([
                    kept, old_base, self.pool_base.astype(np.int64),
                    np.cumsum(kept) - kept])).to(dev)
                sc = torch.repeat_interleave(
                    torch.arange(kept.shape[0], device=dev), meta[0],
                    output_size=n_kept)
                offset = torch.arange(n_kept, device=dev) - meta[3][sc]
                pool[meta[2][sc] + offset] = self._dev_pool[meta[1][sc]
                                                            + offset]
            self._dev_pool = pool
            self._dev_base.copy_(torch.from_numpy(self.pool_base))
            self.total_rebases += 1
            self.total_rebased_rows += n_kept

    # -- diagnostics --------------------------------------------------------

    def dump(self) -> np.ndarray:
        """Per-superchunk resident-brick counts (Scene::dump,
        Scene.cpp:254)."""
        return self.highest.copy()

    def truth_arrays(self) -> tuple:
        """The truth the payloads come from, as the host holds it (no
        copy): index volume (uint32 [CZ, CY, CX]), pool rows (uint32
        [P, cell_members]) and segment bases (int64 [S])."""
        return self._truth_iv, self._truth_pool, self._truth_base

    def fully_resident(self) -> bool:
        return not ((self._iv & _u32(BRICK_UNLOADED_BIT)) != 0).any()

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A NumPy copy of ``t`` (``.cpu()`` of a CPU tensor is the tensor
        itself, whose later scatters a snapshot must not see)."""
        return t.to("cpu", copy=True).numpy()

    def state(self) -> dict:
        """NumPy copies of the residency state: the device's index volume
        (uint32), pool rows (uint32) and bases, and the host's capacities,
        resident counts and totals (as the class docstring says)."""
        return {
            "index_volume": self._host(self._dev_iv).view(np.uint32),
            "pool_words": self._host(self._dev_pool).view(np.uint32),
            "pool_base": self._host(self._dev_base),
            "capacity": self.capacity.copy(),
            "highest": self.highest.copy(),
            "total_requests": self.total_requests,
            "total_uploaded": self.total_uploaded,
            "total_dropped": self.total_dropped,
            "total_rebases": self.total_rebases,
            "total_resets": self.total_resets,
        }

    def surface_stats(self) -> dict:
        """Residency against the surface and reachable brick sets.

        The reference's locality property: "only bricks that lay on the
        surface of a superchunk will be loaded since rays won't penetrate
        into the inside" (README.md:7).  ``surface``: a 6-neighbour cell is
        empty.  ``reachable``: a 6-neighbour cell is empty or partly filled
        (a ray passes through its gaps).  A loaded brick with six completely
        solid neighbours is unreachable: ``loaded_unreachable`` must be 0.
        Out-of-world neighbours count as empty.
        """
        iv = self._truth_iv
        nonempty = (iv & _u32(BRICK_FLAG_BITS)) != 0
        full = np.zeros_like(nonempty)
        zz, yy, xx = np.nonzero(nonempty)
        rows = self._truth_base[self._sc_id(xx, yy, zz)] + (
            iv[zz, yy, xx] & _u32(BRICK_INDEX_BITS))
        full_row = (self._truth_pool == _u32(0xFFFF_FFFF)).all(axis=1)
        full[zz, yy, xx] = full_row[rows]

        def any_neighbor(pred):
            out = np.zeros_like(pred)
            for axis in range(3):
                for side in (-1, 1):
                    nb = np.ones_like(pred)
                    src = [slice(None)] * 3
                    dst = [slice(None)] * 3
                    src[axis] = slice(1, None) if side > 0 \
                        else slice(None, -1)
                    dst[axis] = slice(None, -1) if side > 0 \
                        else slice(1, None)
                    nb[tuple(dst)] = pred[tuple(src)]
                    out |= nb
            return out

        surface = nonempty & any_neighbor(~nonempty)
        reachable = nonempty & any_neighbor(~full)
        loaded = (self._iv & _u32(BRICK_LOADED_BIT)) != 0
        return {
            "loaded_total": int(loaded.sum()),
            "loaded_surface": int((loaded & surface).sum()),
            "loaded_reachable": int((loaded & reachable).sum()),
            "loaded_unreachable": int((loaded & ~reachable).sum()),
            "surface_total": int(surface.sum()),
            "reachable_total": int(reachable.sum()),
            "nonempty_total": int(nonempty.sum()),
        }
