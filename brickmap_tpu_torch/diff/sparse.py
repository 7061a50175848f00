"""Differentiable rendering over the sparse brick pool: record, then replay.

The port of ``brickmap_tpu/diff/sparse.py``.  Two phases:

1. **Record** (no gradient): kernel B3 lists each ray's first K occupied
   cells front to back (:func:`brickmap_tpu_torch.kernels.record.
   record_segments`).
2. **Replay** (differentiable): per segment, the in-brick DDA's visited
   voxels come from closed-form geometry (:func:`_segment_geom`), their soft
   occupancy and albedo from the pool fields, and the compositor

       w_i = T * occ_i,   T <- T * (1 - occ_i),   rgb += w_i * albedo_i

   has an analytic, division-free backward (:class:`_CompositeCore`).

The loss path (:func:`l2_loss_and_grads_sparse`) replays at brick-row
granularity over the voxel-interleaved fields ``field4 [P*512, 4]``, in
slices of at most 16,384 rays, each four kernel launches
(:func:`_row_chunk_grad`): R1 computes every segment's pool slot and
visited voxels, B4f reads their four values straight from the pool (one
16-byte load each), R2 composites each ray and takes the analytic backward
of its squared error, and B4b adds the cotangents into the field gradient
in place (one 16-byte atomic each).  No ``[4*512]`` row per segment is
gathered, and no row gradient is written or index-added.  A slice's largest
buffers are the ``[C*K, 4*nvox]`` values and their cotangents (46 MB each
at K = 8).  The voxel-granular replay (``row_replay=False``, autograd
through :class:`_CompositeCore`) is the oracle the row replay is held
against.

The fields' one layout is ``field4`` (``diff/field4.py``): occupancy and
albedo are its column views ``S[:, 0]`` and ``S[:, 1:]``, as every maker of
sparse fields in the program returns them.  The replay reads ``S`` itself,
with no copy, and the gradients come back as the same views of the one
``dfield``, scaled in place.  Fields from outside the program are packed
into a new ``field4`` by a cat.

Left out of the JAX module: the ``traced`` branches and ``_scan_grad_acc``
(they serve ``jit`` and ``shard_map``) and the bucket rounding of the live
prefix (it bounded XLA recompiles).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import bits
from ..config import BRICK_INDEX_BITS, BRICK_LOADED_BIT, GridConfig, i32
from ..kernels.extract import extract_bwd, extract_field, extract_fwd
from ..kernels.record import record_segments
from ..kernels.replay import composite_sse, segment_geom
from ..ops.replay import ray_sse_plain
from ..ops.replay import segment_visits as _segment_geom
from ..utils.profiling import annotate
from .field4 import field4_of, field4_views, new_fields

__all__ = ["cell_pool_map", "pool_fields_from_bitmask", "composite_sparse",
           "l2_loss_and_grads_sparse"]

_F32, _I32 = torch.float32, torch.int32


def _clip01(x):
    """``jnp.clip(x, 0, 1)`` with its gradient: half the cotangent at a bound
    (``torch.maximum``/``minimum`` split ties as ``lax.max``/``min`` do)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def cell_pool_map(scene, grid: GridConfig) -> torch.Tensor:
    """int32 [CZ, CY, CX] on the scene's device: brick cell -> global pool
    row (-1 where no brick is loaded)."""
    iv = scene.index_volume
    cz, cy, cx = iv.shape
    s, sxy = grid.supergrid_cell_size, grid.supergrid_xy
    dev = iv.device
    zz = torch.arange(cz, device=dev)[:, None, None] // s
    yy = torch.arange(cy, device=dev)[None, :, None] // s
    xx = torch.arange(cx, device=dev)[None, None, :] // s
    sc = xx + yy * sxy + zz * sxy * sxy
    slot = scene.pool_base[sc] + (iv & BRICK_INDEX_BITS)
    return torch.where((iv & i32(BRICK_LOADED_BIT)) != 0, slot, -1).to(_I32)


def pool_fields_from_bitmask(scene):
    """Initial (occupancy [P,512], albedo [P,512,3]) float32 from the hard
    bitmask, on the scene's device, as the views of one new ``field4``:
    the binarised start whose render equals the hard renderer, albedo 1.
    Voxel v = x + 8y + 64z, the raveled (z, y, x)."""
    words = scene.pool_words
    p = words.shape[0]
    occ, alb = new_fields(p, words.device)
    occ.copy_(bits.dense_from_brick_words(words).reshape(p, 512))
    alb.fill_(1.0)
    return occ, alb


def _segment_gidx(oc, dc, cells, nds, ncodes, enorm, cellmap,
                  grid: GridConfig, k_segments: int, pvox: int):
    """Flat voxel ids [C, K*nvox] + step-valid mask (voxel-granular form)."""
    bsz = grid.brick_size
    nvox = 3 * bsz - 2
    slots, lin, mask = _segment_geom(oc, dc, cells, nds, ncodes, enorm,
                                     cellmap, grid, k_segments)
    gidx = torch.clamp(slots[:, :, None] * (bsz ** 3) + lin, 0, pvox - 1)
    c = slots.shape[0]
    return gidx.reshape(c, k_segments * nvox), \
        mask.reshape(c, k_segments * nvox)


def _suffix(occ_v, s, g):
    """S_{i+1} for i = 0..V-1 of S_i = occ_i s_i + (1 - occ_i) S_{i+1},
    S_V = g, by a reverse loop over the V columns (one ``addcmul`` each)."""
    a_el = (occ_v * s).t().contiguous()                   # [V, C]
    b_el = (1.0 - occ_v).t().contiguous()
    v = occ_v.shape[1]
    s_next = torch.empty_like(a_el)
    s_next[v - 1] = g
    for i in range(v - 1, 0, -1):
        torch.addcmul(a_el[i], b_el[i], s_next[i], out=s_next[i - 1])
    return s_next.t()


def _transmittance(occ_v):
    cp = torch.cumprod(1.0 - occ_v, dim=1)
    t_excl = torch.cat([torch.ones_like(occ_v[:, :1]), cp[:, :-1]], dim=1)
    return cp, t_excl


class _CompositeCore(torch.autograd.Function):
    """Front-to-back emission-absorption compositing of masked opacities:
    (occ_v [C,V], alb_v [C,V,3], bg [C,3]) -> (rgb [C,3], trans [C]).

    Backward (division-free, exact at occ == 1): with s_i = albedo_i . drgb
    and S_i = occ_i s_i + (1 - occ_i) S_{i+1}, S_V = bg . drgb + dtrans,
    d occ_i = T^excl_i (s_i - S_{i+1}) and d alb_i = w_i drgb.  The JAX
    package takes S from an associative scan; here a reverse loop."""

    @staticmethod
    def forward(ctx, occ_v, alb_v, bg):
        cp, t_excl = _transmittance(occ_v)
        w = occ_v * t_excl
        rgb = torch.einsum("cv,cvk->ck", w, alb_v) + cp[:, -1:] * bg
        ctx.save_for_backward(occ_v, alb_v, bg)
        return rgb, cp[:, -1]

    @staticmethod
    def backward(ctx, drgb, dtrans):
        occ_v, alb_v, bg = ctx.saved_tensors
        cp, t_excl = _transmittance(occ_v)
        s = torch.einsum("cvk,ck->cv", alb_v, drgb)
        g = torch.einsum("ck,ck->c", bg, drgb) + dtrans
        d_occ = t_excl * (s - _suffix(occ_v, s, g))
        d_alb = (occ_v * t_excl)[..., None] * drgb[:, None, :]
        return d_occ, d_alb, cp[:, -1:] * drgb


class _CompositeCore3(torch.autograd.Function):
    """:class:`_CompositeCore` with albedo as three [C, V] planes (the row
    replay's layout); same math, same backward."""

    @staticmethod
    def forward(ctx, occ_v, alb_r, alb_g, alb_b, bg):
        cp, t_excl = _transmittance(occ_v)
        w = occ_v * t_excl
        rgb = torch.stack([torch.sum(w * a, dim=1)
                           for a in (alb_r, alb_g, alb_b)], dim=1) \
            + cp[:, -1:] * bg
        ctx.save_for_backward(occ_v, alb_r, alb_g, alb_b, bg)
        return rgb, cp[:, -1]

    @staticmethod
    def backward(ctx, drgb, dtrans):
        occ_v, alb_r, alb_g, alb_b, bg = ctx.saved_tensors
        cp, t_excl = _transmittance(occ_v)
        s = (alb_r * drgb[:, 0:1] + alb_g * drgb[:, 1:2]
             + alb_b * drgb[:, 2:3])
        g = torch.sum(bg * drgb, dim=1) + dtrans
        d_occ = t_excl * (s - _suffix(occ_v, s, g))
        w = occ_v * t_excl
        return (d_occ, *(w * drgb[:, c:c + 1] for c in range(3)),
                cp[:, -1:] * drgb)


# The JAX package's names for the two cores (custom-VJP functions there).
_composite_core = _CompositeCore.apply
_composite_core3 = _CompositeCore3.apply


def _composite_raw(occ_raw, alb_v, mask, bg):
    """Mask + clip raw gathered voxel values, then composite.  Returns
    (rgb [C,3], trans [C])."""
    occ_v = torch.where(mask, _clip01(occ_raw), 0.0)
    return _composite_core(occ_v, alb_v, bg)


def composite_sparse(o_cells, direction, segs, cellmap, occupancy, albedo,
                     background, grid: GridConfig, k_segments: int = 16,
                     rays_per_chunk: int = 32768, row_replay: bool = True):
    """Alpha-composite recorded segments. Returns (rgb [N,3], trans [N]).

    Differentiable in (occupancy [P,512], albedo [P,512,3]).
    ``row_replay=True`` reads each (ray, segment)'s visited voxels from its
    pool row with kernel B4f (backward: kernel B4b into a zero field
    gradient); ``row_replay=False`` gathers per visited voxel (the parity
    oracle).  Rays run in chunks; under autograd each chunk is
    checkpointed, so the backward holds one chunk.
    """
    n = o_cells.shape[0]
    k = k_segments
    pvox = occupancy.shape[0] * occupancy.shape[1]
    nvox = 3 * grid.brick_size - 2
    if row_replay:
        field4 = _pack_field(occupancy, albedo)

    def run_chunk(oc, dc, cells, nds, ncodes, enorm, bg):
        c = oc.shape[0]
        if row_replay:
            slots, lin, mask = _segment_geom(oc, dc, cells, nds, ncodes,
                                             enorm, cellmap, grid, k)
            vals = extract_field(field4, slots.reshape(-1),
                                 lin.reshape(c * k, nvox))   # [C*K, 4*nvox]
            occ_raw = vals[:, :nvox].reshape(c, k * nvox)
            alb_v = torch.stack([vals[:, (1 + ch) * nvox:(2 + ch) * nvox]
                                 .reshape(c, k * nvox) for ch in range(3)],
                                dim=2)
            return _composite_raw(occ_raw, alb_v, mask.reshape(c, k * nvox),
                                  bg)
        gidx, mask = _segment_gidx(oc, dc, cells, nds, ncodes, enorm,
                                   cellmap, grid, k, pvox)
        occ_raw = occupancy.reshape(-1)[gidx]                # [C, K*nvox]
        alb_v = albedo.reshape(-1, 3)[gidx]
        return _composite_raw(occ_raw, alb_v, mask, bg)

    remat = torch.is_grad_enabled() and (occupancy.requires_grad
                                         or albedo.requires_grad)
    rgbs, transs = [], []
    for start in range(0, n, rays_per_chunk):
        sl = slice(start, start + rays_per_chunk)
        args = (o_cells[sl], direction[sl], segs["cells"][sl],
                segs["nd"][sl], segs["ncode"][sl], segs["entry_normal"][sl],
                background[sl])
        rgb, trans = checkpoint(run_chunk, *args, use_reentrant=False) \
            if remat else run_chunk(*args)
        rgbs.append(rgb)
        transs.append(trans)
    if not rgbs:
        return background[:0].clone(), background[:0, 0].clone()
    return torch.cat(rgbs), torch.cat(transs)


def _chunk_grad_body(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                     sse_acc, dfield_acc, field, background, target,
                     grid: GridConfig, k_segments: int):
    """One chunk's sum-of-squared-error gradients added into accumulators,
    voxel-granular: ``field`` packs (occupancy, albedo) as [P*512, 4]; the
    gradient is taken w.r.t. the gathered voxel values and index-added into
    ``dfield_acc`` (in place), never a per-chunk full-field gradient."""
    pvox = field.shape[0]
    gidx, mask = _segment_gidx(o_cells, direction, cells, nd, ncode, enorm,
                               cellmap, grid, k_segments, pvox)
    fld_raw = field[gidx].requires_grad_()          # [C, K*nvox, 4]
    with torch.enable_grad():
        rgb, _ = _composite_raw(fld_raw[..., 0], fld_raw[..., 1:], mask,
                                background)
        sse = torch.sum((rgb - target) ** 2)
        sse.backward()
    dfield_acc.index_add_(0, gidx.reshape(-1), fld_raw.grad.reshape(-1, 4))
    return sse_acc + sse.detach(), dfield_acc


def _row_chunk_grad(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                    dfield_acc, field4, background, target,
                    grid: GridConfig):
    """One slice's per-ray SSE [C], its gradient added into ``dfield_acc``.

    Four launches at brick-row granularity over the ``cells``/``nd``/
    ``ncode`` [C, K] segments: R1 (:func:`~brickmap_tpu_torch.kernels.
    replay.segment_geom`) gives each segment's slot and visited voxels, B4f
    (:func:`~brickmap_tpu_torch.kernels.extract.extract_fwd`) their values
    from ``field4`` [P*512, 4] (voxel-interleaved), R2 (:func:`~brickmap_
    tpu_torch.kernels.replay.composite_sse`) each ray's SSE and the values'
    cotangents, and B4b (:func:`~brickmap_tpu_torch.kernels.extract.
    extract_bwd`) adds those into ``dfield_acc`` in place."""
    slots, lin2 = segment_geom(o_cells, direction, cells, nd, ncode, enorm,
                               cellmap, grid)
    vals = extract_fwd(field4, slots, lin2)              # [C*K, 4*nvox]
    sse, dvals = composite_sse(vals, lin2, background, target)
    extract_bwd(dfield_acc, slots, lin2, dvals)
    return sse


def _row_scan_grads(o_cells, direction, cells, nd, ncode, enorm, cellmap,
                    field4, background, target, grid: GridConfig,
                    k_segments: int, chunk: int):
    """Whole-frame row-granular gradients: a loop over ``chunk``-ray slices
    adding into one field gradient.  Returns (sse, dfield); sse is the
    rays' SSEs summed by one ``torch.sum`` in ray order, a fixed order, so
    a step through the kernels and one through their plain versions give
    the same loss.

    K tiers: the caller sorts rays by descending segment count, so each
    slice runs at the smallest K of (2, 4, K) that covers its rays; a slice
    with no segment reduces to the closed form rgb == bg."""
    n = o_cells.shape[0]
    keffs = [k for k in (2, 4) if k < k_segments] + [k_segments]
    thresholds = [0] + keffs[:-1]
    counts = (cells >= 0).sum(dim=1)
    per_slice = F.pad(counts, (0, (-n) % chunk)).reshape(-1, chunk)
    maxima = per_slice.amax(dim=1)
    with annotate("bm.sync.tier_read"):
        maxima = maxima.tolist()
    sses = []
    with annotate("bm.sparse.zero_grad"):
        dfield = torch.zeros_like(field4)
    with annotate("bm.sparse.slices"):
        for i, mx in enumerate(maxima):
            sl = slice(i * chunk, (i + 1) * chunk)
            tier = sum(mx > t for t in thresholds)
            if tier == 0:
                sses.append(ray_sse_plain(background[sl], target[sl]))
                continue
            keff = keffs[tier - 1]
            sses.append(_row_chunk_grad(
                o_cells[sl], direction[sl], cells[sl, :keff], nd[sl, :keff],
                ncode[sl, :keff], enorm[sl], cellmap, dfield, field4,
                background[sl], target[sl], grid))
    return torch.sum(torch.cat(sses)), dfield


def _page_sort(origin, direction, background, target, grid: GridConfig):
    """Stable sort of the rays by (superchunk page, direction octant)."""
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


def _count_sort(cells, o_cells, direction, nd, ncode, enorm, bg, tgt):
    """Rays sorted by DESCENDING segment count (stable) + the live count
    (rays with at least one segment, which lead)."""
    has_seg = cells[:, 0] >= 0
    cnt = (cells >= 0).sum(dim=1)
    order2 = torch.argsort(-cnt, stable=True)
    return tuple(a[order2] for a in (o_cells, direction, cells, nd, ncode,
                                     enorm, bg, tgt)), \
        has_seg.sum()


def _sky_sse(bg, tgt, n_run: int):
    """SSE of the segment-less tail (rays [n_run:] after the count sort):
    with no segment, rgb == bg exactly."""
    idx = torch.arange(bg.shape[0], device=bg.device)
    err = torch.sum((bg - tgt) ** 2, dim=1)
    return torch.sum(torch.where(idx >= n_run, err, 0.0))


def _pack_field(occupancy, albedo):
    """(occ [P,512], alb [P,512,3]) -> the ``field4`` [P*512, 4] they are
    the views of, with no launch, where they need no autograd; else a new
    one by ``torch.cat``: fields from outside the program, and autograd
    through :func:`composite_sparse`, whose ``extract_field`` needs a graph
    back to both fields."""
    field = field4_of(occupancy, albedo)
    if field is not None and not (
            torch.is_grad_enabled()
            and (occupancy.requires_grad or albedo.requires_grad)):
        return field
    return torch.cat([occupancy.reshape(-1, 1), albedo.reshape(-1, 3)], dim=1)


def _finalize(sse, dfield, denom: int):
    """(loss, (d_occupancy, d_albedo)): ``sse`` and ``dfield`` [P*512, 4]
    times the float32 ``1/denom``, ``dfield`` in place (one pass), the
    gradients its :func:`~brickmap_tpu_torch.diff.field4.field4_views`."""
    inv = torch.tensor(1.0 / denom, dtype=_F32, device=sse.device)
    dfield.mul_(inv)
    return sse * inv, field4_views(dfield)


@torch.no_grad()
def l2_loss_and_grads_sparse(origin, direction, scene, cellmap, occupancy,
                             albedo, background, target, grid: GridConfig,
                             k_segments: int = 16,
                             host_chunk: int = 262144,
                             row_replay: bool = True,
                             seg_cache: dict | None = None):
    """L2 image loss + gradients w.r.t. the sparse pool fields.

    ``scene`` is the :class:`~brickmap_tpu_torch.scene.TorchScene` the rays
    are recorded against; ``cellmap`` maps its cells to rows of
    ``occupancy [P,512]`` / ``albedo [P,512,3]``.  Returns
    ``(loss, (d_occupancy, d_albedo))``, loss = mean squared error over the
    N x 3 pixel values, the gradients the views of one ``dfield``
    [P*512, 4] (``diff/field4.py``).

    ``seg_cache``: optional dict owned by the caller.  The record and both
    sorts depend only on (rays, targets, scene geometry); a loop over the
    FIELDS passes the same dict every step and pays them once.  The cache is
    keyed on the identity of the ray and target tensors (held in the dict):
    other rays or targets through the same dict refresh it.

    ``row_replay=True`` replays at brick-row granularity in slices of
    ``min(host_chunk, 16384)`` rays; ``row_replay=False`` replays per visited
    voxel, in ``host_chunk``-ray slices (the parity oracle).
    """
    with annotate("bm.sparse.step"):
        n = origin.shape[0]
        cache_key = (id(origin), id(direction), id(background), id(target))
        key_arrays = (origin, direction, background, target)
        use_cache = (row_replay and seg_cache is not None
                     and "geo" in seg_cache
                     and seg_cache.get("key") == cache_key)
        if not use_cache:
            # Page-coherence sort (loss and grads are order-invariant).
            origin, direction, background, target = _page_sort(
                origin, direction, background, target, grid)
            segs = record_segments(origin, direction, scene, grid,
                                   k_segments=k_segments)

        with annotate("bm.sparse.pack_field"):
            field = _pack_field(occupancy, albedo)
        if row_replay:
            if use_cache:
                geo, n_live = seg_cache["geo"], seg_cache["n_live"]
            else:
                # Segment-less rays group at the tail; stable, so page
                # coherence survives within each group.
                geo, n_live = _count_sort(
                    segs["cells"], segs["o_cells"], direction, segs["nd"],
                    segs["ncode"], segs["entry_normal"], background, target)
                n_live = int(n_live)
            chunkv = min(host_chunk, 16384, -(-n // 1024) * 1024)
            if seg_cache is not None:
                seg_cache["geo"], seg_cache["n_live"] = geo, n_live
                seg_cache["key"] = cache_key
                seg_cache["key_arrays"] = key_arrays
            if n_live == 0:
                # All-miss frame: the sky SSE covers every ray.
                return _finalize(_sky_sse(geo[6], geo[7], 0),
                                 torch.zeros_like(field), denom=n * 3)
            sse_sky = _sky_sse(geo[6], geo[7], n_live)
            sse, dfield = _row_scan_grads(
                geo[0][:n_live], geo[1][:n_live], geo[2][:n_live],
                geo[3][:n_live], geo[4][:n_live], geo[5][:n_live], cellmap,
                field, geo[6][:n_live], geo[7][:n_live], grid, k_segments,
                chunk=chunkv)
            with annotate("bm.sparse.finalize"):
                return _finalize(sse + sse_sky, dfield, denom=n * 3)

        sse = torch.zeros((), dtype=_F32, device=field.device)
        dfield = torch.zeros_like(field)
        for start in range(0, n, host_chunk):
            sl = slice(start, start + host_chunk)
            sse, dfield = _chunk_grad_body(
                segs["o_cells"][sl], direction[sl], segs["cells"][sl],
                segs["nd"][sl], segs["ncode"][sl], segs["entry_normal"][sl],
                cellmap, sse, dfield, field, background[sl], target[sl],
                grid, k_segments)
        return _finalize(sse, dfield, denom=n * 3)
