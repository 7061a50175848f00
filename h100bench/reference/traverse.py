# Frozen copy of brickmap_tpu_torch/ops/traverse.py, the
# benchmark's plain reference: it imports nothing of the port, and later
# changes to the port do not reach it.  Only its imports were changed.
"""Vectorized hierarchical DDA traversal in torch: kernel B2's plain version.

The port of ``brickmap_tpu/ops/traverse.py::aabb_clip`` (:73) and
``trace_rays`` (:111): all rays advance in lockstep, one DDA step per loop
iteration at whatever level each ray is in (0 top brick grid, 1 the 2x2x2 LoD
byte, 2 the 8x8x8 brick), with the reference's numerics, tie-breaks, LoD
selection, epsilon offsets, streaming requests and Chebyshev empty-space
skipping.  The JAX package's gather-cost variants ``trace_rays_blocked`` and
``trace_rays_chunked`` (same contract) have no counterpart here.

Beyond the JAX function it reports, per ray, the budget state the CUDA kernel
(:mod:`brickmap_tpu_torch.kernels.traverse`) reports: ``resume_t``, the
entry distance of the top cell an exhausted ray stopped in, and the step
counts ``ray_iters`` / ``ray_words`` (index words read) / ``ray_bricks``
(brick rows read), and over the whole batch the distinct index cells and
pool rows it read (``cells_read``, ``rows_read``).  This module is what the kernel is held against, on the CPU
in the tests and on the card in ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from .config import (
    BRICK_DIST_SHIFT,
    BRICK_FLAG_BITS,
    BRICK_INDEX_BITS,
    BRICK_LOADED_BIT,
    BRICK_LOD_SHIFT,
    BRICK_UNLOADED_BIT,
    GridConfig,
    i32,
)

BIG = 1_000_000.0

__all__ = ["aabb_clip", "trace_rays", "trace_clipped_rays", "BIG"]

_F32, _I32 = torch.float32, torch.int32


def _sel3(ax, x, y, z):
    """Component select: value of (x, y, z) at axis index ax (all [N])."""
    return torch.where(ax == 0, x, torch.where(ax == 1, y, z))


def _sel_axis(tx, ty, tz):
    """Reference step-axis priority (voxel.cuh:249): x iff strictly smallest,
    else y iff y<=x and y<z, else z."""
    return torch.where(tx < ty, torch.where(tx < tz, 0, 2),
                       torch.where(ty < tz, 1, 2)).to(_I32)


def _trunc_mod(p, m):
    """C truncating remainder (torch's ``%`` floors)."""
    return torch.where(p >= 0, p % m, -((-p) % m))


def aabb_clip(origin, direction, grid: GridConfig):
    """Slab clip + analytic entry-face normal (voxel.cuh:13-24, 142-155).

    Returns (hit, tminn, clipped_origin [N,3], entry_normal [N,3]); origins
    advanced to the entry point and nudged inside by epsilon when starting
    outside.
    """
    box_max = torch.tensor(grid.world_max, dtype=_F32, device=origin.device)
    t1 = (0.0 - origin) / direction
    t2 = (box_max[None, :] - origin) / direction
    # fmin/fmax ignore NaN (origin exactly on a slab plane with direction 0
    # yields 0/0), like the reference's fminf/fmaxf (voxel.cuh:13-24).
    tmin3 = torch.fmin(t1, t2)
    tmax3 = torch.fmax(t1, t2)
    tminn = torch.maximum(torch.clamp(tmin3[:, 0], min=0.0),
                          torch.maximum(tmin3[:, 1], tmin3[:, 2]))
    hit = tmax3.amin(dim=1) > tminn

    outside = tminn > 0
    adv = origin + direction * tminn[:, None]
    gs, gh = float(grid.grid_size), float(grid.grid_height)
    scale = torch.tensor([gh / gs, gh / gs, 1.0], dtype=_F32,
                         device=origin.device)
    center = torch.tensor([gs / 2, gs / 2, gh / 2], dtype=_F32,
                          device=origin.device)
    to_center = torch.abs(center - adv) * scale
    signs = torch.sign(adv - center)
    to_center = to_center / to_center.amax(dim=1, keepdim=True)
    entry_normal = signs * torch.trunc(to_center + 1e-6)
    entry_normal = torch.where(outside[:, None], entry_normal, 0.0)

    clipped = torch.where(outside[:, None],
                          adv - entry_normal * grid.epsilon, origin)
    return hit, tminn, clipped, entry_normal


def trace_rays(origin, direction, index_volume, pool_words, pool_base,
               camera_brick_pos, grid: GridConfig, max_iters: int = 4096,
               use_ess: bool = True):
    """Trace a batch of rays through the two-level sparse grid.

    Args:
      origin, direction: float32 [N, 3] world-space rays (direction need not
        be normalized).
      index_volume: int32 [CZ, CY, CX] index words; pool_words int32 [P, 16];
        pool_base int32 [num_superchunks] (a :class:`TorchScene`'s tensors).
      camera_brick_pos: 3 ints, camera position // brick_size (LoD origin).
      max_iters: DDA steps per ray, shared by the three levels; a ray still
        going after that many is ``exhausted``.
      use_ess: empty-space skipping (off only to show it changes nothing).

    Returns a dict: hit [N] bool, t [N] f32 (world units, 0 on a miss),
    normal [N, 3] f32 (0 on a miss), request [N] bool + request_pos [N, 3]
    int32, exhausted [N] bool, resume_t [N] f32, iters (max ``ray_iters``),
    the per-ray step counts ray_iters / ray_words / ray_bricks (int32), and
    cells_read [CZ*CY*CX] / rows_read [P] (bool): the index words and brick
    rows that at least one ray read.
    """
    ok, tminn, clipped, entry_normal = aabb_clip(origin, direction, grid)
    return trace_clipped_rays(clipped, direction, entry_normal, tminn, ok,
                              index_volume, pool_words, pool_base,
                              camera_brick_pos, grid, max_iters, use_ess)


def trace_clipped_rays(clipped, direction, entry_normal, tminn, ok,
                       index_volume, pool_words, pool_base, camera_brick_pos,
                       grid: GridConfig, max_iters: int = 4096,
                       use_ess: bool = True):
    """:func:`trace_rays` after its :func:`aabb_clip`: the rays given as
    the clip's outputs (clipped origins, directions, entry normals, tmin,
    ok), the five inputs kernel B2's launcher reads.  Same result."""
    dev = clipped.device
    n = clipped.shape[0]
    eps = torch.tensor(grid.epsilon, dtype=_F32, device=dev)
    bsz = grid.brick_size
    cx_max, cy_max, cz_max = grid.cells, grid.cells, grid.cells_height
    s = grid.supergrid_cell_size
    camx, camy, camz = (int(c) for c in camera_brick_pos)

    ox, oy, oz = (clipped[:, k] / bsz for k in range(3))
    dx, dy, dz = (direction[:, k].to(_F32) for k in range(3))

    def setup(d):
        stepf = torch.sign(d)
        rd = torch.where(d == 0.0, 0.0, 1.0 / d)
        return stepf, stepf.to(_I32), rd, stepf * rd

    sfx, six, rdx, tdx = setup(dx)
    sfy, siy, rdy, tdy = setup(dy)
    sfz, siz, rdz, tdz = setup(dz)

    def dda_init(o, d, rd):
        p = torch.trunc(o).to(_I32)
        cb = torch.where(d > 0, p.to(_F32) + 1.0, p.to(_F32))
        t = torch.where(d != 0.0, (cb - o) * rd, BIG)
        return p, t

    px, tx = dda_init(ox, dx, rdx)
    py, ty = dda_init(oy, dy, rdy)
    pz, tz = dda_init(oz, dz, rdz)

    inside = ((px >= 0) & (px < cx_max) & (py >= 0) & (py < cy_max)
              & (pz >= 0) & (pz < cz_max))
    active = ok & inside

    iv_flat = index_volume.reshape(-1)
    zero_f = torch.zeros(n, dtype=_F32, device=dev)
    zero_i = torch.zeros(n, dtype=_I32, device=dev)
    full_big = torch.full((n,), BIG, dtype=_F32, device=dev)
    minus1 = torch.full((n,), -1, dtype=_I32, device=dev)

    level = zero_i
    axis0 = minus1
    nx, ny, nz = (entry_normal[:, k].to(_F32) for k in range(3))
    nd = zero_f
    sx = sy = sz = zero_i
    stx = sty = stz = full_big
    axs = minus1
    gslot = zero_i
    lodbyte = zero_i
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    t = zero_f
    onx = ony = onz = zero_f
    request = torch.zeros(n, dtype=torch.bool, device=dev)
    rqx = rqy = rqz = zero_i
    ray_iters = ray_words = ray_bricks = zero_i
    # One sink slot past the end takes the lanes that read nothing.
    n_cells, n_rows = iv_flat.shape[0], pool_words.shape[0]
    cells_read = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)
    rows_read = torch.zeros(n_rows + 1, dtype=torch.bool, device=dev)

    it = 0
    while it < max_iters and bool(active.any()):
        it += 1
        ray_iters = ray_iters + active.to(_I32)

        # ---- top-level cell fetch -------------------------------------
        pcx = torch.clamp(px, 0, cx_max - 1)
        pcy = torch.clamp(py, 0, cy_max - 1)
        pcz = torch.clamp(pz, 0, cz_max - 1)
        cell = ((pcz * cy_max + pcy) * cx_max + pcx).long()
        word = iv_flat[cell]
        is_top = (level == 0) & active
        ray_words = ray_words + is_top.to(_I32)
        cells_read.index_fill_(0, torch.where(is_top, cell, n_cells), True)
        # Occupied iff a residency flag is set (the reference tests
        # `if (index)`, voxel.cuh:200; empty cells carry ESS distance bits).
        occ0 = is_top & ((word & i32(BRICK_FLAG_BITS)) != 0)
        skip_r = torch.clamp(((word >> BRICK_DIST_SHIFT) & 0x1FF) - 1, min=0)

        # Crossing t + face normal of the current top cell (voxel.cuh:200-206).
        entered = axis0 >= 0
        t_ax = _sel3(axis0, tx, ty, tz)
        td_ax = _sel3(axis0, tdx, tdy, tdz)
        nd_new = torch.where(entered, t_ax - td_ax, 0.0)
        sf_ax = _sel3(axis0, sfx, sfy, sfz)
        ntx = torch.where(entered, torch.where(axis0 == 0, -sf_ax, 0.0), nx)
        nty = torch.where(entered, torch.where(axis0 == 1, -sf_ax, 0.0), ny)
        ntz = torch.where(entered, torch.where(axis0 == 2, -sf_ax, 0.0), nz)

        # LoD by squared camera distance in brick units (voxel.cuh:208-215).
        d2 = (camx - px) ** 2 + (camy - py) ** 2 + (camz - pz) ** 2
        far = d2 > grid.lod_distance_8
        mid = ~far & (d2 > grid.lod_distance_2)
        near = ~far & ~mid
        loaded = (word & i32(BRICK_LOADED_BIT)) != 0
        unloaded = (word & BRICK_UNLOADED_BIT) != 0

        hit_far = occ0 & far
        descend_byte = occ0 & mid
        descend_brick = occ0 & near & loaded
        hit_unloaded = occ0 & near & ~loaded & unloaded
        top_advance = is_top & ~(hit_far | descend_byte | descend_brick
                                 | hit_unloaded)
        ray_bricks = ray_bricks + descend_brick.to(_I32)

        # ---- sub-level occupancy test ---------------------------------
        is_sub = (level > 0) & active
        lin_byte = torch.clamp(sx + sy * 2 + sz * 4, 0, 7)
        occ_byte = (lodbyte >> lin_byte) & 1
        lin_brick = torch.clamp(sx + sy * bsz + sz * bsz * bsz, 0,
                                bsz ** 3 - 1)
        brick_word = pool_words[gslot.long(), (lin_brick // 32).long()]
        occ_brick = (brick_word >> (lin_brick % 32)) & 1
        sub_hit = torch.where(level == 1, occ_byte != 0,
                              occ_brick != 0) & is_sub
        sub_advance = is_sub & ~sub_hit

        # ---- sub hit: distance/normal (voxel.cuh:58-63, 114-119) ------
        s_entered = axs >= 0
        sub_t = torch.where(s_entered, _sel3(axs, stx, sty, stz)
                            - _sel3(axs, tdx, tdy, tdz), 0.0)
        ssf_ax = _sel3(axs, sfx, sfy, sfz)
        snx = torch.where(s_entered, torch.where(axs == 0, -ssf_ax, 0.0), nx)
        sny = torch.where(s_entered, torch.where(axs == 1, -ssf_ax, 0.0), ny)
        snz = torch.where(s_entered, torch.where(axs == 2, -ssf_ax, 0.0), nz)
        sub_scale = torch.where(level == 1, 4.0, 1.0)
        sub_hit_t = nd * bsz + sub_t * sub_scale + tminn

        # ---- sub step -------------------------------------------------
        s_axis = _sel_axis(stx, sty, stz)
        sub_extent = torch.where(level == 1, 2, bsz)
        sxn = sx + torch.where(s_axis == 0, six, 0)
        syn = sy + torch.where(s_axis == 1, siy, 0)
        szn = sz + torch.where(s_axis == 2, siz, 0)
        s_out_x = torch.where(dx > 0, sub_extent, -1)
        s_out_y = torch.where(dy > 0, sub_extent, -1)
        s_out_z = torch.where(dz > 0, sub_extent, -1)
        s_exited = (_sel3(s_axis, sxn, syn, szn)
                    == _sel3(s_axis, s_out_x, s_out_y, s_out_z))
        stxn = stx + torch.where(s_axis == 0, tdx, 0.0)
        styn = sty + torch.where(s_axis == 1, tdy, 0.0)
        stzn = stz + torch.where(s_axis == 2, tdz, 0.0)
        ascend = sub_advance & s_exited

        # ---- top step (empty cell, or sub-DDA exited) -----------------
        # Empty-space skipping: with skip radius R >= 1 every cell within
        # L-inf distance R is empty, so jump each axis by its crossing count
        # up to the first crossing that leaves the safe box.
        do_top_step = top_advance | ascend
        if use_ess:
            use_skip = top_advance & ~occ0 & (skip_r >= 1)
        else:
            use_skip = torch.zeros(n, dtype=torch.bool, device=dev)
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

        t_axis = _sel_axis(tx, ty, tz)
        kx1 = (t_axis == 0).to(_I32)
        ky1 = (t_axis == 1).to(_I32)
        kz1 = (t_axis == 2).to(_I32)
        kx = torch.where(use_skip, k_axis(dx, tx, tdx), kx1)
        ky = torch.where(use_skip, k_axis(dy, ty, tdy), ky1)
        kz = torch.where(use_skip, k_axis(dz, tz, tdz), kz1)
        # FP guard: a degenerate skip that moves nowhere falls back to 1 step.
        stuck = use_skip & (kx + ky + kz == 0)
        kx = torch.where(stuck, kx1, kx)
        ky = torch.where(stuck, ky1, ky)
        kz = torch.where(stuck, kz1, kz)

        pxn = px + six * kx
        pyn = py + siy * ky
        pzn = pz + siz * kz
        txn = tx + kx.to(_F32) * tdx
        tyn = ty + ky.to(_F32) * tdy
        tzn = tz + kz.to(_F32) * tdz
        # Last crossing axis = latest crossing time among stepped axes.
        tlx = torch.where(kx > 0, txn - tdx, -BIG)
        tly = torch.where(ky > 0, tyn - tdy, -BIG)
        tlz = torch.where(kz > 0, tzn - tdz, -BIG)
        t_axis = torch.where(tlx > tly, torch.where(tlx > tlz, 0, 2),
                             torch.where(tly > tlz, 1, 2)).to(_I32)
        # With jumps the landing cell can overshoot the boundary cell, so
        # test crossing rather than equality.
        t_exited = (((dx > 0) & (pxn >= cx_max)) | ((dx < 0) & (pxn < 0))
                    | ((dy > 0) & (pyn >= cy_max)) | ((dy < 0) & (pyn < 0))
                    | ((dz > 0) & (pzn >= cz_max)) | ((dz < 0) & (pzn < 0)))
        miss = do_top_step & t_exited

        # ---- descend setup --------------------------------------------
        # Byte level: hit*(2) - normal*0.2*eps (voxel.cuh:217);
        # brick level: hit*(8) - normal*eps (voxel.cuh:224).
        descend = descend_byte | descend_brick
        d_scale = torch.where(descend_byte, 2.0, float(bsz))
        n_eps = torch.where(descend_byte, 0.2 * eps, eps)
        d_ext = torch.where(descend_byte, 2, bsz)

        def descend_axis(o, d, rd, nt):
            so = (o + d * nd_new) * d_scale - nt * n_eps
            p = torch.trunc(so).to(_I32)
            cb = torch.where(d > 0, p.to(_F32) + 1.0, p.to(_F32))
            return _trunc_mod(p, d_ext), torch.where(d != 0.0,
                                                     (cb - so) * rd, BIG)

        sdx, sdtx = descend_axis(ox, dx, rdx, ntx)
        sdy, sdty = descend_axis(oy, dy, rdy, nty)
        sdz, sdtz = descend_axis(oz, dz, rdz, ntz)

        sc_id = torch.clamp(px // s + (py // s) * grid.supergrid_xy
                            + (pz // s) * grid.supergrid_xy ** 2,
                            0, grid.num_superchunks - 1)
        gslot_d = pool_base[sc_id.long()] + (word & BRICK_INDEX_BITS)
        rows_read.index_fill_(0, torch.where(descend_brick, gslot_d.long(),
                                             n_rows), True)

        # ---- merge state ----------------------------------------------
        coarse_hit = hit_far | hit_unloaded
        terminal = coarse_hit | sub_hit
        hit = hit | terminal
        t = torch.where(coarse_hit, nd_new * bsz + tminn, t)
        t = torch.where(sub_hit, sub_hit_t, t)
        onx = torch.where(sub_hit, snx, torch.where(coarse_hit, ntx, onx))
        ony = torch.where(sub_hit, sny, torch.where(coarse_hit, nty, ony))
        onz = torch.where(sub_hit, snz, torch.where(coarse_hit, ntz, onz))
        request = request | hit_unloaded
        rqx = torch.where(hit_unloaded, px, rqx)
        rqy = torch.where(hit_unloaded, py, rqy)
        rqz = torch.where(hit_unloaded, pz, rqz)

        active = active & ~terminal & ~miss
        level = torch.where(descend_byte, 1, torch.where(
            descend_brick, 2, torch.where(ascend, 0, level))).to(_I32)
        px = torch.where(do_top_step, pxn, px)
        py = torch.where(do_top_step, pyn, py)
        pz = torch.where(do_top_step, pzn, pz)
        tx = torch.where(do_top_step, txn, tx)
        ty = torch.where(do_top_step, tyn, ty)
        tz = torch.where(do_top_step, tzn, tz)
        axis0 = torch.where(do_top_step, t_axis, axis0)
        nx = torch.where(descend, ntx, nx)
        ny = torch.where(descend, nty, ny)
        nz = torch.where(descend, ntz, nz)
        nd = torch.where(descend, nd_new, nd)
        sx = torch.where(descend, sdx, torch.where(sub_advance, sxn, sx))
        sy = torch.where(descend, sdy, torch.where(sub_advance, syn, sy))
        sz = torch.where(descend, sdz, torch.where(sub_advance, szn, sz))
        stx = torch.where(descend, sdtx, torch.where(sub_advance, stxn, stx))
        sty = torch.where(descend, sdty, torch.where(sub_advance, styn, sty))
        stz = torch.where(descend, sdtz, torch.where(sub_advance, stzn, stz))
        axs = torch.where(descend, -1, torch.where(sub_advance, s_axis, axs))
        gslot = torch.where(descend_brick, gslot_d, gslot)
        lodbyte = torch.where(descend_byte,
                              (word >> BRICK_LOD_SHIFT) & 0xFF, lodbyte)

    # Resume distance of budget-exhausted rays: entry t of the top cell they
    # occupy, in world units along the original ray (traverse3.py:790-798,
    # :931-937 of the JAX package).
    exhausted = active
    resume = torch.where(axis0 >= 0, _sel3(axis0, tx, ty, tz)
                         - _sel3(axis0, tdx, tdy, tdz), 0.0)
    resume_t = torch.where(exhausted, resume * float(bsz) + tminn, 0.0)
    return dict(
        hit=hit,
        t=t,
        normal=torch.stack([onx, ony, onz], dim=1),
        request=request,
        request_pos=torch.stack([rqx, rqy, rqz], dim=1),
        exhausted=exhausted,
        resume_t=torch.clamp(resume_t, min=0.0),
        iters=ray_iters.amax() if n else torch.zeros((), dtype=_I32,
                                                     device=dev),
        ray_iters=ray_iters,
        ray_words=ray_words,
        ray_bricks=ray_bricks,
        cells_read=cells_read[:n_cells],
        rows_read=rows_read[:n_rows],
    )
