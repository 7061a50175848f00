# Frozen copy of brickmap_tpu_torch/ops/replay.py, the
# benchmark's plain reference: it imports nothing of the port, and later
# changes to the port do not reach it.  Only its imports were changed.
"""Plain torch versions of kernels R1 and R2, the sparse replay's slice body
around B4f/B4b.

The JAX package's ``_row_chunk_grad`` (``brickmap_tpu/diff/sparse.py``
:490) runs, per slice of C rays at K segments: the segment geometry
(``_segment_geom`` :141 with ``_merge_offsets`` :41, and the -1 poison of
the invalid steps :514), the visited voxels' values (B4f), the clip/mask
chain and ``_composite_core3`` with its division-free custom VJP (:293-339)
under ``value_and_grad`` of the SSE, and the add of the cotangents (B4b).
XLA fuses each of those into the scan's one program.  Here:

* :func:`segment_visits` and :func:`merge_offsets` are the ports of
  ``_segment_geom`` and ``_merge_offsets``: the JAX functions' contract
  (slots, lin, mask), batched over the C*K segments;
* :func:`segment_geom_plain` (R1) is that plus the poison: ``slots [C*K]``
  i32 (0 where invalid) and ``lin2 [C*K, nvox]`` i32 (-1 where the step is
  not valid), exactly B4f's and B4b's inputs;
* :func:`composite_sse_plain` (R2) takes B4f's ``vals [C*K, 4*nvox]`` (row
  ``c*K + k``, column ``f*nvox + j``: a ray's V = K*nvox steps in order)
  and returns each ray's SSE and the cotangents ``dvals`` of the SSE, the
  clip's and the mask's gradient included, which B4b adds into the field.

R2 is written as explicit column loops in the kernel's order (the
transmittance, the colour sums and the reverse suffix run one column at a
time; every other product is elementwise), so that the kernel of
``csrc/replay.cu`` equals it bit for bit on the card, where a ``cumprod``
or a reduction would associate differently.  It is held against the
autograd of ``_CompositeCore3`` and against JAX within rounding.
"""

from __future__ import annotations

import torch

from .config import GridConfig

__all__ = ["merge_offsets", "segment_visits", "segment_geom_plain",
           "composite_sse_plain", "ray_sse_plain"]

_F32, _I32 = torch.float32, torch.int32
_TIE = 1e-3   # ABSOLUTE time window of merge_offsets (brick-t units)


def merge_offsets(tmax, tdabs, has_axis, nj: int, nvox: int):
    """Per-axis crossing counts after k merged DDA steps, k = 0..nvox-1.

    The visit sequence of a 3-axis DDA is the 3-way merge of the per-axis
    crossing times ``t_a(j) = tmax_a + j * tdabs_a``.  The rank of axis a's
    j-th crossing is j plus the crossings of the other axes ordered before
    it; ties break z over y over x (the walk's ``_sel_axis`` priority) by
    counting a tied crossing of b as earlier exactly when b outranks a.  A
    tie is two crossings within an ABSOLUTE window of 1e-3 in brick-t units
    (the periods are >= 1): a per-axis window let a near-tie fall inside one
    axis's window and outside the other's, giving two crossings one rank.
    ``offs_a[k] = #{j : rank_a(j) < k}`` comes from a binary search over j.

    Args: tmax [C,3], tdabs [C,3] (|1/d|), has_axis [C,3] bool (d != 0).
    Returns offs int32 [C, nvox, 3].
    """
    c = tmax.shape[0]
    tie = torch.tensor(_TIE, dtype=_F32, device=tmax.device)

    def count(b, T, inclusive: bool):
        """#{i >= 0 : t_b(i) < T} (<= T when ``inclusive``), clipped; within
        ``tie`` of T counts as equal time."""
        db = torch.where(tdabs[:, b:b + 1] == 0.0, 1.0, tdabs[:, b:b + 1])
        r = (T - tmax[:, b:b + 1]) / db
        e = tie / db
        n = torch.floor(r + e).to(_I32) + 1 if inclusive \
            else torch.ceil(r - e).to(_I32)
        n = torch.where(has_axis[:, b:b + 1], n, 0)
        return torch.clamp(n, 0, nj)

    ks = torch.arange(nvox, dtype=_I32, device=tmax.device)[None, :]
    offs_ax = []
    for a in range(3):
        others = [b for b in range(3) if b != a]

        def rank(j, a=a, others=others):
            t = tmax[:, a:a + 1] + j.to(_F32) * tdabs[:, a:a + 1]
            r = j + count(others[0], t, others[0] > a) \
                + count(others[1], t, others[1] > a)
            return torch.where(has_axis[:, a:a + 1] & (j < nj), r, 2 ** 30)

        lo = torch.zeros((c, nvox), dtype=_I32, device=tmax.device)
        hi = torch.full((c, nvox), nj, dtype=_I32, device=tmax.device)
        for _ in range((nj + 1).bit_length()):
            mid = (lo + hi) >> 1
            below = rank(mid) < ks
            lo = torch.where(below, mid + 1, lo)
            hi = torch.where(below, hi, mid)
        offs_ax.append(lo)
    return torch.stack(offs_ax, dim=2)


def segment_visits(oc, dc, cells, nds, ncodes, enorm, cellmap,
                   grid: GridConfig, k_segments: int):
    """Per-segment geometry: brick slot + the in-brick DDA's visit sequence.

    Pure geometry (voxel.cuh:79-133): every visited voxel's index comes from
    register arithmetic, no occupancy reads.  The JAX function loops over the
    K segments; here the [C, K] segments are one batch of C*K rows, each
    computed exactly as there.

    Returns (slots [C,K] i32 (0 where invalid), lin [C,K,nvox] i32 in-brick
    voxel ids, mask [C,K,nvox] bool step-valid).
    """
    c, K = cells.shape[0], k_segments
    eps = torch.tensor(grid.epsilon, dtype=_F32, device=oc.device)
    bsz = grid.brick_size
    nvox = 3 * bsz - 2
    cellmap_flat = cellmap.reshape(-1)
    cy, cx = cellmap.shape[1], cellmap.shape[2]

    def rows3(a):
        return a[:, None, :].expand(c, K, 3).reshape(c * K, 3)

    oc, dc, enorm = rows3(oc), rows3(dc), rows3(enorm)
    cell = cells.reshape(-1)
    nd = nds.reshape(-1)
    ncode = ncodes.reshape(-1)
    valid = cell >= 0
    cxp = cell & 0x3FF
    cyp = (cell >> 10) & 0x3FF
    czp = (cell >> 20) & 0x3FF
    flat = (czp * cy + cyp) * cx + cxp
    slot = cellmap_flat[torch.clamp(flat, 0, cellmap_flat.shape[0] - 1)]
    valid = valid & (slot >= 0)
    slot = torch.where(valid, slot, 0)

    # In-brick DDA from the nudged entry point (voxel.cuh:224).
    nrm = torch.stack([torch.where(ncode == a, -torch.sign(dc[:, a]), 0.0)
                       for a in range(3)], 1)
    nrm = torch.where((ncode >= 0)[:, None], nrm, enorm)
    so = (oc + dc * nd[:, None]) * bsz - nrm * eps
    pg = torch.trunc(so).to(_I32)
    stepv = torch.sign(dc).to(_I32)
    rd = torch.where(dc == 0.0, 0.0, 1.0 / dc)
    # Crossing times in the global frame of `so`; only the position is
    # reduced to brick-local coordinates (C trunc-mod, voxel.cuh:93).
    cb = torch.where(dc > 0, pg + 1.0, pg.to(_F32))
    tmax = torch.where(dc != 0.0, (cb - so) * rd, 1e6)
    p = torch.where(pg >= 0, pg % bsz, -((-pg) % bsz))
    tdelta = torch.abs(rd)

    offs = merge_offsets(tmax, tdelta, dc != 0.0, nvox - 1, nvox)
    pk = p[:, None, :] + stepv[:, None, :] * offs         # [C*K, nvox, 3]
    inb = ((pk >= 0) & (pk < bsz)).all(dim=2)
    mask = valid[:, None] & inb
    lin = torch.clamp(pk[..., 0] + pk[..., 1] * bsz + pk[..., 2] * bsz * bsz,
                      0, bsz ** 3 - 1)
    return slot.reshape(c, K), lin.reshape(c, K, nvox), \
        mask.reshape(c, K, nvox)


def segment_geom_plain(oc, dc, cells, nds, ncodes, enorm, cellmap,
                       grid: GridConfig):
    """R1's plain version: ``(slots [C*K] i32, lin2 [C*K, nvox] i32)`` for
    the ``cells``/``nds``/``ncodes`` [C, K] segments, ``lin2`` -1 where the
    step is not valid (so that B4f reads 0 there, not voxel 0's value)."""
    c, k = cells.shape
    slots, lin, mask = segment_visits(oc, dc, cells, nds, ncodes, enorm,
                                      cellmap, grid, k)
    lin2 = torch.where(mask, lin, -1)
    return slots.reshape(c * k), lin2.reshape(c * k, lin.shape[2])


def ray_sse_plain(rgb, target):
    """Each ray's squared error, its three channels added in order."""
    d = rgb - target
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def composite_sse_plain(vals, lin2, background, target):
    """R2's plain version: ``(sse [C], dvals [C*K, 4*nvox])``.

    ``vals [C*K, 4*nvox]`` is B4f's output, ``lin2`` R1's (a step is valid
    where ``lin2 >= 0``), ``background``/``target`` [C, 3].  Per ray, over
    its V = K*nvox steps i in order, with occ_i = clip(x_i, 0, 1) on valid
    steps and 0 on the others:

        T^excl_0 = 1,  T^excl_{i+1} = T^excl_i (1 - occ_i),  w_i = occ_i T^excl_i
        rgb = sum_i w_i a_i + T^excl_V bg,  sse = |rgb - target|^2

    and the analytic backward of the SSE (division-free, exact at occ == 1):
    drgb = 2 (rgb - target), s_i = a_i . drgb, S_V = bg . drgb,
    S_i = occ_i s_i + (1 - occ_i) S_{i+1}; d occ_i = T^excl_i (s_i - S_{i+1}),
    d a_i = w_i drgb.  The clip passes half of d occ_i at x_i == 0 or 1 (as
    ``jnp.clip`` and ``torch.maximum``/``minimum`` do), all of it inside,
    none outside; an invalid step gets 0.
    """
    c = background.shape[0]
    cs, nvox = lin2.shape
    v = (cs // c) * nvox
    if cs != c * (cs // c) or vals.shape != (cs, 4 * nvox):
        raise ValueError(f"composite_sse_plain: vals {tuple(vals.shape)}, "
                         f"lin2 {tuple(lin2.shape)} for {c} rays")

    def plane(f):
        return vals[:, f * nvox:(f + 1) * nvox].reshape(c, v)

    x = plane(0)
    alb = [plane(1), plane(2), plane(3)]
    mask = (lin2 >= 0).reshape(c, v)
    occ = torch.where(x < 0.0, 0.0, x)
    occ = torch.where(mask, torch.where(occ > 1.0, 1.0, occ), 0.0)
    om = 1.0 - occ

    # Forward: the transmittance and the colour sums, a column at a time.
    t_excl = torch.empty_like(occ)
    trans = torch.ones(c, dtype=_F32, device=vals.device)
    for i in range(v):
        t_excl[:, i] = trans
        trans = trans * om[:, i]
    w = occ * t_excl
    rgb = []
    for ch in range(3):
        wa = w * alb[ch]
        acc = torch.zeros(c, dtype=_F32, device=vals.device)
        for i in range(v):
            acc = acc + wa[:, i]
        rgb.append(acc + trans * background[:, ch])
    rgb = torch.stack(rgb, dim=1)
    sse = ray_sse_plain(rgb, target)

    # Backward: the suffix S_{i+1} a column at a time, from S_V = bg . drgb.
    g = 2.0 * (rgb - target)
    g0, g1, g2 = g[:, 0:1], g[:, 1:2], g[:, 2:3]
    s = (alb[0] * g0 + alb[1] * g1) + alb[2] * g2
    a_el = occ * s
    s_next = torch.empty_like(occ)
    suffix = (background[:, 0] * g[:, 0] + background[:, 1] * g[:, 1]) \
        + background[:, 2] * g[:, 2]
    for i in range(v - 1, -1, -1):
        s_next[:, i] = suffix
        suffix = a_el[:, i] + om[:, i] * suffix
    d_occ = t_excl * (s - s_next)
    d_x = torch.where((x == 0.0) | (x == 1.0), d_occ * 0.5,
                      torch.where((x < 0.0) | (x > 1.0), 0.0, d_occ))
    d_x = torch.where(mask, d_x, 0.0)
    planes = [d_x, w * g0, w * g1, w * g2]
    dvals = torch.cat([p.reshape(cs, nvox) for p in planes], dim=1)
    return sse, dvals
