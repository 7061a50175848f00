"""Differentiable voxel rendering over a dense grid: transmittance
compositing along DDA rays.

The port of ``brickmap_tpu/diff/render.py``.  A ray visits voxels front to
back in exact DDA order (the 3-way merge of per-axis crossing times,
:func:`~brickmap_tpu_torch.ops.replay.merge_offsets`); each visited voxel
contributes ``w_i = T_{i-1} occ_i``, ``T_i = T_{i-1} (1 - occ_i)``, and the
pixel is ``sum_i w_i albedo_i + T_N bg``.  Gradients w.r.t. per-voxel
``occupancy`` and ``albedo`` come from autograd through one flat gather and
the analytic compositing core.  This is the small-scene reference; the
production compositor over the sparse brick pool is
:mod:`brickmap_tpu_torch.diff.sparse`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.replay import merge_offsets
from .sparse import _clip01, _composite_core

__all__ = ["composite_rays", "l2_loss_and_grads"]

_F32, _I32 = torch.float32, torch.int32


def _dda_state(origin, direction):
    """Unit-voxel DDA setup (shared semantics with ops/traverse)."""
    pos = torch.floor(origin).to(_I32)
    step = torch.sign(direction)
    rdinv = torch.where(direction == 0.0, 0.0, 1.0 / direction)
    cb = torch.where(direction > 0, pos + 1.0, pos.to(_F32))
    tmax = torch.where(direction != 0.0, (cb - origin) * rdinv, 1e6)
    tdelta = step * rdinv
    return pos, step.to(_I32), tmax, tdelta


def composite_rays(origin, direction, occupancy, albedo, background,
                   max_steps: int = 192):
    """Alpha-composite rays through a dense voxel grid.

    origin, direction: float32 [N, 3]; the grid occupies [0, X) x [0, Y) x
    [0, Z) with unit voxels; occupancy is [Z, Y, X], albedo [Z, Y, X, 3];
    background [N, 3] is composited behind the grid; ``max_steps`` voxels
    per ray.  Returns (rgb [N, 3], transmittance [N], expected_depth [N]).
    """
    nz, ny, nx = occupancy.shape
    dev = origin.device
    ext = torch.tensor([nx, ny, nz], dtype=_I32, device=dev)
    n = origin.shape[0]

    # Clip to the grid box; out-of-bounds voxels contribute nothing.
    box_max = ext.to(_F32)
    rd = torch.where(direction == 0, 0.0, 1.0 / direction)
    t1 = (0.0 - origin) * rd
    t2 = (box_max - origin) * rd
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    lo = torch.where(direction == 0.0, -torch.inf, lo)
    hi = torch.where(direction == 0.0, torch.inf, hi)
    tenter = torch.clamp(lo.amax(dim=1), min=0.0)
    texit = hi.amin(dim=1)
    inside_box = ((origin >= 0) & (origin < box_max)).all(dim=1)
    valid = (texit > tenter) | inside_box

    start = origin + direction * torch.where(inside_box, 0.0,
                                             tenter + 1e-4)[:, None]
    pos, stepv, tmax, tdelta = _dda_state(start, direction)
    tdabs = torch.abs(tdelta)

    offs = merge_offsets(tmax, tdabs, direction != 0.0,
                         max_steps - 1, max_steps)       # [C, V, 3]
    pk = pos[:, None, :] + stepv[:, None, :] * offs
    inb = ((pk >= 0) & (pk < ext)).all(dim=2) & valid[:, None]
    pc = torch.minimum(torch.clamp(pk, min=0), ext - 1)
    flat = (pc[..., 2] * ny + pc[..., 1]) * nx + pc[..., 0]

    occ_v = occupancy.reshape(-1)[flat]                  # [C, V]
    occ_v = torch.where(inb, _clip01(occ_v), 0.0)
    alb_v = albedo.reshape(-1, 3)[flat]
    rgb, trans = _composite_core(occ_v, alb_v, background)

    # Expected depth from the per-step [t_entry, t_exit] (forward-only
    # diagnostic; weights from a plain cumprod).
    t_next = torch.where(
        (direction != 0.0)[:, None, :],
        tmax[:, None, :] + offs.to(_F32) * tdabs[:, None, :],
        1e6).amin(dim=2)                                 # t_exit_k [C, V]
    t_entry = torch.cat([torch.zeros((n, 1), dtype=_F32, device=dev),
                         t_next[:, :-1]], dim=1)
    cp = torch.cumprod(1.0 - occ_v, dim=1)
    t_excl = torch.cat([torch.ones((n, 1), dtype=_F32, device=dev),
                        cp[:, :-1]], dim=1)
    depth = torch.sum(occ_v * t_excl * 0.5 * (t_entry + t_next), dim=1)
    # Depth accumulated in start-local t; shift by the clip distance weighted
    # by total opacity (sum of weights = 1 - trans).
    depth = depth + (1.0 - trans) * torch.where(inside_box, 0.0, tenter)
    return rgb, trans, depth


def l2_loss_and_grads(origin, direction, occupancy, albedo, background,
                      target, max_steps: int = 192,
                      rays_per_chunk: int = 32768):
    """L2 image loss and gradients w.r.t. (occupancy, albedo).

    Rays run in chunks of ``rays_per_chunk``, each under
    :func:`torch.utils.checkpoint.checkpoint`, so the backward holds one
    chunk's intermediates at a time.  Returns (loss, (d_occ, d_alb)).
    """
    n = origin.shape[0]
    occ = occupancy.detach().requires_grad_()
    alb = albedo.detach().requires_grad_()
    with torch.enable_grad():
        if n <= rays_per_chunk:
            rgb, _, _ = composite_rays(origin, direction, occ, alb,
                                       background, max_steps=max_steps)
            loss = torch.mean((rgb - target) ** 2)
        else:
            def one(o, d, bg, tg, occ, alb):
                rgb, _, _ = composite_rays(o, d, occ, alb, bg,
                                           max_steps=max_steps)
                return torch.sum((rgb - tg) ** 2)

            sq = [checkpoint(one, origin[s:s + rays_per_chunk],
                             direction[s:s + rays_per_chunk],
                             background[s:s + rays_per_chunk],
                             target[s:s + rays_per_chunk], occ, alb,
                             use_reentrant=False)
                  for s in range(0, n, rays_per_chunk)]
            loss = torch.sum(torch.stack(sq)) / (n * 3)
        loss.backward()
    return loss.detach(), (occ.grad, alb.grad)
