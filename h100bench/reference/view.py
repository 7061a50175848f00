"""The reference sample wave: the port's ``render/pathtrace.py::_wave`` over
the plain versions of W0-W4 and B2 (frozen copies in this package).

A lane's result depends only on its pixel, its uniforms, the camera and the
world, so the plain versions reproduce the program's wave lane for lane.
:func:`wave` also counts, for each trace, what the yardstick
(``h100bench/yardstick.py``) needs to bound the kernels: the rays traced,
the distinct index words and brick rows B2 and W4 read, and their steps.
"""

from __future__ import annotations

import numpy as np

from .config import BrickmapConfig
from .traverse import trace_clipped_rays
from .wave import compact_plain, gather_clip_plain, new_state, \
    primary_plain, rescue_plain, shade_plain

__all__ = ["tile_permutation", "wave", "rescue_budget"]

RESCUE_TOP_STEPS = 4096   # pathtrace.py's escalated top-level budget
RESCUE_PASSES = 4


def rescue_budget(cfg: BrickmapConfig) -> int:
    r = cfg.render
    return max(r.max_top_steps, RESCUE_TOP_STEPS) + 32 * (
        r.max_brick_steps + r.max_byte_steps)


def tile_permutation(width: int, height: int, tile: int = 128) -> np.ndarray:
    """The lane order of a wave: square tiles of pixels, row-major inside
    (pathtrace.py's ``_tile_permutation``).  Lane i traces pixel perm[i]."""
    idx = np.arange(width * height, dtype=np.int64)
    x = idx % width
    y = idx // width
    key = ((y // tile) * ((width + tile - 1) // tile)
           + (x // tile)) * (width * height) + idx
    return np.argsort(key, kind="stable")


def _quant_rows(st: dict, keys, quant) -> None:
    for k in keys:
        st[k].copy_(quant(st[k]))


def _trace(st: dict, world, cam_brick, cfg: BrickmapConfig, quant,
           traces: list) -> dict:
    """W0 -> W2 -> B2 -> W0 -> W4 over the live rays, plain."""
    grid = cfg.grid
    lanes, count = compact_plain(st["live"])
    m = int(count)
    parts = gather_clip_plain(st["rays_o"], st["rays_d"], lanes, count, grid,
                              pos=st["pos"])
    parts = [a[:m] for a in parts]
    if quant is not None:
        parts = [quant(a) if a.is_floating_point() else a for a in parts]
    res = trace_clipped_rays(*parts, world.index_volume, world.pool_words,
                             world.pool_base, cam_brick, grid,
                             max_iters=cfg.render.trace_budget)
    if quant is not None:
        res["t"] = quant(res["t"])
    rows, n_rows = compact_plain(res["exhausted"], count)
    stats: dict = {}
    rescue_plain(res, rows, n_rows, lanes, st["rays_o"], st["rays_d"], world,
                 cam_brick, grid, rescue_budget(cfg), RESCUE_PASSES,
                 stats=stats)
    traces.append({
        "rows": st["live"].shape[0], "rays": m,
        "exhausted": int(n_rows),
        "b2_words": int(res["cells_read"].sum()),
        "b2_rows": int(res["rows_read"].sum()),
        "b2_steps": int(res["ray_iters"].sum()),
        "w4_words": int(stats["cells_read"].sum()) if stats else 0,
        "w4_rows": int(stats["rows_read"].sum()) if stats else 0,
        "w4_steps": stats.get("steps", 0),
    })
    return res


def wave(world, pixels, uniforms: dict, camera_arrays: dict, cam_brick,
         cfg: BrickmapConfig, width: int, height: int, quant=None):
    """One sample wave over the lanes ``pixels`` [N] (pixel ids in lane
    order) with their ``uniforms`` (lane order).  Returns (rgb [W*H, 3],
    count [W*H], traced, exhausted, traces): rgb and count in row-major
    pixel order where ``pixels`` is a permutation of every pixel, else in
    lane order; ``traces`` one dict of counts a trace (5 for 3 bounces).
    ``quant``, when given, rounds the wave's float state after every stage
    (the control's lower precision)."""
    n = pixels.shape[0]
    dev = world.device
    sun_dir = camera_arrays["sun_direction"]
    st = new_state(n, dev)
    primary_plain(pixels, uniforms, camera_arrays, width, height, st)
    if quant is not None:
        _quant_rows(st, ("rays_o", "rays_d"), quant)
    traces: list = []
    for bounce in range(cfg.render.max_bounces + 1):
        res = _trace(st, world, cam_brick, cfg, quant, traces)
        shade_plain(bounce, st, res, uniforms["cone"][bounce],
                    uniforms["hemi"][bounce], sun_dir, cfg)
        if quant is not None:
            _quant_rows(st, ("rays_o", "rays_d", "accum", "sh_color"), quant)
    res = _trace(st, world, cam_brick, cfg, quant, traces)
    full = n == width * height
    rgb, count, req = shade_plain(cfg.render.max_bounces + 1, st, res, None,
                                  None, sun_dir, cfg, final=True,
                                  dst=pixels if full else None)
    if quant is not None:
        rgb = quant(rgb)
    return (rgb, count, int(req["traced_rays"]), int(req["exhausted_rays"]),
            traces)
