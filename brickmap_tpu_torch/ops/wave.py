"""Plain torch versions of kernels W0-W4, the sample wave's stages around
the traversal, and the wave's state.

These are the stages the JAX package leaves to XLA (``_compact_trace``'s
pack index, ``_primary_state``, the live-lane gather fused with
``aabb_clip``, ``_shade_update`` and ``_final_accum_update``, the
rescue passes of ``_cond_rescue``, in ``brickmap_tpu/render/pathtrace.py``,
and ``tonemap`` quantised as ``utils/image.py::to_uint8`` does),
written as the port's eager torch ops did them before the kernels
(:mod:`brickmap_tpu_torch.kernels.wave`) replaced them on the card.  They
run for CPU tensors, and ``chip_smoke.py`` holds the kernels against them
on the card.  Those that follow a compaction take its count as an int32
[1] tensor, as the kernels do, and read it on the host (on the card that
read synchronises; the kernels read it on the device).

The wave's state (:func:`new_state`), for N lanes:

* ``rays_o``, ``rays_d`` [2N, 3] f32: lane i's extension ray at row i, its
  shadow ray at row N + i (a dead ray is origin -10, direction -1);
* ``live`` [2N] bool: which of those rays the next trace follows;
* ``pos`` [2N] int32: each live ray's row in the trace's compacted list,
  -1 for a dead one (written by the gather, W2);
* ``accum``, ``sh_color`` [N, 3] f32: radiance so far, and the sun colour
  the lane's shadow ray adds if it reaches the sky;
* ``req_mask`` [N] bool, ``req_pos`` [N, 3] int32: the lane's brick
  request;
* ``counters`` [2] int64: rays traced and rays exhausted.

The diffuse albedo-1 model never changes a path's throughput from 1, so the
state carries none (the old code multiplied by ones, which is exact).
"""

from __future__ import annotations

import torch

from ..config import BrickmapConfig, GridConfig
from ..render.camera import primary_rays_from_arrays
from ..render.sampling import cone_sample, cosine_hemisphere
from . import sunsky as sunsky_mod
from .traverse import aabb_clip, trace_clipped_rays

__all__ = ["new_state", "compact_plain", "primary_plain", "gather_clip_plain",
           "shade_plain", "rescue_plain", "blit_plain", "RESULT_KEYS",
           "RESCUE_KEYS"]

RESULT_KEYS = ("hit", "t", "normal", "request", "request_pos", "exhausted")
RESCUE_KEYS = RESULT_KEYS + ("resume_t",)
DEAD_ORIGIN, DEAD_DIRECTION = -10.0, -1.0


def new_state(n: int, device) -> dict:
    """The buffers of an N-lane wave, uninitialised (W1 fills them)."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    return {"rays_o": empty(2 * n, 3), "rays_d": empty(2 * n, 3),
            "live": empty(2 * n, dtype=torch.bool),
            "pos": empty(2 * n, dtype=torch.int32),
            "accum": empty(n, 3), "sh_color": empty(n, 3),
            "req_mask": empty(n, dtype=torch.bool),
            "req_pos": empty(n, 3, dtype=torch.int32),
            "counters": empty(2, dtype=torch.int64)}


def primary_plain(idx, uniforms: dict, camera_arrays: dict, width: int,
                  height: int, st: dict) -> None:
    """W1: the lanes' primary rays (pixels ``idx``) and the initial state,
    written into ``st``."""
    n = idx.shape[0]
    origins, dirs = primary_rays_from_arrays(
        uniforms["stratum"], uniforms["jitter"], uniforms["lens"],
        camera_arrays, idx, width, height)
    st["rays_o"][:n] = origins
    st["rays_d"][:n] = dirs
    # Bounce 0 has no shadow rays yet.
    st["rays_o"][n:] = DEAD_ORIGIN
    st["rays_d"][n:] = DEAD_DIRECTION
    st["live"][:n] = True
    st["live"][n:] = False
    st["pos"].fill_(-1)
    for k in ("accum", "sh_color", "req_mask", "req_pos", "counters"):
        st[k].zero_()


def compact_plain(mask, limit=None) -> tuple:
    """W0: the indices of the set rows of ``mask`` [M] (of its first
    ``limit`` rows when given, an int32 [1] tensor), ascending, as int32
    [M] (rows past the count unwritten), and their count, int32 [1]."""
    m = mask if limit is None else mask[:int(limit)]
    rows = torch.nonzero(m).squeeze(1).int()
    out = torch.empty(mask.shape[0], dtype=torch.int32, device=mask.device)
    out[:rows.shape[0]] = rows
    return out, torch.tensor([rows.shape[0]], dtype=torch.int32,
                             device=mask.device)


def _clip_rows(rays_o, rays_d, lanes, grid: GridConfig, off=None) -> tuple:
    """The rays at rows ``lanes``, advanced ``off`` along themselves when
    given, clipped to the world box: B2's five inputs."""
    o, d = rays_o[lanes], rays_d[lanes]
    if off is not None:
        o = o + d * off[:, None]
    ok, tminn, clipped, entry_normal = aabb_clip(o, d, grid)
    return clipped, d, entry_normal, tminn, ok


def gather_clip_plain(rays_o, rays_d, lanes, count, grid: GridConfig,
                      pos=None) -> tuple:
    """W2: the rays at rows ``lanes[:count]``, clipped to the world box:
    B2's five inputs (clipped origins, directions, entry normals, tmin, ok)
    over the capacity of ``lanes``, rows past the count unwritten.  With
    ``pos`` (the state's), writes each lane's row in the list."""
    m, cap = int(count), lanes.shape[0]
    rows = lanes[:m].long()
    parts = _clip_rows(rays_o, rays_d, rows, grid)
    if pos is not None:
        pos[rows] = torch.arange(m, dtype=torch.int32, device=lanes.device)
    out = []
    for a in parts:
        full = torch.empty((cap, *a.shape[1:]), dtype=a.dtype,
                           device=a.device)
        full[:m] = a
        out.append(full)
    return tuple(out)


def rescue_plain(res: dict, rows, count, lanes, rays_o, rays_d, scene, cam,
                 grid: GridConfig, budget: int, passes: int,
                 stats: dict | None = None) -> None:
    """W4: re-trace the exhausted rays ``rows[:count]`` of a trace's
    compacted list (W0 over ``res["exhausted"]``; lane ``lanes[row]``) with
    ``budget`` DDA steps, up to ``passes`` times, each pass resuming 2
    voxels before the entry of the cell the last one stopped in (the marched
    prefix is known empty); their results (:data:`RESCUE_KEYS`) are written
    into ``res`` at their rows.  Rays still exhausted after the passes keep
    the flag.  With ``stats``, adds the passes' DDA steps (``steps``) and the
    union of the index words and brick rows they read (``cells_read``,
    ``rows_read``, as :func:`~.traverse.trace_clipped_rays` marks them)."""
    idx = rows[:int(count)].long()
    for _ in range(passes):
        if idx.numel() == 0:
            break
        off = torch.clamp(res["resume_t"][idx] - 2.0, min=0.0)
        r2 = trace_clipped_rays(
            *_clip_rows(rays_o, rays_d, lanes[idx].long(), grid, off),
            scene.index_volume, scene.pool_words, scene.pool_base, cam, grid,
            max_iters=budget)
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + int(
                r2["ray_iters"].sum())
            for k in ("cells_read", "rows_read"):
                stats[k] = stats[k] | r2[k] if k in stats else r2[k]
        r2["t"] = torch.where(r2["hit"], r2["t"] + off, 0.0)
        r2["resume_t"] = torch.where(r2["exhausted"], r2["resume_t"] + off,
                                     0.0)
        for k in RESCUE_KEYS:
            res[k][idx] = r2[k]
        idx = idx[r2["exhausted"]]


def _full_results(st: dict, res: dict) -> dict:
    """B2's compacted results on every [2N] ray, read through the position
    map, with the dead-ray defaults (all zero); resets the map."""
    live, pos = st["live"], st["pos"]
    lanes = torch.nonzero(live).squeeze(1)
    rows = pos[lanes].long()
    out = {}
    for k in RESULT_KEYS:
        full = torch.zeros((live.shape[0], *res[k].shape[1:]),
                           dtype=res[k].dtype, device=live.device)
        full[lanes] = res[k][rows]
        out[k] = full
    pos.fill_(-1)
    return out


def shade_plain(bounce: int, st: dict, res: dict, cone_u, hemi_u, sun_dir,
                cfg: BrickmapConfig, final: bool = False, dst=None):
    """W3: shading + NEE from B2's results over the wave's live rays (the
    reference's ``shade`` kernel, kernel.cu:242-325): the next bounce's
    rays and state written into ``st``.  With ``final`` (the last shadow
    trace), returns the wave's (rgb [N, 3], count [N], requests dict with
    ``mask``, ``pos``, ``traced_rays``, ``exhausted_rays``), each lane's at
    row ``dst[i]`` when ``dst`` is given, else at row i."""
    n = st["accum"].shape[0]
    full = _full_results(st, res)
    ext = {k: v[:n] for k, v in full.items()}
    sh = {k: v[n:] for k, v in full.items()}
    active, sh_active = st["live"][:n], st["live"][n:]
    counters = st["counters"]
    counters[0] += active.sum() + sh_active.sum()
    # Budget-truncated lanes are NOT misses: they neither shade as sky
    # (extension) nor count as unoccluded sun paths (shadow); the wave
    # reports them as a count instead.
    ext_exh = ext["exhausted"] & active
    sh_exh = sh["exhausted"] & sh_active
    counters[1] += ext_exh.sum() + sh_exh.sum()

    req_ext = ext["request"] & active
    req_sh = sh["request"] & sh_active
    req_mask = st["req_mask"] | req_ext | req_sh
    req_pos = torch.where(req_ext[:, None], ext["request_pos"],
                          st["req_pos"])
    req_pos = torch.where(req_sh[:, None], sh["request_pos"], req_pos)

    accum = st["accum"] + torch.where(
        (sh_active & ~sh["hit"] & ~sh_exh)[:, None], st["sh_color"], 0.0)
    if final:
        count = torch.ones(n, device=accum.device)
        req = {"mask": req_mask, "pos": req_pos, "traced_rays": counters[0],
               "exhausted_rays": counters[1]}
        if dst is None:
            return accum, count, req
        rgb = torch.empty_like(accum)
        rgb[dst] = accum
        mask = torch.empty_like(req_mask)
        mask[dst] = req_mask
        pos = torch.empty_like(req_pos)
        pos[dst] = req_pos
        return rgb, count, dict(req, mask=mask, pos=pos)

    origins, dirs = st["rays_o"][:n], st["rays_d"][:n]
    eps = cfg.grid.epsilon
    miss = active & ~ext["hit"] & ~ext_exh
    miss_rad = (sunsky_mod.sunsky if bounce == 0 else sunsky_mod.sky)(
        dirs, sun_dir, cfg.sky)
    accum = accum + torch.where(miss[:, None], miss_rad, 0.0)

    hit = active & ext["hit"]
    ext_n = ext["normal"]
    n_len2 = (ext_n * ext_n).sum(1, keepdim=True)
    ext_n = torch.where(n_len2 > 0.0, ext_n, -dirs)
    hitpoint = origins + dirs * ext["t"][:, None] + ext_n * (2.0 * eps)

    sdir = cone_sample(cone_u[0], cone_u[1], sun_dir,
                       sunsky_mod.cone_extent(cfg.sky))
    sun_cos = (ext_n * sdir).sum(1)
    sun_rad = sunsky_mod.sun(sdir, sun_dir, cfg.sky)

    new_dirs = cosine_hemisphere(hemi_u[0], hemi_u[1], ext_n)
    new_active = hit & (bounce < cfg.render.max_bounces)
    new_sh_active = hit & (sun_cos > 0.0)
    st["sh_color"].copy_(sun_rad * (sun_cos[:, None] * 1e-5))
    st["accum"].copy_(accum)
    st["req_mask"].copy_(req_mask)
    st["req_pos"].copy_(req_pos)
    st["rays_o"][:n] = torch.where(new_active[:, None], hitpoint,
                                   DEAD_ORIGIN)
    st["rays_d"][:n] = torch.where(new_active[:, None], new_dirs,
                                   DEAD_DIRECTION)
    st["rays_o"][n:] = torch.where(new_sh_active[:, None], hitpoint,
                                   DEAD_ORIGIN)
    st["rays_d"][n:] = torch.where(new_sh_active[:, None], sdir,
                                   DEAD_DIRECTION)
    st["live"][:n] = new_active
    st["live"][n:] = new_sh_active
    return None


def blit_plain(rgb, count, width: int, height: int) -> torch.Tensor:
    """W5's plain version: the film's sums ``rgb`` [N, 3] over its counts
    ``count`` [N] as 8 bits a channel, uint8 [height, width, 3]: the
    ``tonemap`` (count-normalise, clamp at 0, pow 1/2.2, clamp to [0, 1])
    then ``to_uint8`` (x 255 + 0.5, truncated), in float32 throughout."""
    c = torch.clamp(count[:, None], min=1e-8)
    img = torch.clamp(rgb / c, min=0.0) ** (1.0 / 2.2)
    img = torch.clamp(img, 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8).reshape(height, width, 3)
