"""Bounce-iterated wavefront path tracer on torch tensors.

The port of ``brickmap_tpu/render/pathtrace.py``.  One sample wave (one
sample per pixel) iterates bounces to completion with masked lanes, the same
Monte Carlo estimator as the reference's persistent-thread kernels
(``kernel.cu:154-346``):

  primary rays -> per bounce: [trace extension + shadow rays -> shade + NEE]
               -> final shadow trace -> accumulate

Each trace goes through kernel B2 (:func:`brickmap_tpu_torch.kernels.
traverse.trace`).  Where the JAX package packed live lanes into a static
ladder of bucket sizes (``_ladder_switch``, a fixed-shape device for XLA),
the port compacts with dynamic shapes (``nonzero``): one host sync per trace,
plus one per rescue check.  Per-lane results are the same: every ray is
traced independently.

Shading model = the reference's: pure diffuse albedo 1, sun NEE with cone
sampling + 1e-5 radiance scale (kernel.cu:274-279), cosine-weighted bounce
(kernel.cu:287-296), miss radiance ``sunsky`` at bounce 0 else ``sky``
(kernel.cu:316-323), termination after ``max_bounces`` diffuse bounces.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import BrickmapConfig
from ..kernels.traverse import trace
from ..ops import sunsky as sunsky_mod
from ..stream import pull_requests
from .camera import primary_rays_from_arrays
from .sampling import cone_sample, cosine_hemisphere, draw_wave_uniforms

__all__ = ["render_wave", "wave_for_indices", "render_frame", "film_init",
           "film_add", "tonemap", "rescue_budget"]

_RESULT_KEYS = ("hit", "t", "normal", "request", "request_pos", "exhausted",
                "resume_t")
RESCUE_TOP_STEPS = 4096   # the escalated top-level budget (_rescue_cfg)
RESCUE_PASSES = 4         # resume-from-t passes before a ray counts exhausted


def film_init(width: int, height: int, device="cuda") -> dict:
    """Progressive accumulation buffer: rgb sums + sample count per pixel
    (the reference's RGBA32F blit buffer, state.h:22, kernel.cu:348-364)."""
    return {"rgb": torch.zeros((height * width, 3), device=device),
            "count": torch.zeros((height * width,), device=device)}


def film_add(film: dict, rgb, count) -> dict:
    return {"rgb": film["rgb"] + rgb, "count": film["count"] + count}


def tonemap(film: dict, width: int, height: int) -> torch.Tensor:
    """count-normalize + gamma 1/2.2 (blit_onto_framebuffer, kernel.cu:357-362)."""
    c = torch.clamp(film["count"][:, None], min=1e-8)
    img = torch.clamp(film["rgb"] / c, min=0.0) ** (1.0 / 2.2)
    return torch.clamp(img, 0.0, 1.0).reshape(height, width, 3)


def rescue_budget(cfg: BrickmapConfig) -> int:
    """Escalated DDA-step budget for re-tracing exhausted rays (the JAX
    package's ``_rescue_cfg``: max_top_steps raised to at least 4096)."""
    r = cfg.render
    return max(r.max_top_steps, RESCUE_TOP_STEPS) + 32 * (
        r.max_brick_steps + r.max_byte_steps)


def _rescue(res: dict, o, d, scene, cam_brick, cfg: BrickmapConfig) -> dict:
    """Re-trace exhausted rays with the escalated budget, resuming 2 voxels
    before the entry of the cell each one stopped in (its marched prefix is
    known empty).  Up to RESCUE_PASSES passes; rays still exhausted after
    them keep the flag and are counted by the wave."""
    budget = rescue_budget(cfg)
    for _ in range(RESCUE_PASSES):
        idx = torch.nonzero(res["exhausted"]).squeeze(1)
        if idx.numel() == 0:
            break
        off = torch.clamp(res["resume_t"][idx] - 2.0, min=0.0)
        r2 = trace(o[idx] + d[idx] * off[:, None], d[idx], scene, cam_brick,
                   cfg.grid, budget)
        r2["t"] = torch.where(r2["hit"], r2["t"] + off, 0.0)
        r2["resume_t"] = torch.where(r2["exhausted"], r2["resume_t"] + off,
                                     0.0)
        for k in _RESULT_KEYS:
            res[k][idx] = r2[k]
    return res


def _trace_live(o_all, d_all, live, scene, cam_brick,
                cfg: BrickmapConfig) -> dict:
    """Trace only the live lanes (compacted with ``nonzero``), rescue the
    exhausted ones, and scatter back with dead-lane defaults (all zero)."""
    m = o_all.shape[0]
    idx = torch.nonzero(live).squeeze(1)
    o, d = o_all[idx], d_all[idx]
    res = trace(o, d, scene, cam_brick, cfg.grid, cfg.render.trace_budget)
    res = _rescue(res, o, d, scene, cam_brick, cfg)
    out = {}
    for k in _RESULT_KEYS:
        full = torch.zeros((m, *res[k].shape[1:]), dtype=res[k].dtype,
                           device=o_all.device)
        full[idx] = res[k]
        out[k] = full
    return out


def _primary_state(uniforms: dict, camera_arrays: dict, width: int,
                   height: int, pixel_order) -> dict:
    """Primary rays + initial wave state for the lanes ``pixel_order``."""
    n = pixel_order.shape[0]
    dev = pixel_order.device
    origins, dirs = primary_rays_from_arrays(
        uniforms["stratum"], uniforms["jitter"], uniforms["lens"],
        camera_arrays, pixel_order, width, height)

    def full(v, *shape, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return {
        "origins": origins, "dirs": dirs,
        "accum": full(0.0, n, 3),
        "throughput": full(1.0, n, 3),
        "active": full(True, n, dtype=torch.bool),
        # Bounce 0 has no shadow rays yet.
        "sh_o": full(-10.0, n, 3),
        "sh_d": full(-1.0, n, 3),
        "sh_color": full(0.0, n, 3),
        "sh_active": full(False, n, dtype=torch.bool),
        "req_mask": full(False, n, dtype=torch.bool),
        "req_pos": full(0, n, 3, dtype=torch.int32),
        "traced": full(0, dtype=torch.int64),
        "exh_count": full(0, dtype=torch.int64),
    }


def _shade_update(bounce: int, cone_u, hemi_u, st: dict, res: dict, sun_dir,
                  cfg: BrickmapConfig) -> dict:
    """Shading + NEE + next-bounce state from a traversal result over the
    [extension; shadow] lanes (the reference's ``shade`` kernel,
    kernel.cu:242-325)."""
    n = st["origins"].shape[0]
    active, sh_active = st["active"], st["sh_active"]
    origins, dirs = st["origins"], st["dirs"]
    eps = cfg.grid.epsilon

    traced = st["traced"] + active.sum() + sh_active.sum()
    ext_hit, ext_t, ext_n = res["hit"][:n], res["t"][:n], res["normal"][:n]
    sh_hit = res["hit"][n:]
    # Budget-truncated lanes are NOT misses: they neither shade as sky
    # (extension) nor count as unoccluded sun paths (shadow); the wave
    # reports them as a count instead.
    ext_exh = res["exhausted"][:n] & active
    sh_exh = res["exhausted"][n:] & sh_active

    req_ext = res["request"][:n] & active
    req_sh = res["request"][n:] & sh_active
    req_mask = st["req_mask"] | req_ext | req_sh
    req_pos = torch.where(req_ext[:, None], res["request_pos"][:n],
                          st["req_pos"])
    req_pos = torch.where(req_sh[:, None], res["request_pos"][n:], req_pos)

    accum = st["accum"] + torch.where((sh_active & ~sh_hit & ~sh_exh)[:, None],
                                      st["sh_color"], 0.0)

    miss = active & ~ext_hit & ~ext_exh
    miss_rad = (sunsky_mod.sunsky if bounce == 0 else sunsky_mod.sky)(
        dirs, sun_dir, cfg.sky)
    accum = accum + torch.where(miss[:, None], st["throughput"] * miss_rad,
                                0.0)

    hit = active & ext_hit
    n_len2 = (ext_n * ext_n).sum(1, keepdim=True)
    ext_n = torch.where(n_len2 > 0.0, ext_n, -dirs)
    hitpoint = origins + dirs * ext_t[:, None] + ext_n * (2.0 * eps)

    sdir = cone_sample(cone_u[0], cone_u[1], sun_dir,
                       sunsky_mod.cone_extent(cfg.sky))
    sun_cos = (ext_n * sdir).sum(1)
    sun_rad = sunsky_mod.sun(sdir, sun_dir, cfg.sky)

    new_dirs = cosine_hemisphere(hemi_u[0], hemi_u[1], ext_n)
    new_active = hit & (bounce < cfg.render.max_bounces)
    new_sh_active = hit & (sun_cos > 0.0)
    dead_o = torch.full((1, 3), -10.0, device=origins.device)
    dead_d = torch.full((1, 3), -1.0, device=origins.device)
    return dict(
        st,
        origins=torch.where(new_active[:, None],
                            torch.where(hit[:, None], hitpoint, origins),
                            dead_o),
        dirs=torch.where(new_active[:, None],
                         torch.where(hit[:, None], new_dirs, dirs), dead_d),
        active=new_active,
        sh_o=torch.where(new_sh_active[:, None], hitpoint, dead_o),
        sh_d=torch.where(new_sh_active[:, None], sdir, dead_d),
        sh_color=st["throughput"] * sun_rad * (sun_cos[:, None] * 1e-5),
        sh_active=new_sh_active,
        accum=accum, req_mask=req_mask, req_pos=req_pos, traced=traced,
        exh_count=st["exh_count"] + ext_exh.sum() + sh_exh.sum(),
    )


def _final_accum_update(st: dict, res: dict):
    sh_active = st["sh_active"]
    traced = st["traced"] + sh_active.sum()
    sh_exh = res["exhausted"] & sh_active
    accum = st["accum"] + torch.where(
        (sh_active & ~res["hit"] & ~sh_exh)[:, None], st["sh_color"], 0.0)
    req = res["request"] & sh_active
    req_mask = st["req_mask"] | req
    req_pos = torch.where(req[:, None], res["request_pos"], st["req_pos"])
    count = torch.ones(accum.shape[0], device=accum.device)
    exh = st["exh_count"] + sh_exh.sum()
    return accum, count, {"mask": req_mask, "pos": req_pos,
                          "traced_rays": traced, "exhausted_rays": exh}


@functools.lru_cache(maxsize=8)
def _tile_permutation(width: int, height: int, tile: int = 128):
    """Pixel ordering that groups square tiles (neighbouring lanes trace
    neighbouring pixels). Returns (perm, inv) as read-only int64 arrays."""
    idx = np.arange(width * height, dtype=np.int64)
    x = idx % width
    y = idx // width
    key = ((y // tile) * ((width + tile - 1) // tile)
           + (x // tile)) * (width * height) + idx
    perm = np.argsort(key, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    perm.flags.writeable = False
    inv.flags.writeable = False
    return perm, inv


def wave_for_indices(scene, idx, camera_arrays: dict, cam_brick,
                     cfg: BrickmapConfig, width: int, height: int,
                     generator=None, uniforms=None):
    """Trace one sample wave for an explicit pixel-index tensor ``idx`` [M].

    The shard body of ray-sharded rendering (each rank passes its own pixel
    slice, :mod:`brickmap_tpu_torch.parallel.render`), of
    :func:`render_frame`'s chunks and of :func:`render_wave`.  ``uniforms``
    holds every random number the wave consumes, in ``idx`` order
    (:func:`~brickmap_tpu_torch.render.sampling.draw_wave_uniforms` of M
    lanes); when None they are drawn from ``generator`` on the scene's
    device.  Returns (rgb [M,3], count [M], requests dict with ``mask``,
    ``pos``, ``traced_rays`` and ``exhausted_rays``) in ``idx`` order.
    """
    if uniforms is None:
        uniforms = draw_wave_uniforms(idx.shape[0], cfg.render.max_bounces,
                                      generator, scene.device)
    sun_dir = camera_arrays["sun_direction"]

    st = _primary_state(uniforms, camera_arrays, width, height, idx)
    for bounce in range(cfg.render.max_bounces + 1):
        res = _trace_live(torch.cat([st["origins"], st["sh_o"]]),
                          torch.cat([st["dirs"], st["sh_d"]]),
                          torch.cat([st["active"], st["sh_active"]]),
                          scene, cam_brick, cfg)
        st = _shade_update(bounce, uniforms["cone"][bounce],
                           uniforms["hemi"][bounce], st, res, sun_dir, cfg)
    res = _trace_live(st["sh_o"], st["sh_d"], st["sh_active"], scene,
                      cam_brick, cfg)
    return _final_accum_update(st, res)


def render_wave(scene, camera_arrays: dict, cam_brick, cfg: BrickmapConfig,
                width: int, height: int, generator=None, uniforms=None):
    """Trace one full sample wave (1 spp for every pixel).

    :func:`wave_for_indices` over the pixels in square-tile order
    (:func:`_tile_permutation`), with outputs returned in row-major pixel
    order.  ``uniforms`` are in that tile (lane) order.

    Returns (delta_rgb [N,3], delta_count [N], requests dict with ``mask``,
    ``pos``, ``traced_rays`` and ``exhausted_rays``) — add to a Film.
    """
    dev = scene.device
    perm_np, inv_np = _tile_permutation(width, height)
    perm = torch.from_numpy(perm_np.copy()).to(dev)
    inv = torch.from_numpy(inv_np.copy()).to(dev)
    rgb, count, req = wave_for_indices(scene, perm, camera_arrays, cam_brick,
                                       cfg, width, height, generator,
                                       uniforms)
    return rgb[inv], count[inv], dict(req, mask=req["mask"][inv],
                                      pos=req["pos"][inv])


def render_frame(scene, camera_arrays: dict, cam_brick, cfg: BrickmapConfig,
                 width: int, height: int, rays_per_chunk: int = 61440,
                 generator=None, chunk_uniforms=None,
                 queue_size: int = 1024):
    """One sample wave rendered in row-major pixel chunks of
    ``rays_per_chunk`` (the JAX package's ``render_frame``).

    Every chunk has the same size: a short last chunk wraps back over the
    pixels before it, and its duplicates are dropped.  ``chunk_uniforms[c]``
    are chunk c's uniforms in its pixel order (JAX: ``fold_in(key, c)``);
    when None each chunk draws from ``generator``.  Each chunk's requests
    are pulled with ``queue_size`` (the streaming manager's; at most
    ``4 * queue_size`` lanes a chunk, :func:`~brickmap_tpu_torch.stream.
    pull_requests`).

    Returns (rgb [N,3], count [N], traced_rays int, requests list of
    (x, y, z), exhausted_rays int).
    """
    dev = scene.device
    n = width * height
    rays_per_chunk = min(rays_per_chunk, n)
    rgb_parts, count_parts, reqs = [], [], []
    traced = exhausted = 0
    for c, start in enumerate(range(0, n, rays_per_chunk)):
        stop = min(start + rays_per_chunk, n)
        idx = torch.arange(stop - rays_per_chunk, stop, device=dev)
        rgb, count, req = wave_for_indices(
            scene, idx, camera_arrays, cam_brick, cfg, width, height,
            generator,
            None if chunk_uniforms is None else chunk_uniforms[c])
        keep = rays_per_chunk - (stop - start)
        rgb_parts.append(rgb[keep:])
        count_parts.append(count[keep:])
        traced += int(req["traced_rays"])
        exhausted += int(req["exhausted_rays"])
        reqs.extend(pull_requests(req, queue_size))
    return (torch.cat(rgb_parts), torch.cat(count_parts), traced, reqs,
            exhausted)
