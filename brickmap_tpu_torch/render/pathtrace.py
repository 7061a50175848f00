"""Bounce-iterated wavefront path tracer on torch tensors.

The port of ``brickmap_tpu/render/pathtrace.py``.  One sample wave (one
sample per pixel) iterates bounces to completion with masked lanes, the same
Monte Carlo estimator as the reference's persistent-thread kernels
(``kernel.cu:154-346``):

  primary rays (W1) -> per bounce: [compact the live extension and shadow
  rays (W0) -> gather + clip them (W2) -> trace (B2) -> compact the
  exhausted ones (W0) -> rescue them (W4) -> shade + NEE (W3)]
  -> final shadow trace (W0, W2, B2, W0, W4) -> accumulate (W3)

The kernels are :mod:`brickmap_tpu_torch.kernels.wave` (W0-W4) and
:func:`brickmap_tpu_torch.kernels.traverse.trace_clipped` (B2); for a wave
on the CPU each runs its plain torch version.  The wave's state lives in
the buffers of :func:`~brickmap_tpu_torch.ops.wave.new_state`: lane i's
extension ray at row i of [2N] ray buffers, its shadow ray at row N + i.
Where the JAX package packs live lanes into a static ladder of bucket
sizes chosen on the device (``_ladder_switch``) and gates its rescue with
``lax.cond``, the port's W0 leaves each compaction's count on the device,
where W2, B2 and W4 read it: on the card a wave makes no host round trip
between W1 and the return of its final W3.  Per-lane results are the
same: every ray is traced independently, every live one (no bucket drops
any; ROADMAP.md §C2).  So :func:`render_wave` replays a wave that repeats
as one CUDA graph (:mod:`~brickmap_tpu_torch.render.wave_graph`).

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
from ..kernels import traverse as ktrav, wave as kwave
from ..ops.wave import new_state
from ..stream import pull_requests
from ..utils.profiling import annotate, count as keep_count
from . import wave_graph
from .sampling import draw_wave_uniforms

__all__ = ["render_wave", "wave_for_indices", "render_frame", "film_init",
           "film_add", "tonemap", "present", "rescue_budget"]

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


def present(film: dict, width: int, height: int) -> torch.Tensor:
    """The film as the frame a viewer shows: uint8 [height, width, 3] on
    the film's device, ``to_uint8(tonemap(film))`` (the reference's 8-bit
    framebuffer, kernel.cu:357-362).  On the card one launch of W5
    (:func:`~brickmap_tpu_torch.kernels.wave.blit`), so the host copies 3
    bytes a pixel, not 12, and quantises nothing."""
    return kwave.blit(film["rgb"], film["count"], width, height)


def rescue_budget(cfg: BrickmapConfig) -> int:
    """Escalated DDA-step budget for re-tracing exhausted rays (the JAX
    package's ``_rescue_cfg``: max_top_steps raised to at least 4096)."""
    r = cfg.render
    return max(r.max_top_steps, RESCUE_TOP_STEPS) + 32 * (
        r.max_brick_steps + r.max_byte_steps)


def _trace_live(st: dict, scene, cam_brick, cfg: BrickmapConfig,
                counts: list) -> dict:
    """Trace the wave's live rays with no host round trip: compact them
    (W0: the lanes and their count stay on the device), gather and clip
    them with W2 (which records each lane's row for W3), trace them with
    B2, compact the exhausted ones (W0) and rescue those in place (W4: up
    to RESCUE_PASSES passes with the escalated budget; rays still exhausted
    after them keep the flag and are counted by the wave).  Returns B2's
    results over the compacted rays (rows past the count unwritten), and
    appends W0's count of the live rays to ``counts``."""
    lanes, count = kwave.compact(st["live"])
    counts.append(count)
    inputs = kwave.gather_clip(st["rays_o"], st["rays_d"], lanes, count,
                               cfg.grid, pos=st["pos"])
    res = ktrav.trace_clipped(inputs, count, scene, cam_brick, cfg.grid,
                              cfg.render.trace_budget)
    rows, n_rows = kwave.compact(res["exhausted"], count)
    kwave.rescue(res, rows, n_rows, lanes, st["rays_o"], st["rays_d"], scene,
                 cam_brick, cfg.grid, rescue_budget(cfg), RESCUE_PASSES)
    return res


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


@functools.lru_cache(maxsize=8)
def _tile_order(width: int, height: int, device) -> torch.Tensor:
    """:func:`_tile_permutation`'s ``perm`` on ``device``, copied there once
    for each frame size and device (a wave writes its outputs through it,
    so it needs no inverse)."""
    return torch.from_numpy(_tile_permutation(width, height)[0].copy()).to(
        device)


def _check_uniforms(uniforms: dict) -> None:
    """Injected float uniforms must lie in [0, 1]: W1 and W3 take the sine
    and cosine of angles made from them by a path that holds only for small
    angles (``csrc/wave.cu``'s ``sin_small``).  One synchronising read."""
    u = [uniforms[k] for k in ("jitter", "lens", "cone", "hemi")]
    if not bool(torch.stack([((x >= 0) & (x <= 1)).all() for x in u]).all()):
        raise ValueError("uniforms: jitter, lens, cone and hemi must lie "
                         "in [0, 1]")


def _wave(scene, idx, camera_arrays: dict, cam_brick, cfg: BrickmapConfig,
          width: int, height: int, generator, uniforms, dst=None,
          graph=None):
    """The wave: its uniforms drawn (or ``uniforms`` checked), then W1 to
    the final W3 launched kernel by kernel or, with ``graph`` (a
    :class:`~brickmap_tpu_torch.render.wave_graph.Call`, which the
    uniforms are drawn into), replayed as one CUDA graph.  While a profiler
    records, W0's count of each trace is kept as ``wave.trace_rays``."""
    with annotate("bm.wave"):
        with annotate("bm.wave.uniforms"):
            if uniforms is None:
                uniforms = draw_wave_uniforms(
                    idx.shape[0], cfg.render.max_bounces, generator,
                    scene.device, out=None if graph is None
                    else graph.uniforms)
            else:
                _check_uniforms(uniforms)

        def trace(u, cam):
            return _trace_wave(scene, idx, u, cam, cam_brick, cfg, width,
                               height, dst)

        rgb, count, req, counts = (trace(uniforms, camera_arrays)
                                   if graph is None
                                   else graph.run(camera_arrays, trace))
    for c in counts:
        keep_count("wave.trace_rays", c)
    return rgb, count, req


def _trace_wave(scene, idx, uniforms: dict, camera_arrays: dict, cam_brick,
                cfg: BrickmapConfig, width: int, height: int, dst):
    """W1, then a trace and W3 a bounce, the final shadow trace and the
    final W3: (rgb, count, requests, W0's count of each trace's live rays),
    with no host round trip on the card."""
    counts: list = []
    sun_dir = camera_arrays["sun_direction"]
    with annotate("bm.wave.primary"):
        st = new_state(idx.shape[0], scene.device)
        kwave.primary(idx, uniforms, camera_arrays, width, height, st)
    for bounce in range(cfg.render.max_bounces + 1):
        with annotate("bm.wave.trace"):
            res = _trace_live(st, scene, cam_brick, cfg, counts)
        with annotate("bm.wave.shade"):
            kwave.shade(bounce, st, res, uniforms["cone"][bounce],
                        uniforms["hemi"][bounce], sun_dir, cfg)
    with annotate("bm.wave.trace"):
        res = _trace_live(st, scene, cam_brick, cfg, counts)
    with annotate("bm.wave.shade"):
        rgb, count, req = kwave.shade(cfg.render.max_bounces + 1, st, res,
                                      None, None, sun_dir, cfg, final=True,
                                      dst=dst)
    return rgb, count, req, counts


def wave_for_indices(scene, idx, camera_arrays: dict, cam_brick,
                     cfg: BrickmapConfig, width: int, height: int,
                     generator=None, uniforms=None):
    """Trace one sample wave for an explicit pixel-index tensor ``idx`` [M].

    The shard body of ray-sharded rendering (each rank passes its own pixel
    slice, :mod:`brickmap_tpu_torch.parallel.render`), of
    :func:`render_frame`'s chunks and of :func:`render_wave`.  ``uniforms``
    holds every random number the wave consumes, in ``idx`` order
    (:func:`~brickmap_tpu_torch.render.sampling.draw_wave_uniforms` of M
    lanes, the floats in [0, 1], else ValueError); when None they are drawn
    from ``generator`` on the scene's device.  Returns (rgb [M,3], count
    [M], requests dict with ``mask``, ``pos``, ``traced_rays`` and
    ``exhausted_rays``) in ``idx`` order.
    """
    return _wave(scene, idx, camera_arrays, cam_brick, cfg, width, height,
                 generator, uniforms)


def render_wave(scene, camera_arrays: dict, cam_brick, cfg: BrickmapConfig,
                width: int, height: int, generator=None, uniforms=None):
    """Trace one full sample wave (1 spp for every pixel).

    :func:`wave_for_indices` over the pixels in square-tile order
    (:func:`_tile_permutation`), with outputs returned in row-major pixel
    order (W3 writes each lane's at its pixel).  ``uniforms`` are in that
    tile (lane) order.

    On the card a wave whose :func:`~brickmap_tpu_torch.render.wave_graph.
    wave_key` repeats runs as one CUDA graph (:mod:`~brickmap_tpu_torch.
    render.wave_graph`): captured on the third of three consecutive calls
    with the key, replayed on later ones, bit-equal to the eager wave for
    the same generator state.  A replay makes no device-to-host copy and no
    synchronising call; its outputs are copies out of the graph's memory,
    the caller's to keep.  ``wave_graph.calls`` counts the calls each way;
    while a profiler records, each call keeps ``wave.graph_replays`` (1
    where the wave ran as a graph).

    Returns (delta_rgb [N,3], delta_count [N], requests dict with ``mask``,
    ``pos``, ``traced_rays`` and ``exhausted_rays``) — add to a Film.
    """
    perm = _tile_order(width, height, scene.device)
    return _wave(scene, perm, camera_arrays, cam_brick, cfg, width, height,
                 generator, uniforms, dst=perm, graph=wave_graph.prepare(
                     scene, perm, cam_brick, cfg, width, height, uniforms))


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
