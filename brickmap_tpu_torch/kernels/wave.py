"""Kernels W0-W5: the sample wave's stages around the traversal, and the
film shown as 8 bits.

The JAX package leaves these stages to XLA, which fuses each jitted stage
(``brickmap_tpu/render/pathtrace.py``) into a few device programs; the port
runs them as hand-written CUDA kernels (``csrc/wave.cu``), one thread per
lane, ray or row:

* :func:`compact` (W0, ``compact_kernel``): ``_compact_trace``'s pack
  index, the set rows of a mask in ascending order and their count, both
  left on the device, in one single-pass launch;
* :func:`primary` (W1, ``primary_kernel``): ``_primary_state`` — the
  lanes' primary rays and the wave's initial state, written into the
  state's buffers (:func:`brickmap_tpu_torch.ops.wave.new_state`);
* :func:`gather_clip` (W2, ``gather_clip_kernel``): the compacted live
  rays clipped to the world box — exactly the five inputs of kernel B2
  (:func:`~brickmap_tpu_torch.kernels.traverse.trace_clipped`) — and each
  lane's row in the compacted list;
* :func:`shade` (W3, ``shade_kernel``): ``_shade_update`` once a bounce,
  reading B2's compacted results through W2's rows and writing the next
  bounce's rays in place; with ``final``, ``_final_accum_update`` and the
  wave's outputs;
* :func:`rescue` (W4, ``rescue_kernel``): ``_cond_rescue``, the exhausted
  rays re-traced with the escalated budget, all passes of a ray in one
  thread, their results written back at their rows;
* :func:`blit` (W5, ``blit_kernel``): ``tonemap`` with ``to_uint8``, the
  film as the 8-bit frame a viewer shows, one thread a pixel.

W0, W2 and W4 launch at most the blocks resident at once, so a small count
costs one wave of blocks, not a grid over the capacity.  W2's blocks walk
its 256-row tiles with a grid-stride loop; W0's and W4's take tiles (W0) or
32 rays a warp (W4) from a cursor in :func:`scratch`, a buffer held for each
device and stream; each launch leaves it zeroed, so the launches carry no
per-call host state.

W2, B2 and W4 read W0's count on the device, so a trace makes no host round
trip.  For tensors on the CPU each wrapper runs its plain version
(:mod:`brickmap_tpu_torch.ops.wave`); on any other device than the CPU or
CUDA it raises.  Each counts its kernel's launches in ``.launches`` and
has the ``.events`` hook of
:mod:`brickmap_tpu_torch.kernels`.  :func:`compact_args`,
:func:`primary_args`, :func:`gather_clip_args`, :func:`shade_args` and
:func:`rescue_args` build the launchers' ctypes arguments (the host
rehearsals of ``csrc/wave.cu``, ``tests/test_torch_wave_host.py`` and
``tests/test_torch_compact_host.py``, drive the launchers with them).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..config import BrickmapConfig, GridConfig, SunSkyConfig
from ..ops import sunsky as sunsky_mod
from ..ops.wave import blit_plain, compact_plain, gather_clip_plain, \
    primary_plain, rescue_plain, shade_plain
from . import build, hooked
from . import traverse as ktrav

__all__ = ["compact", "primary", "gather_clip", "shade", "rescue", "blit",
           "sky_constants", "scratch", "scratch_words", "compact_args",
           "primary_args", "gather_clip_args", "shade_args", "rescue_args"]

_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
_CAMERA_KEYS = ("position", "direction", "right", "up", "focal_distance",
                "lens_radius")


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wave_primary_launch.argtypes = (
        [i, p, p, p, p] + [p] * 6 + [i, i] + [p] * 9 + [p])
    lib.wave_compact_launch.argtypes = [i] + [p] * 5 + [p]
    lib.wave_gather_clip_launch.argtypes = (
        [i, p, p, p, p, p] + [f] * 8 + [p] * 5 + [p])
    lib.wave_rescue_launch.argtypes = (
        [i] + [p] * 5 + [f] * 8 + [p] * 3 + [i] * 12 + [f, i, i] + [p] * 8
        + [p])
    lib.wave_shade_launch.argtypes = (
        [i] * 4 + [p] * 4 + [p] * 6 + [p] * 5 + [p] * 4 + [p, p, f]
        + [p] * 5 + [p])
    lib.wave_blit_launch.argtypes = [i, p, p, p, p]
    for fn in (lib.wave_compact_launch, lib.wave_primary_launch,
               lib.wave_gather_clip_launch, lib.wave_shade_launch,
               lib.wave_rescue_launch, lib.wave_blit_launch):
        fn.restype = i


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _on(t: torch.Tensor, dev, dtype, shape, name: str) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor on ``dev`` (a copy only where
    it is not one already), checked against ``shape``."""
    t = t.to(device=dev, dtype=dtype).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t


def _check_state(st: dict, dev) -> int:
    n = st["accum"].shape[0]
    want = {"rays_o": (2 * n, 3), "rays_d": (2 * n, 3), "live": (2 * n,),
            "pos": (2 * n,), "accum": (n, 3), "sh_color": (n, 3),
            "req_mask": (n,), "req_pos": (n, 3), "counters": (2,)}
    for k, shape in want.items():
        a = st[k]
        if a.device != dev or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"wave state {k}: must be contiguous {shape} "
                             f"on {dev}")
    if n > build.MAX_RAYS // 2:
        raise ValueError(f"at most {build.MAX_RAYS // 2} lanes a wave")
    return n


def _device(dev, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")


@functools.lru_cache(maxsize=16)
def sky_constants(sky: SunSkyConfig, device) -> torch.Tensor:
    """The sky model's float32 constants as W3 reads them (the layout of
    ``csrc/wave.cu``'s ``enum Sky``), built once a config and device: the
    Rayleigh coefficients, ``_total_mie * mie_coefficient`` computed by
    the plain torch code on ``device``, then each Python constant of
    :mod:`~brickmap_tpu_torch.ops.sunsky` rounded to float32 as torch
    rounds a scalar operand."""
    dev = torch.device(device)
    g = sky.mie_directional_g
    sadc = sky.sun_angular_diameter_cos
    scalars = [sky.sun_intensity, sky.cutoff_angle, sky.steepness,
               sky.rayleigh_zenith_length, sky.mie_zenith_length,
               3.0 / (16.0 * math.pi), 1.0 / (4.0 * math.pi), 1.0 - g ** 2,
               2.0 * g, g ** 2, sky.sky_factor * 0.01, sadc,
               (sadc + 0.00002) - sadc, float(sadc < 1.0), float(sadc < 0.0),
               sunsky_mod.cone_extent(sky)]
    return torch.cat([
        torch.tensor(sunsky_mod.RAYLEIGH, dtype=_F32, device=dev),
        sunsky_mod._total_mie(sky, dev) * sky.mie_coefficient,
        torch.tensor(scalars, dtype=_F32, device=dev)])


# ---- W0 -------------------------------------------------------------------

_SCAN_TILE = 4096   # rows a tile of W0 (csrc/wave.cu: kScanTile)
_scratch: dict = {}


def scratch_words(rows: int) -> int:
    """Words (int64) of W0's and W4's scratch for masks of up to ``rows``
    rows: four int32 counters (csrc/wave.cu: ``Ctl``), then a status word
    a tile."""
    return 2 + -(-rows // _SCAN_TILE)


def scratch(device) -> torch.Tensor:
    """The scratch of W0 and W4 on ``device``'s current stream: int64
    [:func:`scratch_words` (``MAX_RAYS``)], zeroed once when first asked
    for.  Every launch leaves it zeroed again (its last block out resets
    what it used), so launches in order on one stream share it."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(scratch_words(build.MAX_RAYS),
                                          dtype=_I64, device=dev)
    return buf


def compact_args(mask, limit, out, count, scratch_, stream) -> tuple:
    """``wave_compact_launch``'s arguments: ``out`` and ``count`` are
    :func:`compact`'s result, ``scratch_`` a zeroed int64 tensor of at
    least :func:`scratch_words` (rows of the mask) words."""
    return (mask.shape[0], mask.data_ptr(), _ptr(limit), out.data_ptr(),
            count.data_ptr(), scratch_.data_ptr(), stream)


def compact(mask, limit=None) -> tuple:
    """W0: the indices of the set rows of the bool ``mask`` [M] (of its
    first ``limit`` rows when given: an int32 [1] tensor on the mask's
    device), in ascending order, as int32 [M] (rows past the count are
    left unwritten), and their count, int32 [1] — both on the device, no
    host round trip.  The mask must be 16-byte aligned on the card."""
    dev = mask.device
    if dev.type == "cpu":
        return compact_plain(mask, limit)
    _device(dev, "compact")
    m = mask.shape[0]
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous() or mask.data_ptr() % 16:
        raise ValueError(f"compact: mask must be a contiguous, 16-byte "
                         f"aligned bool [M] on {dev}")
    if m > build.MAX_RAYS:
        raise ValueError(f"compact: at most {build.MAX_RAYS} rows")
    if limit is not None:
        ktrav.check_count(limit, dev, "compact")
    out = torch.empty(m, dtype=_I32, device=dev)
    count = torch.empty(1, dtype=_I32, device=dev)
    if not m:
        return out, count.zero_()
    lib = build.load("wave", _bind)
    with torch.cuda.device(dev):
        status = hooked(compact, lib.wave_compact_launch, *compact_args(
            mask, limit, out, count, scratch(dev),
            torch.cuda.current_stream(dev).cuda_stream))
    build.check(status, "compact_kernel")
    compact.launches += 1
    return out, count


compact.launches = 0
compact.events = None


# ---- W1 -------------------------------------------------------------------

def primary_args(idx, uniforms: dict, camera_arrays: dict, width: int,
                 height: int, st: dict, stream) -> tuple:
    """``(args, keep)``: ``wave_primary_launch``'s arguments, and the
    tensors they point into (held until the launch is queued)."""
    dev = st["accum"].device
    n = _check_state(st, dev)
    idx = _on(idx, dev, _I64, (n,), "idx")
    stratum = _on(uniforms["stratum"], dev, _I64, (n,), "stratum")
    jitter = _on(uniforms["jitter"], dev, _F32, (n, 2), "jitter")
    lens = _on(uniforms["lens"], dev, _F32, (n, 2), "lens")
    cam = [_on(camera_arrays[k], dev, _F32,
               (3,) if k in _CAMERA_KEYS[:4] else (), k)
           for k in _CAMERA_KEYS]
    keep = [idx, stratum, jitter, lens, *cam]
    args = (n, idx.data_ptr(), stratum.data_ptr(), jitter.data_ptr(),
            lens.data_ptr(), *(c.data_ptr() for c in cam), width, height,
            *(st[k].data_ptr() for k in ("rays_o", "rays_d", "live", "pos",
                                         "accum", "sh_color", "req_mask",
                                         "req_pos", "counters")), stream)
    return args, keep


def primary(idx, uniforms: dict, camera_arrays: dict, width: int,
            height: int, st: dict) -> None:
    """W1: the primary rays of the lanes' pixels ``idx`` (one per lane,
    from the lanes' ``stratum``/``jitter``/``lens`` uniforms) and the
    wave's initial state, written into ``st``."""
    dev = st["accum"].device
    if dev.type == "cpu":
        primary_plain(idx, uniforms, camera_arrays, width, height, st)
        return
    _device(dev, "primary")
    lib = build.load("wave", _bind)
    with torch.cuda.device(dev):
        args, keep = primary_args(idx, uniforms, camera_arrays, width,
                                  height, st,
                                  torch.cuda.current_stream(dev).cuda_stream)
        status = hooked(primary, lib.wave_primary_launch, *args)
    build.check(status, "primary_kernel")
    primary.launches += 1
    del keep


primary.launches = 0
primary.events = None


# ---- W2 -------------------------------------------------------------------

def _box_args(grid: GridConfig) -> tuple:
    """The world box as W2's and W4's launchers take it."""
    gs, gh = float(grid.grid_size), float(grid.grid_height)
    return (*grid.world_max, gs / 2, gs / 2, gh / 2, gh / gs, grid.epsilon)


def gather_clip_args(rays_o, rays_d, lanes, count, grid: GridConfig, pos,
                     out: tuple, stream) -> tuple:
    """``wave_gather_clip_launch``'s arguments; ``out`` = the five output
    tensors (:func:`gather_clip`'s result)."""
    return (lanes.shape[0], count.data_ptr(), rays_o.data_ptr(),
            rays_d.data_ptr(), lanes.data_ptr(), _ptr(pos),
            *_box_args(grid), *(a.data_ptr() for a in out), stream)


def gather_clip(rays_o, rays_d, lanes, count, grid: GridConfig,
                pos=None) -> tuple:
    """W2: the rays at rows ``lanes[:count]`` (int32; ``count`` an int32
    [1] tensor on the device, as :func:`compact` gives them) of the wave's
    [2N] buffers, clipped to the world box: (clipped origins, directions,
    entry normals, tmin, ok), B2's inputs, over the capacity of ``lanes``
    (rows past the count are left unwritten).  With ``pos`` (the state's
    [2N] rows), writes each lane's row in ``lanes`` there.  The count is
    read on the device: one launch of at most the blocks resident at once,
    which walk the count's 256-row tiles and return at once when it is 0.
    Each tile's [256, 3] outputs are stored as runs of 16-byte words (the
    outputs, allocated here, are 16-byte aligned)."""
    dev = rays_o.device
    if dev.type == "cpu":
        return gather_clip_plain(rays_o, rays_d, lanes, count, grid, pos)
    _device(dev, "gather_clip")
    m, rows = lanes.shape[0], rays_o.shape[0]
    for name, a, dtype, shape in (
            ("rays_o", rays_o, _F32, (rows, 3)),
            ("rays_d", rays_d, _F32, (rows, 3)),
            ("lanes", lanes, _I32, (m,)), ("pos", pos, _I32, (rows,))):
        if a is not None and (a.device != dev or a.dtype != dtype
                              or tuple(a.shape) != shape
                              or not a.is_contiguous()):
            raise ValueError(f"gather_clip: {name} must be contiguous "
                             f"{dtype} {shape} on {dev}")
    ktrav.check_count(count, dev, "gather_clip")
    if max(m, rows) > build.MAX_RAYS:
        raise ValueError(f"gather_clip: at most {build.MAX_RAYS} rows")

    def empty(*shape, dtype=_F32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = (empty(m, 3), empty(m, 3), empty(m, 3), empty(m),
           empty(m, dtype=torch.bool))
    if m:
        lib = build.load("wave", _bind)
        with torch.cuda.device(dev):
            status = hooked(gather_clip, lib.wave_gather_clip_launch,
                            *gather_clip_args(
                                rays_o, rays_d, lanes, count, grid, pos, out,
                                torch.cuda.current_stream(dev).cuda_stream))
        build.check(status, "gather_clip_kernel")
        gather_clip.launches += 1
    return out


gather_clip.launches = 0
gather_clip.events = None


# ---- W3 -------------------------------------------------------------------

_RES = (("hit", torch.bool, ()), ("t", _F32, ()), ("normal", _F32, (3,)),
        ("request", torch.bool, ()), ("request_pos", _I32, (3,)),
        ("exhausted", torch.bool, ()))


def shade_args(bounce: int, st: dict, res: dict, cone_u, hemi_u, sun_dir,
               cfg: BrickmapConfig, final: bool, dst, out, stream) -> tuple:
    """``(args, keep)``: ``wave_shade_launch``'s arguments and the tensors
    they point into.  ``out`` = (rgb, count, mask, pos) for ``final``."""
    dev = st["accum"].device
    n = _check_state(st, dev)
    m = res["hit"].shape[0]
    for k, dtype, tail in _RES:
        a = res[k]
        if a.device != dev or a.dtype != dtype \
                or tuple(a.shape) != (m, *tail) or not a.is_contiguous():
            raise ValueError(f"shade: result {k} must be contiguous {dtype} "
                             f"{(m, *tail)} on {dev}")
    sky = sky_constants(cfg.sky, dev)
    sun = _on(sun_dir, dev, _F32, (3,), "sun_dir")
    keep = [sky, sun]
    if final:
        u = (None,) * 4
    else:
        cone = _on(cone_u, dev, _F32, (2, n), "cone")
        hemi = _on(hemi_u, dev, _F32, (2, n), "hemi")
        keep += [cone, hemi]
        u = (cone[0].data_ptr(), cone[1].data_ptr(), hemi[0].data_ptr(),
             hemi[1].data_ptr())
    if dst is not None:
        dst = _on(dst, dev, _I64, (n,), "dst")
        keep.append(dst)
    args = (n, bounce, cfg.render.max_bounces, int(final),
            *(st[k].data_ptr() for k in ("rays_o", "rays_d", "live", "pos")),
            *(res[k].data_ptr() for k, _, _ in _RES),
            *(st[k].data_ptr() for k in ("sh_color", "accum", "req_mask",
                                         "req_pos", "counters")),
            *u, sun.data_ptr(), sky.data_ptr(), 2.0 * cfg.grid.epsilon,
            _ptr(dst), *(_ptr(a) for a in (out or (None,) * 4)), stream)
    return args, keep


def shade(bounce: int, st: dict, res: dict, cone_u, hemi_u, sun_dir,
          cfg: BrickmapConfig, final: bool = False, dst=None):
    """W3: shading + NEE of bounce ``bounce`` from B2's results ``res``
    over the rays W2 gathered (``cone_u``/``hemi_u`` [2, N]: the bounce's
    sun-cone and hemisphere uniforms), the next bounce's rays and state
    written into ``st``.  With ``final`` (after the last shadow trace),
    returns the wave's (rgb [N, 3], count [N], requests dict with ``mask``,
    ``pos``, ``traced_rays``, ``exhausted_rays``), lane i's at row
    ``dst[i]`` when ``dst`` is given, else at row i."""
    dev = st["accum"].device
    if dev.type == "cpu":
        return shade_plain(bounce, st, res, cone_u, hemi_u, sun_dir, cfg,
                           final, dst)
    _device(dev, "shade")
    n = st["accum"].shape[0]
    out = None
    if final:
        out = (torch.empty((n, 3), device=dev), torch.empty(n, device=dev),
               torch.empty(n, dtype=torch.bool, device=dev),
               torch.empty((n, 3), dtype=_I32, device=dev))
    lib = build.load("wave", _bind)
    with torch.cuda.device(dev):
        args, keep = shade_args(bounce, st, res, cone_u, hemi_u, sun_dir,
                                cfg, final, dst, out,
                                torch.cuda.current_stream(dev).cuda_stream)
        status = hooked(shade, lib.wave_shade_launch, *args)
    build.check(status, "shade_kernel")
    if n:
        shade.launches += 1
    del keep
    if not final:
        return None
    counters = st["counters"]
    return out[0], out[1], {"mask": out[2], "pos": out[3],
                            "traced_rays": counters[0],
                            "exhausted_rays": counters[1]}


shade.launches = 0
shade.events = None


# ---- W4 -------------------------------------------------------------------

_RESCUED = (("hit", torch.bool, ()), ("t", _F32, ()), ("normal", _F32, (3,)),
            ("request", torch.bool, ()), ("request_pos", _I32, (3,)),
            ("exhausted", torch.bool, ()), ("resume_t", _F32, ()))


def rescue_args(res: dict, rows, count, lanes, rays_o, rays_d, scene, cam,
                grid: GridConfig, budget: int, passes: int, scratch_,
                stream) -> tuple:
    """``wave_rescue_launch``'s arguments (``scratch_`` as
    :func:`compact_args` takes it)."""
    return (rows.shape[0], count.data_ptr(), rows.data_ptr(),
            lanes.data_ptr(), rays_o.data_ptr(), rays_d.data_ptr(),
            *_box_args(grid),
            *ktrav.walk_args(scene.index_volume, scene, cam, grid, budget),
            passes, *(res[k].data_ptr() for k, _, _ in _RESCUED),
            scratch_.data_ptr(), stream)


def rescue(res: dict, rows, count, lanes, rays_o, rays_d, scene, cam_brick,
           grid: GridConfig, budget: int, passes: int) -> None:
    """W4: re-trace the exhausted rays ``rows[:count]`` (:func:`compact`
    over ``res["exhausted"]``) of a trace whose rays are ``lanes`` of the
    wave's buffers ``rays_o``/``rays_d``, with ``budget`` DDA steps, up to
    ``passes`` times, each pass from 2 voxels before the entry of the cell
    the last stopped in; their results (B2's keys and ``resume_t``) are
    written into ``res`` at their rows.  Rays still exhausted after the
    passes keep the flag.  One launch of the blocks resident at once (at
    most one thread a row of ``rows``); the count is read on the device,
    and when it is 0 every block returns."""
    dev = rows.device
    cam = tuple(int(c) for c in cam_brick)
    if dev.type == "cpu":
        rescue_plain(res, rows, count, lanes, rays_o, rays_d, scene, cam,
                     grid, budget, passes)
        return
    _device(dev, "rescue")
    ktrav.check_scene(scene, grid, dev)
    cap, n_rays = rows.shape[0], rays_o.shape[0]
    for name, a, dtype, shape in (
            ("rows", rows, _I32, (cap,)), ("lanes", lanes, _I32, (cap,)),
            ("rays_o", rays_o, _F32, (n_rays, 3)),
            ("rays_d", rays_d, _F32, (n_rays, 3)),
            *((k, res[k], dtype, (cap, *tail)) for k, dtype, tail in
              _RESCUED)):
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"rescue: {name} must be contiguous {dtype} "
                             f"{shape} on {dev}")
    ktrav.check_count(count, dev, "rescue")
    if max(cap, n_rays) > build.MAX_RAYS:
        raise ValueError(f"rescue: at most {build.MAX_RAYS} rows")
    if not cap:
        return
    lib = build.load("wave", _bind)
    with torch.cuda.device(dev):
        status = hooked(rescue, lib.wave_rescue_launch, *rescue_args(
            res, rows, count, lanes, rays_o, rays_d, scene, cam, grid,
            budget, passes, scratch(dev),
            torch.cuda.current_stream(dev).cuda_stream))
    build.check(status, "rescue_kernel")
    rescue.launches += 1


rescue.launches = 0
rescue.events = None


# ---- W5 -------------------------------------------------------------------

def blit(rgb, count, width: int, height: int) -> torch.Tensor:
    """W5: the film's sums ``rgb`` [N, 3] over its counts ``count`` [N]
    (float32, N = ``width * height``, row-major pixels) as the 8-bit frame,
    uint8 [height, width, 3] on their device: ``tonemap`` then
    ``to_uint8``, bit for bit as :func:`~brickmap_tpu_torch.ops.wave.
    blit_plain` computes it on the same device.  One launch."""
    dev = rgb.device
    if dev.type == "cpu":
        return blit_plain(rgb, count, width, height)
    _device(dev, "blit")
    n = width * height
    for name, a, shape in (("rgb", rgb, (n, 3)), ("count", count, (n,))):
        if a.device != dev or a.dtype != _F32 or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"blit: {name} must be contiguous float32 "
                             f"{shape} on {dev}")
    if n > build.MAX_RAYS:
        raise ValueError(f"blit: at most {build.MAX_RAYS} pixels")
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
    if n:
        lib = build.load("wave", _bind)
        with torch.cuda.device(dev):
            status = hooked(blit, lib.wave_blit_launch, n, rgb.data_ptr(),
                            count.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
        build.check(status, "blit_kernel")
        blit.launches += 1
    return out


blit.launches = 0
blit.events = None
