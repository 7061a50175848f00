"""Kernels W1-W3 (``csrc/wave.cu``) built with g++ through
``csrc/host_shim.h`` and run on the CPU, against their plain versions
(:mod:`brickmap_tpu_torch.ops.wave`).

The launchers are driven through the wrappers' own ctypes signatures and
arguments (:func:`~brickmap_tpu_torch.kernels.wave.primary_args`,
``gather_clip_args``, ``shade_args``) with CPU tensors.  The host build
takes the CPU forms of the two operations whose torch kernels round
differently on the CPU and the card (a 3-wide sum's order, ``tensor /
python_float``), so it must match the CPU plain version:

* W2 (the gather fused with ``aabb_clip``) bit for bit, NaN in the same
  places, on rays on the slab planes, with zero direction components, from
  inside and outside the box, with and without the position map;
* every mask, request, position and counter of W1 and W3 exactly;
* the floats of W1 and W3 within a stated tolerance, because the kernel
  calls glibc's ``sinf``/``cosf``/``expf``/``acosf``/``powf``/``sqrtf`` here
  and torch's CPU kernels SLEEF's vectorised versions (within 1 ulp of the
  exact value; on AVX-512 even torch's ``sqrt`` is not IEEE's, for 0.7% of
  floats).  On the card both sides call libdevice and ``chip_smoke.py``
  holds them equal.

The trace between the stages is the plain B2 (``trace_clipped_rays``) on a
terrain world, fully resident and with a third of its bricks unloaded (so
rays request bricks), with a budget small enough that some rays exhaust.
Skipped only where there is no g++.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import BRICK_FLAG_BITS, BRICK_LOD_BITS, \
    BRICK_UNLOADED_BIT, BrickmapConfig, GridConfig, RenderConfig, i32
from brickmap_tpu_torch.kernels import wave as kwave
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.ops import wave as owave
from brickmap_tpu_torch.ops.traverse import trace_clipped_rays
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for
from brickmap_tpu_torch.render.pathtrace import _tile_permutation
from _host_build import host_build

torch.set_num_threads(2)

W, H = 56, 40          # 2,240 lanes: 9 blocks of 256, the last partial
N = W * H
CFG = BrickmapConfig(grid=GridConfig(grid_size=128, grid_height=128),
                     render=RenderConfig(width=W, height=H, max_bounces=1,
                                         max_top_steps=64))
# A float the kernel computes through libm calls differs by a few ulp of
# float32 (2^-23 = 1.2e-7 relative) after the sky's exp/pow chain or a
# normalisation: RTOL.  A primary direction is (focal point - origin) / 6:
# one ulp of a focal point's coordinate near 128 (7.6e-6) moves it by
# 1.3e-6: ATOL covers three.
RTOL, ATOL = 1e-5, 4e-6
STATE_FLOATS = ("rays_o", "rays_d", "accum", "sh_color")
STATE_EXACT = ("live", "pos", "req_mask", "req_pos", "counters")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    so = ctypes.CDLL(host_build(
        "wave", str(tmp_path_factory.mktemp("whost"))))
    kwave._bind(so)
    return so


@pytest.fixture(scope="module")
def scenes():
    sc = tscene.generate_terrain_scene(CFG.grid, feature_scale=64.0,
                                       device="cpu")
    iv = sc.index_volume.clone()
    occupied = (iv & i32(BRICK_FLAG_BITS)) != 0
    flip = occupied & torch.from_numpy(
        np.random.default_rng(3).random(iv.shape) < 1 / 3)
    iv[flip] = (iv[flip] & BRICK_LOD_BITS) | BRICK_UNLOADED_BIT
    return {"resident": sc,
            "streaming": tscene.TorchScene(iv, sc.pool_words, sc.pool_base)}


def arrays(lens_radius=0.0, sun=(0.05, 0.1)):
    d = np.array([1.0, 1.0, -0.45])
    cam = Camera(position=(20.0, 20.0, 100.0),
                 direction=tuple(d / np.linalg.norm(d)),
                 lens_radius=lens_radius, focal_distance=2.0)
    return camera_arrays_for(cam, tss.sun_direction_from_position(sun, "cpu"),
                             W, H, "cpu")


def uniforms(seed, stratum_dtype=torch.int64):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.random(s, dtype=np.float32))  # noqa
    u = {"stratum": torch.from_numpy(rng.integers(0, 16, N)).to(
        stratum_dtype), "jitter": f(N, 2), "lens": f(N, 2),
        "cone": f(2, 2, N), "hemi": f(2, 2, N)}
    u["lens"][:4] = 0.5          # the disk's centre, where both offsets are 0
    u["lens"][4, 0] = 0.5        # one offset 0 (the divisions' guards)
    return u


def clone(st):
    return {k: v.clone() for k, v in st.items()}


def close(got, want, name, exact=False):
    if exact:
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True, msg=name)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   equal_nan=True, msg=name)


def check_state(got, want, exact=False):
    for k in STATE_EXACT:
        assert torch.equal(got[k], want[k]), k
    for k in STATE_FLOATS:
        close(got[k], want[k], k, exact)


def host_primary(lib, idx, u, arr, st):
    args, keep = kwave.primary_args(idx, u, arr, W, H, st, None)
    assert lib.wave_primary_launch(*args) == 0
    del keep


def host_gather(lib, rays_o, rays_d, lanes, count, grid, pos=None):
    m = lanes.shape[0]
    out = (torch.empty(m, 3), torch.empty(m, 3), torch.empty(m, 3),
           torch.empty(m), torch.empty(m, dtype=torch.bool))
    assert lib.wave_gather_clip_launch(*kwave.gather_clip_args(
        rays_o, rays_d, lanes, count, grid, pos, out, None)) == 0
    return out


def host_shade(lib, bounce, st, res, cone, hemi, sun, final=False, dst=None):
    out = None
    if final:
        out = (torch.empty(N, 3), torch.empty(N),
               torch.empty(N, dtype=torch.bool),
               torch.empty(N, 3, dtype=torch.int32))
    args, keep = kwave.shade_args(bounce, st, res, cone, hemi, sun, CFG,
                                  final, dst, out, None)
    assert lib.wave_shade_launch(*args) == 0
    del keep
    return out


def trace(st, sc, steps):
    """The plain W0, W2 and B2 over the state's live rays (the map
    written)."""
    lanes, count = owave.compact_plain(st["live"])
    inputs = owave.gather_clip_plain(st["rays_o"], st["rays_d"], lanes,
                                     count, CFG.grid, pos=st["pos"])
    res = trace_clipped_rays(*(a[:int(count)] for a in inputs),
                             sc.index_volume, sc.pool_words,
                             sc.pool_base, (2, 2, 12), CFG.grid,
                             max_iters=steps)
    return {k: res[k] for k in owave.RESULT_KEYS}


@pytest.mark.parametrize("lens_radius", [0.0, 0.7])
@pytest.mark.parametrize("stratum_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("order", ["tiles", "shuffled"])
def test_w1_primary_matches_plain(host_lib, lens_radius, stratum_dtype,
                                  order):
    perm, _ = _tile_permutation(W, H)
    idx = torch.from_numpy(perm.copy()) if order == "tiles" else \
        torch.from_numpy(np.random.default_rng(1).permutation(N))
    u = uniforms(5, stratum_dtype)
    arr = arrays(lens_radius)
    want = owave.new_state(N, "cpu")
    owave.primary_plain(idx, u, arr, W, H, want)
    got = owave.new_state(N, "cpu")
    got["counters"].fill_(7)       # W1 zeroes them
    host_primary(host_lib, idx, u, arr, got)
    check_state(got, want)


def slab_rays(grid):
    """Rays on the world box's slab planes with zero direction components,
    from inside and outside, at the corners, and random ones."""
    hi = np.array(grid.world_max, np.float32)
    rng = np.random.default_rng(11)
    o, d = [], []
    for axis in range(3):
        for plane in (0.0, hi[axis]):
            for dz in (0.0, 1.0, -1.0):
                p = rng.uniform(0.1, 0.9, 3).astype(np.float32) * hi
                p[axis] = plane
                v = rng.normal(size=3).astype(np.float32)
                v[axis] = dz
                o.append(p)
                d.append(v)
    o += [np.zeros(3, np.float32), hi.copy(), hi * 0.5, hi * 1.5,
          np.array([-5.0, 64.0, 64.0], np.float32)]
    d += [np.array([1.0, 1.0, 1.0], np.float32),
          np.array([-1.0, 0.0, 0.0], np.float32),
          np.array([0.0, 0.0, 1.0], np.float32),
          np.array([-1.0, -1.0, -1.0], np.float32),
          np.array([1.0, 0.0, 0.0], np.float32)]
    o = np.concatenate([np.stack(o),
                        rng.uniform(-0.2 * hi, 1.2 * hi, (3000, 3))])
    d = np.concatenate([np.stack(d), rng.normal(size=(3000, 3))])
    d[40:400, rng.integers(0, 3)] = 0.0
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


@pytest.mark.parametrize("with_pos", [False, True])
def test_w2_gather_clip_equals_aabb_clip(host_lib, with_pos):
    rays_o, rays_d = slab_rays(CFG.grid)
    rng = np.random.default_rng(2)
    lanes = torch.from_numpy(np.sort(rng.choice(
        rays_o.shape[0], 2500, replace=False))).int()
    lanes[:36] = torch.arange(36)            # every slab-plane ray
    lanes = lanes.contiguous()
    count = torch.tensor([lanes.shape[0]], dtype=torch.int32)
    pos_w = torch.full((rays_o.shape[0],), -1, dtype=torch.int32)
    pos_g = pos_w.clone()
    want = owave.gather_clip_plain(rays_o, rays_d, lanes, count, CFG.grid,
                                   pos_w if with_pos else None)
    got = host_gather(host_lib, rays_o, rays_d, lanes, count, CFG.grid,
                      pos_g if with_pos else None)
    for name, a, b in zip(("clipped", "dirs", "entry_normal", "tminn", "ok"),
                          got, want):
        close(a, b, name, exact=True)
    assert torch.equal(pos_g, pos_w)
    assert bool(want[4].any()) and not bool(want[4].all())
    assert bool((want[3] > 0).any()) and bool((want[3] == 0).any())


@pytest.mark.parametrize("residency", ["resident", "streaming"])
@pytest.mark.parametrize("sun", [(0.05, 0.1), (0.3, 0.45)])
def test_w3_shade_matches_plain(host_lib, scenes, residency, sun):
    """Bounce 0 (sunsky misses), bounce 1 (sky misses, the last bounce)
    and the final pass through the tile permutation, each from the same
    state on both sides; the bounce-0 trace starved so rays exhaust."""
    sc = scenes[residency]
    u = uniforms(9)
    arr = arrays(0.3, sun)
    sun_dir = arr["sun_direction"]
    perm = torch.from_numpy(_tile_permutation(W, H)[0].copy())
    st = owave.new_state(N, "cpu")
    owave.primary_plain(perm, u, arr, W, H, st)
    for bounce, steps in ((0, 12), (1, 4096)):
        res = trace(st, sc, steps)
        got = clone(st)
        host_shade(host_lib, bounce, got, res, u["cone"][bounce],
                   u["hemi"][bounce], sun_dir)
        owave.shade_plain(bounce, st, res, u["cone"][bounce],
                          u["hemi"][bounce], sun_dir, CFG)
        check_state(got, st)
        if bounce == 0:
            assert int(st["counters"][1]) > 0          # exhausted rays
            assert bool(st["live"][N:].any())          # shadow rays
    assert not bool(st["live"][:N].any())              # the last bounce
    if residency == "streaming":
        assert bool(st["req_mask"].any())
    res = trace(st, sc, 4096)
    got = clone(st)
    out = host_shade(host_lib, 2, got, res, None, None, sun_dir, final=True,
                     dst=perm)
    rgb, count, req = owave.shade_plain(2, st, res, None, None, sun_dir, CFG,
                                        final=True, dst=perm)
    close(out[0], rgb, "rgb")
    assert torch.equal(out[1], count)
    assert torch.equal(out[2], req["mask"]) and torch.equal(out[3],
                                                            req["pos"])
    assert torch.equal(got["counters"], st["counters"])
    assert float(rgb.sum()) > 0


def test_w3_final_without_permutation(host_lib, scenes):
    """The final pass writes lane i's outputs at row i without ``dst``."""
    sc = scenes["resident"]
    u = uniforms(4)
    arr = arrays()
    idx = torch.arange(N)
    st = owave.new_state(N, "cpu")
    owave.primary_plain(idx, u, arr, W, H, st)
    res = trace(st, sc, 4096)
    owave.shade_plain(1, st, res, u["cone"][0], u["hemi"][0],
                      arr["sun_direction"], CFG)
    res = trace(st, sc, 4096)
    got = clone(st)
    out = host_shade(host_lib, 2, got, res, None, None, arr["sun_direction"],
                     final=True)
    rgb, count, req = owave.shade_plain(2, st, res, None, None,
                                        arr["sun_direction"], CFG,
                                        final=True)
    close(out[0], rgb, "rgb")
    assert torch.equal(out[2], req["mask"]) and torch.equal(out[3],
                                                            req["pos"])
    assert torch.equal(got["counters"], st["counters"])


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("key,value", [("jitter", 1.5), ("hemi", -0.25),
                                       ("cone", float("nan"))])
def test_injected_uniforms_outside_unit_interval_raise(scenes, key, value):
    """W1/W3's short sine path holds only for uniforms in [0, 1]: a wave
    given others raises on every device instead of the kernel and the
    plain version disagreeing."""
    from brickmap_tpu_torch.render.pathtrace import wave_for_indices

    u = uniforms(0)
    u[key].view(-1)[5] = value
    with pytest.raises(ValueError, match=r"in \[0, 1\]"):
        wave_for_indices(scenes["resident"], torch.arange(N), arrays(),
                         (2, 2, 12), CFG, W, H, uniforms=u)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain(scenes, cuda_device):
    """On the card W1, W2 and W3 (bounce 0, bounce 1, final) equal their
    plain versions run on the same CUDA tensors, bit for bit: both call
    libdevice, and the kernel takes torch's CUDA forms of every op."""
    from brickmap_tpu_torch.kernels import traverse as ktrav

    dev = cuda_device
    sc = scenes["streaming"].to(dev)
    u = {k: v.to(dev) for k, v in uniforms(9).items()}
    arr = {k: v.to(dev) for k, v in arrays(0.3).items()}
    sun_dir = arr["sun_direction"]
    perm = torch.from_numpy(_tile_permutation(W, H)[0].copy()).to(dev)
    st = owave.new_state(N, dev)
    kwave.primary(perm, u, arr, W, H, st)
    want = owave.new_state(N, dev)
    owave.primary_plain(perm, u, arr, W, H, want)
    check_state(st, want, exact=True)

    rays_o, rays_d = (t.to(dev) for t in slab_rays(CFG.grid))
    lanes = torch.arange(0, rays_o.shape[0], 3, device=dev,
                         dtype=torch.int32)
    m = lanes.shape[0] - 7
    count = torch.tensor([m], dtype=torch.int32, device=dev)
    got = kwave.gather_clip(rays_o, rays_d, lanes, count, CFG.grid)
    ref = owave.gather_clip_plain(rays_o, rays_d, lanes, count, CFG.grid)
    for a, b in zip(got, ref):
        close(a[:m], b[:m], "gather_clip", exact=True)

    for bounce, steps in ((0, 12), (1, 4096), (2, 4096)):
        lanes, count = kwave.compact(st["live"])
        want_lanes, want_count = owave.compact_plain(st["live"])
        m = int(want_count)
        assert torch.equal(count, want_count)
        assert torch.equal(lanes[:m], want_lanes[:m])
        inputs = kwave.gather_clip(st["rays_o"], st["rays_d"], lanes, count,
                                   CFG.grid, pos=st["pos"])
        res = ktrav.trace_clipped(inputs, count, sc, (2, 2, 12), CFG.grid,
                                  steps)
        ref = clone(st)
        final = bounce == 2
        cone = None if final else u["cone"][bounce]
        hemi = None if final else u["hemi"][bounce]
        got = kwave.shade(bounce, st, res, cone, hemi, sun_dir, CFG, final,
                          perm if final else None)
        want = owave.shade_plain(bounce, ref, res, cone, hemi, sun_dir, CFG,
                                 final, perm if final else None)
        check_state(st, ref, exact=True)
        if final:
            close(got[0], want[0], "rgb", exact=True)
            for k in ("mask", "pos", "traced_rays", "exhausted_rays"):
                assert torch.equal(got[2][k], want[2][k]), k


@pytest.mark.cuda
def test_cuda_starved_wave_equals_plain(scenes, cuda_device, monkeypatch):
    """A wave on the card whose traces exhaust a starved budget, so that
    W4 rescues rays: through the kernels it equals the same wave with the
    plain W0-W4 swapped in."""
    import dataclasses

    from brickmap_tpu_torch.render import pathtrace

    dev = cuda_device
    sc = scenes["streaming"].to(dev)
    cfg = CFG.replace(render=dataclasses.replace(
        CFG.render, max_top_steps=3, max_brick_steps=1, max_byte_steps=0))
    u = {k: v.to(dev) for k, v in uniforms(12).items()}
    arr = {k: v.to(dev) for k, v in arrays(0.3).items()}
    launches = kwave.rescue.launches
    got = pathtrace.render_wave(sc, arr, (2, 2, 12), cfg, W, H, uniforms=u)
    assert kwave.rescue.launches - launches == 3         # one a trace
    # W4 had rays to rescue: without its passes the same wave leaves some
    # exhausted.
    passes = pathtrace.RESCUE_PASSES
    monkeypatch.setattr(pathtrace, "RESCUE_PASSES", 0)
    unrescued = pathtrace.render_wave(sc, arr, (2, 2, 12), cfg, W, H,
                                      uniforms=u)
    assert int(unrescued[2]["exhausted_rays"]) > 0
    monkeypatch.setattr(pathtrace, "RESCUE_PASSES", passes)
    for name, plain in (("compact", owave.compact_plain),
                        ("primary", owave.primary_plain),
                        ("gather_clip", owave.gather_clip_plain),
                        ("shade", owave.shade_plain),
                        ("rescue", owave.rescue_plain)):
        monkeypatch.setattr(kwave, name, plain)
    want = pathtrace.render_wave(sc, arr, (2, 2, 12), cfg, W, H, uniforms=u)
    close(got[0], want[0], "rgb", exact=True)
    for k in ("mask", "pos", "traced_rays", "exhausted_rays"):
        assert torch.equal(got[2][k], want[2][k]), k
    assert int(got[2]["exhausted_rays"]) == 0
