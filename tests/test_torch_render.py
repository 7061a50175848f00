"""The slice as a whole: brickmap_tpu_torch's sample wave against the JAX
package's on the tests/test_render.py world, plus the port's benchmark, CLI
and import boundary.

The JAX wave draws its random numbers from threefry keys; ``jax_wave_uniforms``
replays its key tree (render_wave :670 -> primary_rays_from_arrays :93-108 ->
stratified_2d :40-44; per bounce _bucketed_wave :253-254 -> _shade_update
:561-567 -> cone_sample :124-126 and cosine_hemisphere :91-93) and returns the
draws, in the wave's (tile-permuted) lane order, for the port to consume.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.config import BrickmapConfig as JConfig, \
    GridConfig as JGrid, RenderConfig as JRender
from brickmap_tpu.ops import sunsky as jss
from brickmap_tpu.render import pathtrace as jpt
from brickmap_tpu.render.camera import Camera as JCamera
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.app import benchmark, cli
from brickmap_tpu_torch.config import BrickmapConfig, GridConfig, \
    RenderConfig
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.render import pathtrace as tpt
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 32
JCFG = JConfig(grid=JGrid(grid_size=128, grid_height=128),
               render=JRender(width=W, height=H, max_bounces=2,
                              max_top_steps=64))
TCFG = BrickmapConfig(grid=GridConfig(grid_size=128, grid_height=128),
                      render=RenderConfig(width=W, height=H, max_bounces=2,
                                          max_top_steps=64))


def jax_wave_uniforms(key, n, max_bounces):
    """Every draw of brickmap_tpu's render_wave(key) over n lanes, as
    torch tensors in the port's ``draw_wave_uniforms`` layout."""
    k_pix, k_loop = jax.random.split(key)
    k1, k2 = jax.random.split(k_pix)
    ka, kb = jax.random.split(k1)
    u = {"stratum": jax.random.randint(ka, (n,), 0, 16),
         "jitter": jax.random.uniform(kb, (n, 2)),
         "lens": jax.random.uniform(k2, (n, 2))}
    cone, hemi = [], []
    for _ in range(max_bounces + 1):
        k_loop, k_b = jax.random.split(k_loop)
        k_cone, k_bounce = jax.random.split(k_b)
        cone.append([jax.random.uniform(k, (n,))
                     for k in jax.random.split(k_cone)])
        hemi.append([jax.random.uniform(k, (n,))
                     for k in jax.random.split(k_bounce)])
    u["cone"], u["hemi"] = cone, hemi
    return {k: torch.from_numpy(np.array(v)) for k, v in u.items()}


@pytest.fixture(scope="module")
def world():
    sc = jscene.generate_terrain_scene(JCFG.grid, feature_scale=64.0)
    jsc = jscene.VoxelScene(index_volume=jnp.asarray(sc.index_volume),
                            pool_words=jnp.asarray(sc.pool_words),
                            pool_base=jnp.asarray(sc.pool_base))
    tsc = tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                  sc.pool_base, device="cpu")
    d = np.array([1.0, 1.0, -0.45])
    kw = dict(position=(20.0, 20.0, 100.0), direction=tuple(d / np.linalg.norm(d)))
    jcam, tcam = JCamera(**kw), Camera(**kw)
    jarr = jpt.camera_arrays_for(
        jcam, jss.sun_direction_from_position(jnp.asarray([0.05, 0.1])), W, H)
    tarr = camera_arrays_for(
        tcam, tss.sun_direction_from_position((0.05, 0.1), "cpu"), W, H,
        "cpu")
    return jsc, tsc, jcam, jarr, tarr


def jax_wave(world, key, cfg=JCFG):
    jsc, _, jcam, jarr, _ = world
    return jpt.render_wave(key, jsc, jarr,
                           jnp.asarray(jcam.brick_position, jnp.int32), cfg,
                           W, H)


def port_wave(world, key, cfg=TCFG):
    _, tsc, jcam, _, tarr = world
    u = jax_wave_uniforms(key, W * H, cfg.render.max_bounces)
    return tpt.render_wave(tsc, tarr, jcam.brick_position, cfg, W, H,
                           uniforms=u)


@pytest.mark.parametrize("seed", [4, 7])
def test_render_wave_matches_jax(world, seed):
    key = jax.random.PRNGKey(seed)
    rgb_j, cnt_j, req_j = jax_wave(world, key)
    rgb_t, cnt_t, req_t = port_wave(world, key)
    assert rgb_t.shape == (W * H, 3) and torch.isfinite(rgb_t).all()
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(req_t["mask"].numpy(),
                                  np.asarray(req_j["mask"]))
    assert int(req_t["traced_rays"]) == int(req_j["traced_rays"]) > W * H
    assert int(req_t["exhausted_rays"]) == int(req_j["exhausted_rays"]) == 0
    img = rgb_t.reshape(H, W, 3)
    assert float(img[: H // 4].mean()) > 0.0     # sky over the terrain


def test_tonemap_matches_jax(world):
    key = jax.random.PRNGKey(3)
    rgb_j, cnt_j, _ = jax_wave(world, key)
    jf = jpt.film_add(jpt.film_init(W, H), rgb_j, cnt_j)
    jf = jpt.film_add(jf, rgb_j * 0.5, cnt_j)
    tf = tpt.film_add(tpt.film_init(W, H, "cpu"),
                      torch.from_numpy(np.array(rgb_j)),
                      torch.from_numpy(np.array(cnt_j)))
    tf = tpt.film_add(tf, torch.from_numpy(np.array(rgb_j)) * 0.5,
                      torch.from_numpy(np.array(cnt_j)))
    img_t = tpt.tonemap(tf, W, H).numpy()
    np.testing.assert_allclose(img_t, np.asarray(jpt.tonemap(jf, W, H)),
                               rtol=1e-6, atol=1e-7)
    assert img_t.shape == (H, W, 3) and (img_t >= 0).all() \
        and (img_t <= 1).all()


def starved(cfg, **kw):
    return cfg.replace(render=dataclasses.replace(cfg.render, **kw))


def test_exhausted_rays_not_shaded_as_sky(world, monkeypatch):
    """Budget-truncated rays contribute nothing and are counted, as in the
    JAX wave without its rescue (test_render.py:125)."""
    starve = dict(max_bounces=0, max_top_steps=2, max_brick_steps=0,
                  max_byte_steps=0)
    key = jax.random.PRNGKey(33)
    jsc, _, jcam, jarr, _ = world
    jcfg = starved(JCFG, **starve)
    k_pix, k_loop = jax.random.split(key)
    st = jpt._primary_state(k_pix, jarr, jcfg, W, H)
    _, k_b = jax.random.split(k_loop)
    cam = jnp.asarray(jcam.brick_position, jnp.int32)
    st = jpt._bounce_step(jnp.int32(0), k_b, st, jsc, cam,
                          jarr["sun_direction"], jcfg)
    rgb_j, _, req_j = jpt._final_shadow(st, jsc, cam, jcfg)

    monkeypatch.setattr(tpt, "RESCUE_PASSES", 0)
    rgb_t, _, req_t = port_wave(world, key, starved(TCFG, **starve))
    n_exh = int(req_t["exhausted_rays"])
    assert n_exh == int(req_j["exhausted_rays"]) > 0
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4,
                               atol=1e-5)
    assert int((rgb_t.abs().sum(1) == 0).sum()) >= n_exh


def test_rescue_zeroes_exhausted(world, monkeypatch):
    """A starved first pass exhausts rays; the resume-from-t rescue
    re-traces them to the same image as an ample budget."""
    key = jax.random.PRNGKey(35)
    cfg = starved(TCFG, max_bounces=1, max_top_steps=3, max_brick_steps=1,
                  max_byte_steps=0)
    ample = starved(TCFG, max_bounces=1)
    rgb, _, req = port_wave(world, key, cfg)
    assert int(req["exhausted_rays"]) == 0
    rgb_hi, _, req_hi = port_wave(world, key, ample)
    np.testing.assert_allclose(rgb.numpy(), rgb_hi.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert int(req["traced_rays"]) == int(req_hi["traced_rays"])
    monkeypatch.setattr(tpt, "RESCUE_PASSES", 0)
    _, _, req0 = port_wave(world, key, cfg)
    assert int(req0["exhausted_rays"]) > 0


def jax_wave_without_rescue(world, key, jcfg):
    """The JAX wave's bounce chain with no rescue (``_bounce_step`` and
    ``_final_shadow``, as ``wave_for_indices`` runs them) over the pixels
    in ``render_wave``'s tile order: its requests (in that order)."""
    jsc, _, jcam, jarr, _ = world
    cam = jnp.asarray(jcam.brick_position, jnp.int32)
    k_pix, k_loop = jax.random.split(key)
    st = jpt._primary_state(k_pix, jarr, jcfg, W, H, pixel_order=jnp.asarray(
        jpt._tile_permutation(W, H)[0]))
    for bounce in range(jcfg.render.max_bounces + 1):
        k_loop, k_b = jax.random.split(k_loop)
        st = jpt._bounce_step(jnp.int32(bounce), k_b, st, jsc, cam,
                              jarr["sun_direction"], jcfg)
    return jpt._final_shadow(st, jsc, cam, jcfg)[2]


@pytest.mark.parametrize("seed,starve", [
    (35, dict(max_bounces=1, max_top_steps=3, max_brick_steps=1,
              max_byte_steps=0)),
    (37, dict(max_bounces=2, max_top_steps=2, max_brick_steps=0,
              max_byte_steps=0)),
])
def test_rescued_wave_matches_jax(world, monkeypatch, seed, starve):
    """Rays exhaust a starved budget in both packages; the JAX wave's in-program rescue (``_cond_rescue``, no host
    retry) and the port's (W4, its plain version here) give the same
    wave, every ray resolved."""
    key = jax.random.PRNGKey(seed)
    jcfg, tcfg = starved(JCFG, **starve), starved(TCFG, **starve)
    jsc, _, jcam, jarr, _ = world
    rgb_j, cnt_j, req_j = jpt.render_wave(
        key, jsc, jarr, jnp.asarray(jcam.brick_position, jnp.int32), jcfg,
        W, H, retry_on_overflow=False)
    rgb_t, cnt_t, req_t = port_wave(world, key, tcfg)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(req_t["mask"].numpy(),
                                  np.asarray(req_j["mask"]))
    assert int(req_t["traced_rays"]) == int(req_j["traced_rays"])
    assert int(req_t["exhausted_rays"]) == int(req_j["exhausted_rays"]) == 0

    # Both rescues had rays to resolve.  Without them the counts agree to
    # within the few rays whose DDA steps fall on the starved budget's
    # edge, where the packages' primary directions (equal to a few ulps)
    # can take one step more or less.
    monkeypatch.setattr(tpt, "RESCUE_PASSES", 0)
    _, _, req0 = port_wave(world, key, tcfg)
    n_port = int(req0["exhausted_rays"])
    n_jax = int(jax_wave_without_rescue(world, key, jcfg)["exhausted_rays"])
    assert n_port > 0 and n_jax > 0
    assert abs(n_port - n_jax) <= 0.01 * n_jax


def test_rescue_reports_when_starved(world, monkeypatch):
    monkeypatch.setattr(tpt, "RESCUE_TOP_STEPS", 1)
    monkeypatch.setattr(tpt, "RESCUE_PASSES", 1)
    cfg = starved(TCFG, max_bounces=0, max_top_steps=1, max_brick_steps=0,
                  max_byte_steps=0)
    _, _, req = port_wave(world, jax.random.PRNGKey(36), cfg)
    assert int(req["exhausted_rays"]) > 0


def test_run_forward_benchmark_on_cpu(world):
    _, tsc, _, _, _ = world
    cfg = starved(TCFG, width=24, height=16, max_bounces=1)
    out = benchmark.run_forward_benchmark(
        tsc, cfg, waves_per_view=1, warmup_waves=0, scale=128 / 4096,
        verbose=False)
    assert len(out["per_view"]) == len(benchmark.TEST_POSITIONS) == 9
    assert out["total_exhausted"] == 0 and out["device"] == "cpu"
    assert out["total_rays"] >= 9 * 24 * 16 and out["mrays_per_s"] > 0
    assert out["resolution"] == [24, 16] and out["bounces"] == 1


def test_cli_render_cpu(tmp_path):
    out = tmp_path / "r.png"
    proc = subprocess.run(
        [sys.executable, "-m", "brickmap_tpu_torch", "render", "--device",
         "cpu", "--out", str(out), "--width", "32", "--height", "24",
         "--spp", "2", "--bounces", "1", "--world", "128",
         "--world-height", "128", "--max-steps", "64", "--camera", "20",
         "20", "100", "--look", "64", "64", "40"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["spp"] == 2 and rec["waves"] == 2 and rec["device"] == "cpu"
    assert out.read_bytes().startswith(b"\x89PNG")


def test_cli_bench_cpu(capsys):
    assert cli.main(["bench", "--device", "cpu", "--width", "16",
                     "--height", "12", "--bounces", "1", "--world", "128",
                     "--world-height", "128", "--max-steps", "64",
                     "--waves", "1", "--warmup", "0"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["total_exhausted"] == 0 and rec["resolution"] == [16, 12]


def test_cli_errors_are_messages(capsys):
    assert cli.main(["render", "--device", "cpu", "--spp", "0"]) == 2
    assert "spp" in capsys.readouterr().err


def test_port_imports_neither_jax_nor_brickmap_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import brickmap_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'brickmap_tpu' or m.startswith('brickmap_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('stream', 'parallel.render', 'app.scaling',"
        " 'utils.preview', 'utils.profiling', 'utils.debug',"
        " 'kernels.replay', 'ops.replay'):\n"
        "    assert 'brickmap_tpu_torch.' + m in sys.modules, m\n"
        "assert all(hasattr(p, n) for n in p.__all__)\n"
        "assert 'full' in p.PRESETS and p.GridConfig is p.config.GridConfig\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('brickmap_tpu_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20   # every module was imported


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wave_matches_cpu_wave(world, cuda_device):
    """The wave through kernel B2 on the card against the plain version on
    the CPU, same uniforms."""
    from brickmap_tpu_torch.kernels import traverse as ktrav

    _, tsc, jcam, _, tarr = world
    u = jax_wave_uniforms(jax.random.PRNGKey(5), W * H, 2)
    rgb_c, _, req_c = tpt.render_wave(tsc, tarr, jcam.brick_position, TCFG,
                                      W, H, uniforms=u)
    before = ktrav.trace.launches
    rgb_g, _, req_g = tpt.render_wave(
        tsc.to(cuda_device), {k: v.to(cuda_device) for k, v in tarr.items()},
        jcam.brick_position, TCFG, W, H,
        uniforms={k: v.to(cuda_device) for k, v in u.items()})
    assert ktrav.trace.launches - before >= 4
    np.testing.assert_allclose(rgb_g.cpu().numpy(), rgb_c.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(req_g["mask"].cpu(), req_c["mask"])
    assert int(req_g["traced_rays"]) == int(req_c["traced_rays"])
