"""The live viewer of brickmap_tpu_torch against the JAX package's: the
preview server, the fly camera and the turntable, ``render``'s viewer flags,
profiling and the NaN trap, rendering by pixel index (``wave_for_indices``,
``render_frame``) and the dense compositor's benchmark stage.

Waves are held at the tolerance of tests/test_torch_render.py (rtol 1e-4,
atol 1e-5; requests equal), with the JAX draws injected as uniforms by its
``jax_wave_uniforms``.  The ``cuda`` test drives the viewer loop on the card.
"""

import argparse
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.app import cli as jcli
from brickmap_tpu.ops import sunsky as jss
from brickmap_tpu.render import pathtrace as jpt
from brickmap_tpu.render.camera import Camera as JCamera
from brickmap_tpu.utils import debug as jdebug
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.app import benchmark, cli
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.render import pathtrace as tpt
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for
from brickmap_tpu_torch.utils.debug import debug_nans
from brickmap_tpu_torch.utils.preview import PreviewServer
from brickmap_tpu_torch.utils.profiling import annotate, trace
from test_torch_render import JCFG, TCFG, jax_wave_uniforms

torch.set_num_threads(2)

W, H = 48, 32
SMALL_WORLD = ["--world", "128", "--world-height", "128", "--max-steps",
               "64", "--camera", "20", "20", "100", "--look", "64", "64",
               "40"]


# ---------------------------------------------------------------------------
# The preview server: the three cases of tests/test_preview.py
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status


def test_preview_server_serves_frames_and_stats():
    srv = PreviewServer(0)
    try:
        assert srv._httpd.server_address[0] == "127.0.0.1"
        assert b"brickmap-tpu" in _get(srv.port, "/")

        img = np.zeros((8, 16, 3), np.float32)
        img[:, :, 0] = 1.0
        srv.update(img, wave=3, mrays_s=1.5)

        png = _get(srv.port, "/frame.png")
        assert png.startswith(b"\x89PNG\r\n\x1a\n")

        stats = json.loads(_get(srv.port, "/stats.json"))
        assert stats["wave"] == 3
        assert stats["mrays_s"] == 1.5
        assert stats["frame_seq"] == 1

        srv.update(img * 0.5, wave=4)
        stats = json.loads(_get(srv.port, "/stats.json"))
        assert stats["frame_seq"] == 2
        assert stats["wave"] == 4
    finally:
        srv.close()


def test_preview_camera_input_accumulates_and_drains():
    srv = PreviewServer(0, host="127.0.0.1")
    try:
        assert srv.pop_camera() is None
        assert _post(srv.port, "/camera",
                     {"move": [1.0, 0.0, 0.5], "rot": [0.1, 0.0]}) == 204
        assert _post(srv.port, "/camera",
                     {"move": [0.5, -1.0, 0.0], "rot": [0.0, -0.2]}) == 204
        d = srv.pop_camera()
        assert d is not None
        np.testing.assert_allclose(d["move"], [1.5, -1.0, 0.5])
        np.testing.assert_allclose(d["rot"], [0.1, -0.2])
        assert srv.pop_camera() is None          # drained
    finally:
        srv.close()


def test_apply_camera_input_moves_and_turns():
    cam = Camera(position=(10.0, 10.0, 10.0), direction=(0.0, 1.0, 0.0))
    # Pure forward move: position advances along +y, direction unchanged.
    c2 = cli._apply_camera_input(cam, {"move": [2.0, 0.0, 0.0],
                                       "rot": [0.0, 0.0]}, move_scale=1.0)
    np.testing.assert_allclose(c2.position, (10.0, 12.0, 10.0), atol=1e-6)
    np.testing.assert_allclose(c2.direction, (0.0, 1.0, 0.0), atol=1e-6)
    # Quarter yaw turn: now facing +x (camera.cpp yaw convention).
    c3 = cli._apply_camera_input(c2, {"move": [0.0, 0.0, 0.0],
                                      "rot": [np.pi / 2, 0.0]},
                                 move_scale=1.0)
    np.testing.assert_allclose(c3.direction, (1.0, 0.0, 0.0), atol=1e-6)
    # Up impulse is world-up regardless of pitch.
    c4 = cli._apply_camera_input(c3, {"move": [0.0, 0.0, 3.0],
                                      "rot": [0.0, 0.0]}, move_scale=2.0)
    np.testing.assert_allclose(c4.position[2], c3.position[2] + 6.0)


# ---------------------------------------------------------------------------
# Fly camera and turntable against the JAX CLI
# ---------------------------------------------------------------------------

def test_apply_camera_input_matches_jax():
    rng = np.random.default_rng(11)
    for _ in range(20):
        pos = tuple(rng.uniform(-100, 100, 3))
        d = rng.normal(size=3)
        d = tuple(d / np.linalg.norm(d))
        lens = float(rng.uniform(0, 0.5))
        deltas = {"move": list(rng.normal(size=3)),
                  "rot": list(rng.normal(scale=0.8, size=2))}
        scale = float(rng.uniform(0.5, 40))
        got = cli._apply_camera_input(
            Camera(position=pos, direction=d, lens_radius=lens), deltas,
            scale)
        want = jcli._apply_camera_input(
            JCamera(position=pos, direction=d, lens_radius=lens), deltas,
            scale)
        np.testing.assert_allclose(got.position, want.position, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got.direction, want.direction, rtol=0,
                                   atol=1e-12)
        assert got.lens_radius == want.lens_radius


def _jax_turntable_cameras(monkeypatch, tmp_path, frames):
    """The cameras the JAX CLI's turntable renders, frame by frame: its
    render loop runs with the wave replaced by a constant one."""
    cams = []
    real_arrays = jpt.camera_arrays_for

    def arrays_for(cam, *a, **k):
        cams.append(cam)
        return real_arrays(cam, *a, **k)

    def wave(key, scene, arrays, cam_brick, cfg, w, h):
        return (jnp.zeros((w * h, 3)), jnp.ones((w * h,)),
                {"traced_rays": jnp.int32(w * h),
                 "exhausted_rays": jnp.int32(0)})

    monkeypatch.setattr(jpt, "camera_arrays_for", arrays_for)
    monkeypatch.setattr(jpt, "render_wave", wave)
    monkeypatch.setenv("BRICKMAP_CACHE_DIR", "0")   # no XLA cache in HOME
    assert jcli.main(["render", "--engine", "xla", "--out",
                      str(tmp_path / "j.png"), "--width", "8", "--height",
                      "6", "--spp", "1", "--turntable", str(frames),
                      *SMALL_WORLD]) == 0
    return cams


def test_turntable_cameras_match_jax(monkeypatch, tmp_path, capsys):
    frames = 5
    want = _jax_turntable_cameras(monkeypatch, tmp_path, frames)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == frames and len(want) == frames
    args = argparse.Namespace(
        camera=[20.0, 20.0, 100.0], look=[64.0, 64.0, 40.0], angles=None,
        turntable=frames, focal_distance=1.0, lens_radius=0.0)
    for f in range(frames):
        got = cli._turntable_camera(args, f)
        np.testing.assert_allclose(got.position, want[f].position, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got.direction, want[f].direction, rtol=0,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# render's viewer flags, profiling, the NaN trap
# ---------------------------------------------------------------------------

def test_cli_render_viewer_flags(tmp_path, capsys):
    out, prof = tmp_path / "r.png", tmp_path / "prof"
    assert cli.main(["render", "--device", "cpu", "--out", str(out),
                     "--width", "16", "--height", "12", "--spp", "1",
                     "--bounces", "1", "--turntable", "3", "--serve", "0",
                     "--preview-every", "1", "--profile", str(prof),
                     *SMALL_WORLD]) == 0
    cap = capsys.readouterr()
    rec = json.loads(cap.out.strip().splitlines()[-1])
    assert rec["frames"] == 3 and rec["waves"] == 3 and rec["spp"] == 1
    assert rec["device"] == "cpu"
    assert "live preview: http://127.0.0.1:" in cap.err
    pngs = sorted(p.name for p in tmp_path.glob("r_*.png"))
    assert pngs == ["r_000.png", "r_001.png", "r_002.png"]
    for p in pngs:
        assert (tmp_path / p).read_bytes().startswith(b"\x89PNG")
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_profiling_trace_and_annotate(tmp_path):
    with trace(None) as prof:
        assert prof is None
    assert not list(tmp_path.iterdir())
    with trace(str(tmp_path / "p"), "cpu") as prof:
        with annotate("bm_region"):
            torch.ones(4).add_(1.0)
    assert any(e.name == "bm_region" for e in prof.events())
    assert len(list((tmp_path / "p").glob("*.pt.trace.json"))) == 1


def test_debug_nans_matches_jax():
    x = np.array([-1.0, 2.0], np.float32)
    with jdebug.debug_nans():
        with pytest.raises(FloatingPointError):
            jax.jit(jnp.log)(jnp.asarray(x)).block_until_ready()
    assert np.isnan(np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))).any()
    t = torch.from_numpy(x)
    with debug_nans():
        with pytest.raises(FloatingPointError):
            torch.log(t)
        torch.log(t.abs())         # no NaN: no raise
    assert torch.isnan(torch.log(t)).any()     # the trap is gone
    with debug_nans(enable=False):
        torch.log(t)


# ---------------------------------------------------------------------------
# Rendering by pixel index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cold_world():
    """The tests/test_torch_render.py terrain with every brick unloaded, so
    that waves request bricks."""
    sc = jscene.generate_terrain_scene(JCFG.grid, residency="streaming",
                                       feature_scale=64.0)
    jsc = jscene.VoxelScene(index_volume=jnp.asarray(sc.index_volume),
                            pool_words=jnp.asarray(sc.pool_words),
                            pool_base=jnp.asarray(sc.pool_base))
    tsc = tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                  sc.pool_base, device="cpu")
    d = np.array([1.0, 1.0, -0.45])
    kw = dict(position=(20.0, 20.0, 100.0),
              direction=tuple(d / np.linalg.norm(d)))
    jcam = JCamera(**kw)
    jarr = jpt.camera_arrays_for(
        jcam, jss.sun_direction_from_position(jnp.asarray([0.05, 0.1])), W, H)
    tarr = camera_arrays_for(
        Camera(**kw), tss.sun_direction_from_position((0.05, 0.1), "cpu"),
        W, H, "cpu")
    return jsc, tsc, jcam, jarr, tarr


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_wave_for_indices_matches_jax(cold_world):
    jsc, tsc, jcam, jarr, tarr = cold_world
    rng = np.random.default_rng(5)
    idx = rng.integers(0, W * H, 700).astype(np.int32)
    key = jax.random.PRNGKey(21)
    rgb_j, cnt_j, req_j = jpt.wave_for_indices(
        key, jnp.asarray(idx), jsc, jarr,
        jnp.asarray(jcam.brick_position, jnp.int32), JCFG, W, H)
    u = jax_wave_uniforms(key, idx.size, TCFG.render.max_bounces)
    rgb_t, cnt_t, req_t = tpt.wave_for_indices(
        tsc, torch.from_numpy(idx).long(), tarr, jcam.brick_position, TCFG,
        W, H, uniforms=u)
    _close(rgb_t, rgb_j)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(req_t["mask"].numpy(),
                                  np.asarray(req_j["mask"]))
    np.testing.assert_array_equal(req_t["pos"].numpy(),
                                  np.asarray(req_j["pos"]))
    assert int(req_t["traced_rays"]) == int(req_j["traced_rays"]) > 700
    assert int(req_t["exhausted_rays"]) == int(req_j["exhausted_rays"]) == 0
    assert bool(req_t["mask"].any())


def test_render_frame_matches_jax(cold_world):
    """Chunks of 500 over 1,536 pixels: the last chunk wraps back over 464
    pixels of the one before."""
    jsc, tsc, jcam, jarr, tarr = cold_world
    key, chunk = jax.random.PRNGKey(8), 500
    rgb_j, cnt_j, traced_j, reqs_j, exh_j = jpt.render_frame(
        key, jsc, jarr, jnp.asarray(jcam.brick_position, jnp.int32), JCFG,
        W, H, rays_per_chunk=chunk)
    us = [jax_wave_uniforms(jax.random.fold_in(key, c), chunk,
                            TCFG.render.max_bounces) for c in range(4)]
    rgb_t, cnt_t, traced_t, reqs_t, exh_t = tpt.render_frame(
        tsc, tarr, jcam.brick_position, TCFG, W, H, rays_per_chunk=chunk,
        chunk_uniforms=us, queue_size=1024)
    assert rgb_t.shape == (W * H, 3)
    _close(rgb_t, rgb_j)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert traced_t == traced_j and exh_t == exh_j == 0
    assert reqs_t == [tuple(r) for r in reqs_j] and len(reqs_t) > 0


def test_render_wave_is_wave_for_indices_on_the_tile_order(cold_world):
    _, tsc, jcam, _, tarr = cold_world
    gen = torch.Generator().manual_seed(3)
    u = tpt.draw_wave_uniforms(W * H, TCFG.render.max_bounces, gen, "cpu")
    perm, inv = tpt._tile_permutation(W, H)
    rgb, cnt, req = tpt.render_wave(tsc, tarr, jcam.brick_position, TCFG, W,
                                    H, uniforms=u)
    rgb_i, cnt_i, req_i = tpt.wave_for_indices(
        tsc, torch.from_numpy(perm.copy()), tarr, jcam.brick_position, TCFG,
        W, H, uniforms=u)
    inv = torch.from_numpy(inv.copy())
    assert torch.equal(rgb, rgb_i[inv]) and torch.equal(cnt, cnt_i[inv])
    assert torch.equal(req["mask"], req_i["mask"][inv])
    assert torch.equal(req["pos"], req_i["pos"][inv])


# ---------------------------------------------------------------------------
# The dense compositor's benchmark stage
# ---------------------------------------------------------------------------

def test_dense_inverse_benchmark_loss_matches_jax():
    """bench.py::_bwd_bench's inputs at 24 x 16 rays, through JAX's
    l2_loss_and_grads, against the port's stage."""
    from brickmap_tpu.diff.render import l2_loss_and_grads

    out = benchmark.run_dense_inverse_benchmark("cpu", 24, 16)
    rng = np.random.default_rng(0)
    occ = rng.uniform(0, 1, (64, 64, 64)).astype(np.float32)
    alb = rng.uniform(0, 1, (64, 64, 64, 3)).astype(np.float32)
    n = 24 * 16
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([32, 32, 32]) - dirs * 96).astype(np.float32)
    loss, _ = l2_loss_and_grads(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ),
        jnp.asarray(alb), jnp.zeros((n, 3)), jnp.full((n, 3), 0.5),
        max_steps=192)
    np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)
    assert out["rays"] == n and out["device"] == "cpu"
    assert out["mrays_per_s"] > 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_viewer_loop(tmp_path, capsys):
    """The viewer loop on the card: every wave launches kernel B2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brickmap_tpu_torch.kernels import traverse as ktrav

    before = ktrav.trace.launches
    assert cli.main(["render", "--out", str(tmp_path / "r.png"), "--width",
                     "64", "--height", "48", "--spp", "2", "--turntable",
                     "2", "--serve", "0", "--preview-every", "1",
                     *SMALL_WORLD]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 2 and rec["waves"] == 4
    assert rec["device"] == "cuda"
    assert ktrav.trace.launches - before >= 4
