"""The live viewer's frame (``app/live.py``), its presentation (W5,
``render/pathtrace.py::present``) and the preview server's encode on
demand, on the CPU at a tiny size:

* the plain presentation against the JAX package's
  ``to_uint8(tonemap(...))``;
* ``LiveSession.frame`` on a tiny streaming world against the sequence
  ``render``'s viewer loop ran before it: film, 8-bit frame and
  ``state()`` bit-equal after every frame, a fly-camera input among them;
* the benchmark tour's inputs (``h100bench/loops/live.py``) through the
  program's fly-camera step against the benchmark's plain reference;
* ``PreviewServer`` encoding only what a client fetches, once a frame;
* W5 built with g++ through ``csrc/host_shim.h`` against its plain version;
  the ``cuda`` case holds it bit-equal on the card at 960 x 540 and
  1920 x 1080.
"""

import ctypes
import shutil
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu.render import pathtrace as jpt
from brickmap_tpu.utils import image as jimage
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.app.live import _apply_camera_input
from brickmap_tpu_torch.app.live import LiveSession
from brickmap_tpu_torch.config import BrickmapConfig, GridConfig, \
    RenderConfig
from brickmap_tpu_torch.kernels import wave as kwave
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.ops.wave import blit_plain
from brickmap_tpu_torch.render import pathtrace as tpt
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for
from brickmap_tpu_torch.stream import StreamingScene, pull_requests
from brickmap_tpu_torch.utils.image import encode_png, to_uint8
from brickmap_tpu_torch.utils.preview import PreviewServer
from _host_build import host_build

torch.set_num_threads(2)

W, H = 40, 24
CFG = BrickmapConfig(grid=GridConfig(grid_size=128, grid_height=128),
                     render=RenderConfig(width=W, height=H, max_bounces=1,
                                         max_top_steps=64))


def film(rng, n):
    """A film's sums and counts as waves leave them: radiance sums over
    0-64 samples (some pixels unsampled), a few negative or huge sums, and
    values on the levels' rounding edges."""
    count = rng.integers(0, 65, n).astype(np.float32)
    rgb = (rng.exponential(0.3, (n, 3)) * np.maximum(count, 1)[:, None])
    rgb[rng.random((n, 3)) < 0.02] *= -1.0
    rgb[rng.random((n, 3)) < 0.01] *= 1e4
    edge = ((np.arange(n) % 256 + 0.5) / 255.0) ** 2.2
    rgb[::7, 0] = edge[::7] * np.maximum(count[::7], 1)
    return (torch.from_numpy(rgb.astype(np.float32)),
            torch.from_numpy(count))


# ---------------------------------------------------------------------------
# The presentation
# ---------------------------------------------------------------------------

def test_plain_present_matches_jax(rng):
    """At most one level apart on any value: XLA's pow and torch's CPU pow
    (SLEEF) may differ in the last ulp, which can carry a value across a
    level's rounding edge.  Against the port's own float path (its
    ``tonemap`` quantised by ``to_uint8`` on the host) bit for bit."""
    rgb, count = film(rng, W * H)
    got = tpt.present({"rgb": rgb, "count": count}, W, H)
    assert got.dtype == torch.uint8 and got.shape == (H, W, 3)
    want = jimage.to_uint8(np.asarray(jpt.tonemap(
        {"rgb": jnp.asarray(rgb.numpy()), "count": jnp.asarray(
            count.numpy())}, W, H)))
    gap = np.abs(got.numpy().astype(int) - want.astype(int))
    assert gap.max() <= 1
    assert (gap == 0).mean() > 0.99
    own = to_uint8(tpt.tonemap({"rgb": rgb, "count": count}, W,
                               H).numpy())
    np.testing.assert_array_equal(got.numpy(), own)
    assert torch.equal(got, blit_plain(rgb, count, W, H))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    so = ctypes.CDLL(host_build(
        "wave", str(tmp_path_factory.mktemp("blit_host"))))
    kwave._bind(so)
    return so


@pytest.mark.parametrize("w, h", [(W, H), (37, 11)])
def test_w5_host_build_matches_plain(host_lib, rng, w, h):
    """W5 built with g++: within one level of the plain version, because
    the host build calls glibc's ``powf`` and torch's CPU kernel SLEEF's
    (both within an ulp; on the card both call libdevice's), and equal on
    nearly every value.  A pixel count that is no multiple of a block's
    threads leaves a partial block."""
    rgb, count = film(rng, w * h)
    out = torch.empty((h, w, 3), dtype=torch.uint8)
    assert host_lib.wave_blit_launch(w * h, rgb.data_ptr(),
                                     count.data_ptr(), out.data_ptr(),
                                     None) == 0
    gap = (out.int() - blit_plain(rgb, count, w, h).int()).abs()
    assert int(gap.max()) <= 1
    assert float((gap == 0).float().mean()) > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("w, h", [(960, 540), (1920, 1080)])
def test_cuda_w5_equals_plain(w, h):
    """On the card W5 equals the plain version run on the same CUDA
    tensors, bit for bit (both call libdevice's powf, and the kernel
    rounds each step as torch's op), in one launch; ptxas reports no
    spill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from brickmap_tpu_torch.kernels import build

    rgb, count = film(np.random.default_rng(w), w * h)
    rgb, count = rgb.cuda(), count.cuda()
    before = kwave.blit.launches
    got = tpt.present({"rgb": rgb, "count": count}, w, h)
    assert kwave.blit.launches == before + 1
    assert got.device.type == "cuda" and got.shape == (h, w, 3)
    assert torch.equal(got, blit_plain(rgb, count, w, h))
    if "wave" not in build.ptxas_summary:
        build.build(("wave",), force=True)
    spills = [s for s in build.ptxas_summary["wave"] if "spill" in s]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in s
                          for s in spills), spills


# ---------------------------------------------------------------------------
# The live frame against the viewer loop's sequence before it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def truth():
    return tscene.generate_terrain_scene(CFG.grid, feature_scale=64.0,
                                         use_native=False, device="cpu")


MOVE = {"move": [0.8, -0.3, 0.2], "rot": [0.15, -0.05]}


def test_live_frame_equals_the_viewer_loop(truth):
    """Two waves, a fly-camera input, two more: the film, the 8-bit frame
    and the residency after each equal what ``render --streaming``'s loop
    computed (wave, film_add, read, pull, service; ``to_uint8(tonemap)``
    on the host; the input's new camera, arrays and film)."""
    sun = tss.sun_direction_from_position((0.05, 0.1), "cpu")
    d = np.array([1.0, 1.0, -0.45])
    cam0 = Camera(position=(20.0, 20.0, 100.0),
                  direction=tuple(d / np.linalg.norm(d)))
    scale = max(CFG.grid.grid_size / 128.0, 1.0)    # the session's

    mgr = StreamingScene(truth, CFG.grid, queue_size=64,
                         starting_capacity=4, device="cpu")
    gen = torch.Generator().manual_seed(7)
    cam, arrays = cam0, camera_arrays_for(cam0, sun, W, H, "cpu")
    film_ = tpt.film_init(W, H, "cpu")
    want = []
    for i in range(4):
        if i == 2:
            cam = _apply_camera_input(cam, MOVE, scale)
            film_ = tpt.film_init(W, H, "cpu")
            arrays = camera_arrays_for(cam, sun, W, H, "cpu")
        rgb, count, req = tpt.render_wave(mgr.device_scene(), arrays,
                                          cam.brick_position, CFG, W, H,
                                          generator=gen)
        film_ = tpt.film_add(film_, rgb, count)
        traced = int(req["traced_rays"])
        got = pull_requests(req, mgr.queue_size)
        uploads = mgr.process_requests(got) if got else 0
        img = to_uint8(tpt.tonemap(film_, W, H).cpu().numpy())
        want.append((film_, img, mgr.state(), traced, uploads))

    mgr2 = StreamingScene(truth, CFG.grid, queue_size=64,
                          starting_capacity=4, device="cpu")
    srv = PreviewServer(0)
    try:
        live = LiveSession(mgr2, sun, W, H, CFG,
                           torch.Generator().manual_seed(7), cam0,
                           server=srv)
        assert live.move_scale == scale
        uploaded = 0
        for i, (f, img, state, traced, uploads) in enumerate(want):
            out = live.frame(MOVE if i == 2 else None, frame=0, wave=i)
            assert torch.equal(live.film["rgb"], f["rgb"])
            assert torch.equal(live.film["count"], f["count"])
            np.testing.assert_array_equal(out.image, img)
            assert srv._img is out.image
            got = live.manager.state()
            assert set(got) == set(state)
            for k in state:
                np.testing.assert_array_equal(got[k], state[k], err_msg=k)
            assert (out.traced, out.uploads) == (traced, uploads)
            assert out.exhausted == 0 and len(out.pulled) >= out.uploads
            assert set(out.seconds) == {"input", "wave", "read", "pull",
                                        "service", "present"}
            uploaded += uploads
        assert uploaded > 0 and live.camera == cam
        assert srv._stats["frame_seq"] == 4 and srv._stats["wave"] == 3
    finally:
        srv.close()


def test_live_frame_spans_nest(truth):
    """``bm.live.frame`` holds the input, the wave, the streaming spans
    and the presentation; no input, no input span."""
    from torch.profiler import profile

    sun = tss.sun_direction_from_position((0.05, 0.1), "cpu")
    mgr = StreamingScene(truth, CFG.grid, queue_size=64,
                         starting_capacity=4, device="cpu")
    cam = Camera(position=(20.0, 20.0, 100.0), direction=(0.6, 0.6, -0.52))
    live = LiveSession(mgr, sun, W, H, CFG, torch.Generator().manual_seed(1),
                       cam)
    with profile() as prof:
        live.frame(MOVE)
        live.frame(None, present=False)
    frames = [e for e in prof.events() if e.name == "bm.live.frame"]
    assert len(frames) == 2
    inside = {e.name for e in prof.events() if e.name.startswith("bm.")
              and frames[0].time_range.start <= e.time_range.start
              < frames[0].time_range.end}
    assert {"bm.live.input", "bm.wave", "bm.stream.pull", "bm.stream.plan",
            "bm.live.present"} <= inside
    names = [e.name for e in prof.events()]
    assert names.count("bm.live.input") == 1
    assert names.count("bm.live.present") == 1


def test_rebased_rows_count_what_the_rebases_moved(truth):
    """``total_rebased_rows`` adds the rows resident before each re-base,
    is cleared by a reset and is no part of ``state()``."""
    mgr = StreamingScene(truth, CFG.grid, queue_size=512,
                         starting_capacity=1, device="cpu")
    iv = truth.index_volume.numpy().view(np.uint32)
    z, y, x = np.nonzero(iv & np.uint32(0xE000_0000))
    reqs = list(zip(x.tolist(), y.tolist(), z.tolist()))
    moved = 0
    for part in (reqs[:40], reqs[40:200], reqs[200:600]):
        kept = int(mgr.highest.sum())
        rebases = mgr.total_rebases
        mgr.process_requests(part)
        moved += kept * (mgr.total_rebases - rebases)
    assert mgr.total_rebases > 1 and moved > 0
    assert mgr.total_rebased_rows == moved
    assert "total_rebased_rows" not in mgr.state()
    mgr.reset()
    assert mgr.total_rebased_rows == 0


# ---------------------------------------------------------------------------
# The benchmark tour's inputs
# ---------------------------------------------------------------------------

def test_tour_inputs_fly_the_program_as_the_reference():
    """Every frame of the tour: the program's step reaches the pose the
    reference's reaches, float for float, and each leg ends at its view
    (position within 1e-6 voxel, direction within 1e-12)."""
    from h100bench import harness
    from h100bench.loops import live as llive
    from h100bench.reference import camera as rcamera, live as rlive

    cell = harness.cell_spec("view.preview_540p")
    loop = llive.Loop(cell["config_data"], cell["traffic_data"], 2**31 + 5,
                      torch.device("cpu"))
    inputs = llive.tour_inputs(loop.poses, loop.per_leg, loop.move_scale)
    assert len(inputs) == loop.cycle == 720
    cam = Camera.from_angles(*loop.poses[0])
    ref = rcamera.Camera.from_angles(*loop.poses[0])
    for k, deltas in enumerate(inputs):
        before = np.asarray(cam.position)
        cam = _apply_camera_input(cam, deltas, loop.move_scale)
        ref = rlive.fly(ref, deltas, loop.move_scale)
        assert rlive.pose_differ(cam, ref) == 0, k
        assert 4.0 < np.linalg.norm(np.asarray(cam.position) - before) < 7.5
        if (k + 1) % loop.per_leg == 0:
            view = Camera.from_angles(*loop.poses[(k + 1) // loop.per_leg])
            np.testing.assert_allclose(cam.position, view.position, rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(cam.direction, view.direction,
                                       rtol=0, atol=1e-12)
    assert ref.position == cam.position
    # The float32 step the calibration's control takes lands elsewhere.
    low = rlive.fly(rcamera.Camera.from_angles(*loop.poses[0]), inputs[0],
                    loop.move_scale, np.float32)
    first = rlive.fly(rcamera.Camera.from_angles(*loop.poses[0]), inputs[0],
                      loop.move_scale)
    assert rlive.pose_differ(low, first) > 0


# ---------------------------------------------------------------------------
# The preview server encodes on demand
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read()


def test_preview_server_encodes_only_what_a_client_fetches(rng):
    srv = PreviewServer(0)
    encoded = []

    def counting(img):
        encoded.append(img)
        return encode_png(img)

    srv._encode = counting
    try:
        frames = [rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)
                  for _ in range(50)]
        for i, f in enumerate(frames):
            srv.update(f, wave=i)
        assert encoded == []
        png = _get(srv.port, "/frame.png")
        assert png == encode_png(frames[-1])
        assert len(encoded) == 1 and encoded[0] is frames[-1]
        assert _get(srv.port, "/frame.png") == png    # kept, not encoded
        assert len(encoded) == 1
        srv.update(frames[0], wave=50)
        assert _get(srv.port, "/frame.png") == encode_png(frames[0])
        assert len(encoded) == 2
    finally:
        srv.close()
