"""Kernel B2's plain version (brickmap_tpu_torch.ops.traverse) against the
JAX package's traversals and the scalar oracle.

The cases are those of tests/test_traverse.py:134-300 (XLA ``trace_rays``
and ``dda_ref.intersect_voxel``) and tests/test_traverse3.py:22-45 (the Pallas
kernel ``trace_rays_paged`` in interpret mode, 48-ray batches).  ``hit``,
``request`` and ``request_pos`` must be equal; ``t`` within 2e-2 (the JAX
suites' tolerance), normals within 1e-5.  The ``cuda`` test holds the CUDA
kernel against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.config import GridConfig as JGrid
from brickmap_tpu.ops import dda_ref
from brickmap_tpu.ops.traverse import aabb_clip as jax_clip, \
    trace_rays as jax_trace
from brickmap_tpu.pallas.paged import build_paged_scene
from brickmap_tpu.pallas.traverse3 import trace_rays_paged
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.kernels import traverse as ktrav
from brickmap_tpu_torch.ops.traverse import aabb_clip, trace_rays

torch.set_num_threads(2)

JG1, TG1 = JGrid(grid_size=128, grid_height=128), \
    GridConfig(grid_size=128, grid_height=128)
JG4, TG4 = JGrid(grid_size=256, grid_height=128), \
    GridConfig(grid_size=256, grid_height=128)
CAM = np.array([0, 0, 0], np.int64)


def both(dense, jg, residency="full"):
    sc = jscene.scene_from_dense(dense, jg, residency=residency)
    return sc, tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                       sc.pool_base, device="cpu")


def box_dense():
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    return dense


@pytest.fixture(scope="module")
def box_scene():
    return both(box_dense(), JG1)


@pytest.fixture(scope="module")
def noise_scene():
    return both(np.random.default_rng(104).random((128, 128, 128)) < 0.015,
                JG1)


@pytest.fixture(scope="module")
def multipage_scene():
    dense = np.zeros((128, 256, 256), bool)
    dense[16:48, 16:80, 16:80] = True
    dense[40:90, 180:240, 150:250] = True
    return both(dense, JG4)


def random_rays(rng, n, lo, hi):
    origins = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    directions = rng.normal(size=(n, 3)).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    return origins, directions


def port_trace(tsc, origins, directions, cam=CAM, grid=TG1, **kw):
    kw.setdefault("max_iters", 4096)
    return trace_rays(torch.from_numpy(origins), torch.from_numpy(directions),
                      tsc.index_volume, tsc.pool_words, tsc.pool_base,
                      tuple(int(c) for c in cam), grid, **kw)


def jax_xla(sc, origins, directions, cam=CAM, grid=JG1, **kw):
    return jax_trace(jnp.asarray(origins), jnp.asarray(directions),
                     jnp.asarray(sc.index_volume), jnp.asarray(sc.pool_words),
                     jnp.asarray(sc.pool_base), jnp.asarray(cam, jnp.int32),
                     grid, **kw)


def assert_same(port, ref, atol=2e-2):
    """Port result against a JAX result (XLA or Pallas)."""
    hit = port["hit"].numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref["hit"]))
    np.testing.assert_array_equal(port["request"].numpy(),
                                  np.asarray(ref["request"]))
    req = port["request"].numpy()
    np.testing.assert_array_equal(port["request_pos"].numpy()[req],
                                  np.asarray(ref["request_pos"])[req])
    np.testing.assert_allclose(port["t"].numpy()[hit],
                               np.asarray(ref["t"])[hit], atol=atol)
    np.testing.assert_allclose(port["normal"].numpy()[hit],
                               np.asarray(ref["normal"])[hit], atol=1e-5)
    assert not port["exhausted"].any()


def assert_oracle(port, sc, origins, directions, cam=CAM, grid=JG1,
                  atol=2e-2):
    hit, t, nrm = (port[k].numpy() for k in ("hit", "t", "normal"))
    for i, (o, d) in enumerate(zip(origins, directions)):
        r = dda_ref.intersect_voxel(o, d, sc, grid, cam)
        assert bool(hit[i]) == r.hit, f"ray {i}: o={o} d={d}"
        if r.hit:
            assert abs(float(t[i]) - r.distance) < atol, i
            np.testing.assert_allclose(nrm[i], r.normal, atol=1e-5,
                                       err_msg=f"ray {i}")
        req = bool(port["request"][i])
        assert req == (r.request is not None), i
        if req:
            assert tuple(port["request_pos"][i].tolist()) == r.request


# ---------------------------------------------------------------------------
# Against brickmap_tpu.ops.traverse.trace_rays and dda_ref
# ---------------------------------------------------------------------------

def test_box_matches_jax(box_scene, rng):
    sc, tsc = box_scene
    o, d = random_rays(rng, 48, [-20] * 3, [148] * 3)
    port = port_trace(tsc, o, d)
    assert_same(port, jax_xla(sc, o, d))
    assert_oracle(port, sc, o, d)


def test_noise_matches_jax(noise_scene, rng):
    sc, tsc = noise_scene
    o, d = random_rays(rng, 48, [0] * 3, [128] * 3)
    port = port_trace(tsc, o, d)
    assert_same(port, jax_xla(sc, o, d))
    assert_oracle(port, sc, o, d)


AXIS_ORIGINS = np.array([
    [0.5, 64.0, 30.0], [127.5, 64.0, 30.0], [64.0, 0.5, 30.0],
    [64.0, 64.0, 100.0], [0.5, 64.0, 100.0], [64.0, 64.0, 0.5],
    [-10.0, 64.0, 30.0], [64.0, 64.0, 30.0],
], np.float32)
AXIS_DIRS = np.array([
    [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1],
    [1, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 0],
], np.float32)


def test_axis_aligned_and_degenerate(box_scene):
    sc, tsc = box_scene
    port = port_trace(tsc, AXIS_ORIGINS, AXIS_DIRS)
    assert_same(port, jax_xla(sc, AXIS_ORIGINS, AXIS_DIRS))
    assert_oracle(port, sc, AXIS_ORIGINS, AXIS_DIRS)
    # Analytic goldens of test_traverse.py:64-105.
    t = port["t"].numpy()
    assert abs(t[0] - 31.5) < 1e-3 and abs(t[6] - 42.0) < 1e-2
    assert abs(t[3] - 52.0) < 1e-3 and t[7] == 0.0
    np.testing.assert_allclose(port["normal"][3].numpy(), [0, 0, 1])


@pytest.mark.parametrize("cam", [[0, 0, 0], [400, 0, 0], [900, 0, 0]])
def test_lod_distances(box_scene, noise_scene, cam, rng):
    cam = np.asarray(cam, np.int64)
    for sc, tsc in (box_scene, noise_scene):
        o, d = random_rays(rng, 32, [0] * 3, [128] * 3)
        port = port_trace(tsc, o, d, cam=cam)
        assert_same(port, jax_xla(sc, o, d, cam=cam))
        assert_oracle(port, sc, o, d, cam=cam)


def test_requests_streaming():
    sc, tsc = both(box_dense(), JG1, residency="streaming")
    o = np.array([[0.5, 64.0, 30.0], [64.0, 64.0, 100.0]], np.float32)
    d = np.array([[1, 0, 0], [0, 0, -1]], np.float32)
    port = port_trace(tsc, o, d)
    assert port["request"].all()
    assert tuple(port["request_pos"][0].tolist()) == (4, 8, 3)
    assert_same(port, jax_xla(sc, o, d))
    assert_oracle(port, sc, o, d)


def test_ess_matches_no_ess(noise_scene, box_scene, rng):
    for _, tsc in (noise_scene, box_scene):
        o, d = random_rays(rng, 128, [-10] * 3, [138] * 3)
        a = port_trace(tsc, o, d, use_ess=True)
        b = port_trace(tsc, o, d, use_ess=False)
        assert torch.equal(a["hit"], b["hit"])
        torch.testing.assert_close(a["t"], b["t"], atol=1e-3, rtol=0)
        torch.testing.assert_close(a["normal"], b["normal"], atol=1e-5,
                                   rtol=0)
        assert int(a["iters"]) <= int(b["iters"])
    # The box world is mostly empty: skipping reads fewer index words.
    assert int(a["ray_words"].sum()) < int(b["ray_words"].sum())


def test_distinct_reads(noise_scene, rng):
    """``cells_read``/``rows_read`` are the union over rays of what each ray
    reads, and a ray never reads a cell or a brick row twice."""
    _, tsc = noise_scene
    o, d = random_rays(rng, 24, [-10] * 3, [138] * 3)
    batch = port_trace(tsc, o, d)
    cells = torch.zeros_like(batch["cells_read"])
    rows = torch.zeros_like(batch["rows_read"])
    for i in range(len(o)):
        one = port_trace(tsc, o[i:i + 1], d[i:i + 1])
        assert int(one["cells_read"].sum()) == int(one["ray_words"][0]), i
        assert int(one["rows_read"].sum()) == int(one["ray_bricks"][0]), i
        cells |= one["cells_read"]
        rows |= one["rows_read"]
    assert torch.equal(cells, batch["cells_read"])
    assert torch.equal(rows, batch["rows_read"])
    assert int(rows.sum()) > 0


def test_aabb_clip_on_slab_planes():
    origins = np.array([
        [0.0, 64.0, 30.0], [128.0, 64.0, 30.0], [64.0, 0.0, 30.0],
        [64.0, 64.0, 128.0], [0.0, 0.0, 30.0],
    ], np.float32)
    directions = np.array([
        [0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0],
        [1.0, 0.0, 0.0], [0.0, 0.0, -1.0],
    ], np.float32)
    hit, tminn, clipped, nrm = aabb_clip(torch.from_numpy(origins),
                                         torch.from_numpy(directions), TG1)
    jhit, jtmin, jclip, jnrm = jax_clip(jnp.asarray(origins),
                                        jnp.asarray(directions), JG1)
    assert not torch.isnan(tminn).any()
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tminn.numpy(), np.asarray(jtmin))
    np.testing.assert_array_equal(clipped.numpy(), np.asarray(jclip))
    np.testing.assert_array_equal(nrm.numpy(), np.asarray(jnrm))
    for i in range(len(origins)):
        ok, tmin = dda_ref.intersect_aabb(origins[i], directions[i],
                                          JG1.world_max)
        assert bool(hit[i]) == ok, i
        if ok:
            assert abs(float(tminn[i]) - tmin) <= 1e-5


# ---------------------------------------------------------------------------
# Against the Pallas kernel (interpret mode) and the budget contract
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paged_box(box_scene):
    return build_paged_scene(box_scene[0], JG1)


@pytest.fixture(scope="module")
def paged_multipage(multipage_scene):
    return build_paged_scene(multipage_scene[0], JG4)


def test_matches_paged_kernel_box(box_scene, paged_box, rng):
    sc, tsc = box_scene
    o, d = random_rays(rng, 48, [-20] * 3, [148] * 3)
    ref = trace_rays_paged(jnp.asarray(o), jnp.asarray(d), paged_box,
                           jnp.asarray(CAM, jnp.int32), JG1, interpret=True)
    assert not np.asarray(ref["exhausted"]).any()
    assert_same(port_trace(tsc, o, d), ref)


def test_matches_paged_kernel_multipage(multipage_scene, paged_multipage,
                                        rng):
    sc, tsc = multipage_scene
    o, d = random_rays(rng, 48, [-20, -20, -20], [276, 276, 148])
    ref = trace_rays_paged(jnp.asarray(o), jnp.asarray(d), paged_multipage,
                           jnp.asarray(CAM, jnp.int32), JG4, interpret=True)
    assert not np.asarray(ref["exhausted"]).any()
    assert_same(port_trace(tsc, o, d, grid=TG4), ref)


def test_budget_exhaustion_and_resume(noise_scene, rng):
    """A tiny budget sets ``exhausted``; re-tracing from ``resume_t - 2``
    gives the unbudgeted result (the wave's rescue contract)."""
    _, tsc = noise_scene
    o, d = random_rays(rng, 96, [-10] * 3, [138] * 3)
    full = port_trace(tsc, o, d)
    short = port_trace(tsc, o, d, max_iters=6)
    exh = short["exhausted"]
    assert exh.any() and not full["exhausted"].any()
    assert not short["hit"][exh].any() and (short["t"][exh] == 0).all()
    assert (short["resume_t"][~exh] == 0).all()
    assert (short["ray_iters"][exh] == 6).all()
    same = ~exh
    assert torch.equal(short["hit"][same], full["hit"][same])
    off = torch.clamp(short["resume_t"][exh] - 2.0, min=0.0)
    ot, dt = torch.from_numpy(o)[exh], torch.from_numpy(d)[exh]
    again = trace_rays(ot + dt * off[:, None], dt, tsc.index_volume,
                       tsc.pool_words, tsc.pool_base, (0, 0, 0), TG1)
    assert torch.equal(again["hit"], full["hit"][exh])
    h = again["hit"]
    torch.testing.assert_close(again["t"][h] + off[h], full["t"][exh][h],
                               atol=2e-2, rtol=0)
    torch.testing.assert_close(again["normal"][h], full["normal"][exh][h],
                               atol=1e-5, rtol=0)


def test_trace_wrapper_on_cpu_is_plain_version(noise_scene, rng):
    _, tsc = noise_scene
    o, d = random_rays(rng, 64, [-10] * 3, [138] * 3)
    before = ktrav.trace.launches
    res = ktrav.trace(torch.from_numpy(o), torch.from_numpy(d), tsc,
                      (0, 0, 0), TG1, 4096)
    assert ktrav.trace.launches == before   # no kernel on the CPU
    ref = port_trace(tsc, o, d)
    for k in ("hit", "t", "normal", "request", "request_pos", "exhausted",
              "resume_t", "iters"):
        assert torch.equal(res[k], ref[k]), k
    assert "ray_words" not in res
    with pytest.raises(ValueError):
        ktrav.trace(torch.zeros((4, 3), device="meta"),
                    torch.zeros((4, 3), device="meta"), tsc, (0, 0, 0), TG1,
                    16)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_trace_matches_plain(cuda_device, noise_scene, rng):
    _, tsc = noise_scene
    gsc = tsc.to(cuda_device)
    o, d = random_rays(rng, 1 << 14, [-20] * 3, [148] * 3)
    o, d = torch.from_numpy(o).to(cuda_device), \
        torch.from_numpy(d).to(cuda_device)
    for cam, steps in (((0, 0, 0), 4096), ((400, 0, 0), 4096),
                       ((0, 0, 0), 7)):
        before = ktrav.trace.launches
        got = ktrav.trace(o, d, gsc, cam, TG1, steps)
        assert ktrav.trace.launches == before + 1
        want = trace_rays(o, d, gsc.index_volume, gsc.pool_words,
                          gsc.pool_base, cam, TG1, max_iters=steps)
        for k in ("hit", "normal", "request", "request_pos", "exhausted",
                  "ray_iters"):
            assert torch.equal(got[k], want[k]), k
        assert float((got["t"] - want["t"]).abs().max()) <= 2e-2
        assert float((got["resume_t"] - want["resume_t"]).abs().max()) <= 2e-2
