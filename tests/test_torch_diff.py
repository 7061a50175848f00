"""The sparse differentiable renderer of brickmap_tpu_torch
(``diff/sparse.py``) against the JAX package's, same inputs, on the
``sparse_world`` of tests/test_diff_sparse.py.

* The replay on segments injected from the JAX recorder: loss rtol 1e-6,
  gradients atol 1e-6 (same geometry, sums in another order).
* End to end with the port's own recorder: loss rtol 1e-5, gradients atol
  1e-5 (its ``nd`` may differ from the Pallas recorder's in the last ulp,
  which can move a visited voxel on a grazing entry).

The JAX side runs its Pallas kernels in interpret mode.  The ``cuda`` test
runs the training step on the card against the CPU path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.config import GridConfig as JGrid
from brickmap_tpu.diff import sparse as jsparse
from brickmap_tpu.pallas.paged import build_paged_scene
from brickmap_tpu.pallas.record import record_segments as jax_record
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.diff import sparse as tsparse

torch.set_num_threads(2)

JG, TG = JGrid(grid_size=128, grid_height=128), \
    GridConfig(grid_size=128, grid_height=128)
N, K = 700, 6     # rays (not a multiple of the slice size 256), segments


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(102)
    dense = np.zeros((128, 128, 128), bool)
    dense[16:32, 32:64, 32:64] = rng.random((16, 32, 32)) < 0.35
    dense[48:56, 80:96, 40:56] = True
    sc = jscene.scene_from_dense(dense, JG)
    psc = jax.tree.map(jnp.asarray, build_paged_scene(sc, JG))
    tsc = tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                  sc.pool_base, device="cpu")
    occ, alb = jsparse.pool_fields_from_bitmask(sc)
    return sc, psc, tsc, occ, alb


def rays(rng, n):
    """Rays from above aimed at the blobs, a quarter grazing the first."""
    origins = np.array([[64.0, 64.0, 120.0]] * n, np.float32)
    origins += rng.normal(scale=10.0, size=(n, 3)).astype(np.float32)
    centers = np.array([[48.0, 48.0, 24.0], [48.0, 88.0, 52.0]], np.float32)
    d = centers[rng.integers(0, 2, n)] + rng.normal(
        scale=14.0, size=(n, 3)).astype(np.float32) - origins
    g = n // 4
    origins[:g] = rng.uniform([20, 20, 17], [30, 30, 31], (g, 3))
    d[:g] = [1.0, 1.0, 0.0] + rng.normal(scale=0.08, size=(g, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


@pytest.fixture(scope="module")
def problem(world):
    """Fields, rays, the JAX loss/gradients (row and voxel replay), the JAX
    record of the rays and its composite (row replay)."""
    sc, psc, tsc, occ, alb = world
    rng = np.random.default_rng(7)
    occ = occ * 0.7
    alb = rng.uniform(0.1, 1.0, alb.shape).astype(np.float32)
    o, d = rays(rng, N)
    bg = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    tgt = np.full((N, 3), 0.3, np.float32)
    cellmap = jnp.asarray(jsparse.cell_pool_map(sc, JG))
    args = (jnp.asarray(o), jnp.asarray(d), psc, cellmap, jnp.asarray(occ),
            jnp.asarray(alb), jnp.asarray(bg), jnp.asarray(tgt), JG)
    ref = {}
    for row in (True, False):
        loss, (go, ga) = jsparse.l2_loss_and_grads_sparse(
            *args, k_segments=K, interpret=True, host_chunk=256,
            row_replay=row)
        ref[row] = (float(loss), np.asarray(go), np.asarray(ga))
    segs = jax_record(jnp.asarray(o), jnp.asarray(d), psc, JG, k_segments=K,
                      interpret=True)
    rgb, trans = jsparse.composite_sparse(
        segs["o_cells"], jnp.asarray(d), segs, cellmap, jnp.asarray(occ),
        jnp.asarray(alb), jnp.asarray(bg), JG, k_segments=K)
    return dict(o=o, d=d, occ=occ, alb=alb, bg=bg, tgt=tgt, ref=ref,
                cellmap=tsparse.cell_pool_map(tsc, TG), jax_cellmap=cellmap,
                segs=segs, composite=(np.asarray(rgb), np.asarray(trans)))


def jax_recorder(psc):
    """A stand-in for the port's recorder that runs the JAX one."""
    def record(origin, direction, scene, grid, k_segments=16, **kw):
        s = jax_record(jnp.asarray(origin.numpy()),
                       jnp.asarray(direction.numpy()), psc, JG,
                       k_segments=k_segments, interpret=True)
        return {k: t(v) for k, v in s.items()}
    return record


def port_loss(world, p, **kw):
    occ, alb = tscene.fields_from_numpy(p["occ"], p["alb"], device="cpu")
    return tsparse.l2_loss_and_grads_sparse(
        t(p["o"]), t(p["d"]), world[2], p["cellmap"], occ, alb, t(p["bg"]),
        t(p["tgt"]), TG, k_segments=K, host_chunk=256, **kw)


def assert_loss_grads(got, want, rtol, atol):
    loss, (go, ga) = got
    np.testing.assert_allclose(float(loss), want[0], rtol=rtol)
    np.testing.assert_allclose(go.numpy(), want[1], atol=atol, rtol=0)
    np.testing.assert_allclose(ga.numpy(), want[2], atol=atol, rtol=0)


def test_cell_pool_map_and_bitmask_fields(world):
    sc, _, tsc, occ, alb = world
    np.testing.assert_array_equal(tsparse.cell_pool_map(tsc, TG).numpy(),
                                  jsparse.cell_pool_map(sc, JG))
    tocc, talb = tsparse.pool_fields_from_bitmask(tsc)
    np.testing.assert_array_equal(tocc.numpy(), occ)
    np.testing.assert_array_equal(talb.numpy(), alb)


def test_segment_geometry_matches(problem):
    """Slots, visited voxels and step masks of injected JAX segments."""
    segs, d = problem["segs"], jnp.asarray(problem["d"])
    want = jsparse._segment_geom(segs["o_cells"], d, segs["cells"],
                                 segs["nd"], segs["ncode"],
                                 segs["entry_normal"],
                                 problem["jax_cellmap"], JG, K)
    got = tsparse._segment_geom(t(segs["o_cells"]), t(problem["d"]),
                                t(segs["cells"]), t(segs["nd"]),
                                t(segs["ncode"]), t(segs["entry_normal"]),
                                problem["cellmap"], TG, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) > 1000


@pytest.mark.parametrize("row_replay", [True, False])
def test_composite_sparse_injected(problem, row_replay):
    """Both replays of the port (in 256-ray chunks) against the JAX row
    replay of the same segments."""
    tsegs = {k: t(v) for k, v in problem["segs"].items()}
    rgb, trans = tsparse.composite_sparse(
        tsegs["o_cells"], t(problem["d"]), tsegs, problem["cellmap"],
        t(problem["occ"]), t(problem["alb"]), t(problem["bg"]), TG,
        k_segments=K, rays_per_chunk=256, row_replay=row_replay)
    rgb_w, trans_w = problem["composite"]
    np.testing.assert_allclose(rgb.numpy(), rgb_w, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(trans.numpy(), trans_w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("row_replay", [True, False])
def test_loss_and_grads_on_injected_segments(world, problem, monkeypatch,
                                             row_replay):
    monkeypatch.setattr(tsparse, "record_segments", jax_recorder(world[1]))
    got = port_loss(world, problem, row_replay=row_replay)
    assert_loss_grads(got, problem["ref"][row_replay], 1e-6, 1e-6)


def test_loss_and_grads_end_to_end(world, problem):
    """The port's own recorder, row replay, against the JAX function."""
    got = port_loss(world, problem)
    assert_loss_grads(got, problem["ref"][True], 1e-5, 1e-5)
    assert float(got[1][0].abs().sum()) > 0 and float(
        got[1][1].abs().sum()) > 0


def test_seg_cache_reuse_and_refresh(world, problem):
    """A warm cache with other FIELDS gives the fresh answer; a cache keyed
    to other targets refreshes instead of serving stale geometry."""
    _, _, tsc, _, _ = world
    p = problem
    o, d, bg, tgt = t(p["o"]), t(p["d"]), t(p["bg"]), t(p["tgt"])
    occ2 = t(p["occ"] * 0.9)

    def run(tg, cache=None):
        return tsparse.l2_loss_and_grads_sparse(
            o, d, tsc, p["cellmap"], occ2, t(p["alb"]), bg, tg, TG,
            k_segments=K, host_chunk=256, seg_cache=cache)

    cache: dict = {}
    run(tgt, cache)
    geo = cache["geo"]
    cached = run(tgt, cache)
    assert cache["geo"] is geo                    # reused, not re-recorded
    fresh = run(tgt)
    assert float(cached[0]) == float(fresh[0])
    for a, b in zip(cached[1], fresh[1]):
        assert torch.equal(a, b)
    tgt2 = torch.full((N, 3), 0.8)
    stale = run(tgt2, cache)
    assert cache["geo"] is not geo
    fresh2 = run(tgt2)
    assert float(stale[0]) == float(fresh2[0])
    for a, b in zip(stale[1], fresh2[1]):
        assert torch.equal(a, b)


def test_all_miss_frame(world):
    """Every ray misses: the loss is the sky SSE, the gradients zero."""
    _, _, tsc, occ, alb = world
    n = 300
    rng = np.random.default_rng(11)
    o = torch.tensor([[64.0, 64.0, 200.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    bg = t(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    tgt = t(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    loss, (go, ga) = tsparse.l2_loss_and_grads_sparse(
        o, d, tsc, tsparse.cell_pool_map(tsc, TG), t(occ * 0.7), t(alb), bg,
        tgt, TG, k_segments=K, host_chunk=256)
    expected = float(((bg - tgt) ** 2).sum() / (n * 3))
    np.testing.assert_allclose(float(loss), expected, rtol=1e-5)
    assert float(go.abs().max()) == 0.0 and float(ga.abs().max()) == 0.0


def test_sparse_gradients_fd(world):
    """Finite differences of the port's loss against its gradients
    (tests/test_diff_sparse.py::test_sparse_gradients_fd)."""
    _, _, tsc, occ, alb = world
    rng = np.random.default_rng(9)
    occ = occ * 0.6
    alb = rng.uniform(0.2, 1.0, alb.shape).astype(np.float32)
    o, d = rays(rng, 48)
    bg = torch.zeros((48, 3))
    tgt = torch.full((48, 3), 0.4)
    cellmap = tsparse.cell_pool_map(tsc, TG)

    def loss_of(occ_v, alb_v):
        return tsparse.l2_loss_and_grads_sparse(
            t(o), t(d), tsc, cellmap, t(occ_v), t(alb_v), bg, tgt, TG,
            k_segments=8)

    loss, (docc, dalb) = loss_of(occ, alb)
    docc, dalb = docc.numpy(), dalb.numpy()
    assert np.isfinite(float(loss))
    assert np.abs(docc).sum() > 0 and np.abs(dalb).sum() > 0
    h = 1e-3
    for idx in np.argsort(np.abs(docc).ravel())[-4:]:
        p, v = np.unravel_index(idx, docc.shape)
        occ_p, occ_m = occ.copy(), occ.copy()
        occ_p[p, v] += h
        occ_m[p, v] -= h
        fd = (float(loss_of(occ_p, alb)[0])
              - float(loss_of(occ_m, alb)[0])) / (2 * h)
        assert abs(fd - docc[p, v]) < 5e-3 * max(1.0, abs(fd)), \
            (p, v, fd, docc[p, v])
    for idx in np.argsort(np.abs(dalb).ravel())[-3:]:
        p, v, c = np.unravel_index(idx, dalb.shape)
        alb_p, alb_m = alb.copy(), alb.copy()
        alb_p[p, v, c] += h
        alb_m[p, v, c] -= h
        fd = (float(loss_of(occ, alb_p)[0])
              - float(loss_of(occ, alb_m)[0])) / (2 * h)
        assert abs(fd - dalb[p, v, c]) < 5e-3 * max(1.0, abs(fd)), \
            (p, v, c, fd, dalb[p, v, c])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_training_step_matches_cpu(cuda_device):
    """The sparse training step through B3/B4f/B4b on a 512^2 x 128 terrain
    world against the CPU path (plain versions); gradient sums on the card
    use atomics, hence the tolerance."""
    from brickmap_tpu_torch.kernels import extract as kext, record as krec

    grid = GridConfig(grid_size=512, grid_height=128)
    cpu = tscene.generate_terrain_scene(grid, device="cpu")
    gpu = cpu.to(cuda_device)
    rng = np.random.default_rng(0)
    n = 20000
    o = np.stack([rng.uniform(64, 448, n), rng.uniform(64, 448, n),
                  np.full(n, 120.0)], 1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out = {}
    for sc in (cpu, gpu):
        dev = sc.device
        cm = tsparse.cell_pool_map(sc, grid)
        occ, alb = tsparse.pool_fields_from_bitmask(sc)
        before = (krec.record_segments.launches, kext.extract_fwd.launches,
                  kext.extract_bwd.launches)
        loss, (go, ga) = tsparse.l2_loss_and_grads_sparse(
            t(o).to(dev), t(d).to(dev), sc, cm, occ * 0.8, alb * 0.6,
            torch.zeros((n, 3), device=dev), torch.full((n, 3), 0.4,
                                                        device=dev),
            grid, k_segments=8, host_chunk=4096)
        after = (krec.record_segments.launches, kext.extract_fwd.launches,
                 kext.extract_bwd.launches)
        out[dev.type] = (loss.cpu(), go.cpu(), ga.cpu(),
                         [a - b for a, b in zip(after, before)])
    assert out["cpu"][3] == [0, 0, 0]
    assert all(c >= 1 for c in out["cuda"][3])
    np.testing.assert_allclose(float(out["cuda"][0]), float(out["cpu"][0]),
                               rtol=1e-5)
    for i in (1, 2):
        np.testing.assert_allclose(out["cuda"][i].numpy(),
                                   out["cpu"][i].numpy(), atol=1e-5, rtol=0)


def test_sparse_inverse_benchmark_on_cpu():
    """``run_sparse_inverse_benchmark`` at a tiny size: the active set is the
    distinct pool rows of the recorded cells, no ray exhausts, the loss
    falls over the Adam steps and the result names the device."""
    from brickmap_tpu_torch.app.benchmark import SPARSE_ADAM_STEPS, \
        run_sparse_inverse_benchmark, sparse_inverse_rays
    from brickmap_tpu_torch.ops.record import record_segments_plain

    grid = TG
    sc = tscene.generate_terrain_scene(grid, device="cpu")
    out = run_sparse_inverse_benchmark(sc, grid, width=16, height=12)
    o, d, _, _ = sparse_inverse_rays(16 * 12, grid, "cpu")
    cells = record_segments_plain(o, d, sc, grid, k_segments=8)["cells"]
    cm = tsparse.cell_pool_map(sc, grid).numpy()
    c = cells[cells >= 0].numpy()
    rows = cm[(c >> 20) & 0x3FF, (c >> 10) & 0x3FF, c & 0x3FF]
    assert out["active_bricks"] == len(np.unique(rows[rows >= 0]))
    assert out["exhausted"] == 0 and out["device"] == "cpu"
    assert out["grads_finite"] and out["grads_nonzero"]
    assert len(out["losses"]) == SPARSE_ADAM_STEPS
    assert all(b < a for a, b in zip(out["losses"], out["losses"][1:]))
    frame = out["frame"]
    assert torch.equal(frame["origins"], o)
    assert frame["occupancy"].shape[0] == out["active_bricks"]
    assert frame["seg_cache"]["n_live"] == out["live_rays"]
    assert set(out["kernels"]) == {"prepass", "warm-up", "uncached",
                                   "cache fill", "cached", "adam"}


def sparse_small_recipe(n, lo=64.0, hi=960.0, z=250.0):
    """bench.py::_sparse_bwd_bench's frame (bench.py:336-345), repeated here
    in numpy with its constants as arguments."""
    rng = np.random.default_rng(0)
    ox = rng.uniform(lo, hi, n).astype(np.float32)
    oy = rng.uniform(lo, hi, n).astype(np.float32)
    oz = np.full(n, z, np.float32)
    origins = np.stack([ox, oy, oz], 1)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs


@pytest.mark.parametrize("grid, consts", [
    (GridConfig(grid_size=1024, grid_height=256), (64.0, 960.0, 250.0)),
    (TG, (8.0, 120.0, 125.0))])
def test_sparse_small_frame_equals_bench_recipe(grid, consts):
    """The small-world stage's frame is bench.py's, bit for bit, on its
    1024^2 x 256 world; on a smaller grid the same fractions of it."""
    from brickmap_tpu_torch.app.benchmark import SMALL_SPAN, \
        sparse_inverse_rays

    o, d, bg, tgt = sparse_inverse_rays(2048, grid, "cpu", span=SMALL_SPAN)
    o_ref, d_ref = sparse_small_recipe(2048, *consts)
    assert torch.equal(o, torch.from_numpy(o_ref))
    assert torch.equal(d, torch.from_numpy(d_ref))
    assert torch.equal(bg, torch.zeros((2048, 3)))
    assert torch.equal(tgt, torch.full((2048, 3), 0.4))


def test_sparse_small_benchmark_on_cpu():
    """``run_sparse_inverse_benchmark_small`` on a 128^2 x 128 world: the
    loss is the sparse step's on the whole pool's fields, and both rates
    are reported with the device."""
    from brickmap_tpu_torch.app.benchmark import SMALL_SPAN, \
        run_sparse_inverse_benchmark_small, sparse_inverse_rays

    out = run_sparse_inverse_benchmark_small("cpu", TG, width=16, height=8)
    sc = tscene.generate_terrain_scene(TG, device="cpu")
    occ, alb = tsparse.pool_fields_from_bitmask(sc)
    o, d, bg, tgt = sparse_inverse_rays(128, TG, "cpu", span=SMALL_SPAN)
    loss, _ = tsparse.l2_loss_and_grads_sparse(
        o, d, sc, tsparse.cell_pool_map(sc, TG), occ * 0.8, alb * 0.6, bg,
        tgt, TG, k_segments=8)
    assert out["loss"] == float(loss)
    assert out["rays"] == 128 and out["bricks"] == sc.num_bricks
    assert out["full"] > 0 and out["cached_step"] > 0
    assert out["device"] == "cpu"
