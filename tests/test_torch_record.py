"""Kernel B3's plain version (brickmap_tpu_torch.ops.record) against the JAX
package's Pallas recorder in interpret mode.

The world is the ``sparse_world`` of tests/test_diff_sparse.py, built with
numpy and carried across with ``scene_from_numpy``.  ``cells``, ``ncode``,
``count``, ``exhausted`` and ``slot`` must be equal; ``nd`` within 1e-4 cell
units: the Pallas kernel crosses empty space by page jumps and capped nibble
jumps that depend on the other rays of its tile, so its float ``nd`` is not
bit-reproducible.  The ``cuda`` test holds the CUDA kernel against the plain
version on the card, where every output must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.config import GridConfig as JGrid
from brickmap_tpu.pallas.paged import build_paged_scene, build_slot_tables
from brickmap_tpu.pallas.record import record_segments as jax_record
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.kernels import record as krec
from brickmap_tpu_torch.ops.record import record_segments_plain

torch.set_num_threads(2)

JG, TG = JGrid(grid_size=128, grid_height=128), \
    GridConfig(grid_size=128, grid_height=128)


def sparse_dense():
    """tests/test_diff_sparse.py::sparse_world: two blobs of bricks."""
    rng = np.random.default_rng(102)
    dense = np.zeros((128, 128, 128), bool)
    dense[16:32, 32:64, 32:64] = rng.random((16, 32, 32)) < 0.35
    dense[48:56, 80:96, 40:56] = True
    return dense


@pytest.fixture(scope="module")
def world():
    sc = jscene.scene_from_dense(sparse_dense(), JG)
    psc = build_paged_scene(sc, JG)
    tabs = tuple(jnp.asarray(a) for a in build_slot_tables(sc, JG))
    tsc = tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                  sc.pool_base, device="cpu")
    return sc, psc, tabs, tsc


def rays_at_blobs(rng, n):
    """Rays from above the world aimed at the two blobs (most hit), and a
    quarter that graze the first blob along its diagonal (8 or more occupied
    cells each)."""
    origins = np.array([[64.0, 64.0, 120.0]] * n, np.float32)
    origins += rng.normal(scale=10.0, size=(n, 3)).astype(np.float32)
    centers = np.array([[48.0, 48.0, 24.0], [48.0, 88.0, 52.0]], np.float32)
    aims = centers[rng.integers(0, 2, n)] + rng.normal(
        scale=14.0, size=(n, 3)).astype(np.float32)
    d = aims - origins
    g = n // 4
    origins[:g] = rng.uniform([20, 20, 17], [30, 30, 31], (g, 3))
    d[:g] = [1.0, 1.0, 0.0] + rng.normal(scale=0.08, size=(g, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


def run_both(world, origins, dirs, K, slots):
    sc, psc, tabs, tsc = world
    ref = jax_record(jnp.asarray(origins), jnp.asarray(dirs), psc, JG,
                     k_segments=K, interpret=True,
                     slot_tables=tabs if slots else None)
    got = record_segments_plain(torch.from_numpy(origins),
                                torch.from_numpy(dirs), tsc, TG,
                                k_segments=K, with_slots=slots)
    keys = ["cells", "ncode", "count", "exhausted"] + (["slot"] if slots
                                                       else [])
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["nd"].numpy(), np.asarray(ref["nd"]),
                               atol=1e-4, rtol=0)
    # The clip runs inside the jitted JAX recorder, where XLA may contract
    # o + d*t; the last ulp of the clipped origin can differ.
    for k in ("tminn", "entry_normal", "o_cells"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    return got


@pytest.mark.parametrize("n,K,slots", [(96, 6, False), (800, 8, True),
                                       (400, 16, True)])
def test_plain_matches_pallas_record(world, rng, n, K, slots):
    origins, dirs = rays_at_blobs(rng, n)
    got = run_both(world, origins, dirs, K, slots)
    count = got["count"]
    assert int(count.max()) >= 3 and int((count > 0).sum()) > n // 3
    if K <= 8:
        assert int((count == K).sum()) > 0   # some rays fill all K segments
    # Front to back: entry distances never decrease along a ray.
    nd, cells = got["nd"], got["cells"]
    used = cells[:, 1:] >= 0
    assert bool((nd[:, 1:] >= nd[:, :-1] - 1e-4)[used].all())


def test_rays_starting_inside_occupied_cells(world, rng):
    """Origins inside the solid blob: the first segment is the start cell,
    with ncode -1 and nd 0."""
    n = 128
    lo = np.array([41.0, 81.0, 49.0], np.float32)
    hi = np.array([55.0, 95.0, 55.0], np.float32)
    origins = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    got = run_both(world, origins, dirs, 8, True)
    assert bool((got["count"] >= 1).all())
    assert bool((got["ncode"][:, 0] == -1).all())
    assert bool((got["nd"][:, 0] == 0).all())
    first = got["cells"][:, 0]
    cell = torch.from_numpy(origins // 8).to(torch.int32)
    assert torch.equal(first, cell[:, 0] | (cell[:, 1] << 10)
                       | (cell[:, 2] << 20))


def test_all_miss(world, rng):
    """Rays above the blobs pointing up, and rays that miss the world box,
    record nothing."""
    n = 200
    origins = rng.uniform([0, 0, 70], [128, 128, 127], (n, 3)).astype(
        np.float32)
    origins[n // 2:, 2] += 100.0          # above the world box
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    got = run_both(world, origins, dirs, 8, True)
    assert int(got["count"].max()) == 0
    assert bool((got["cells"] == -1).all()) and bool((got["slot"] == -1).all())


def test_budget_sets_exhausted(world, rng):
    """A ray still going when its step budget runs out is ``exhausted``; its
    segments so far are those of the unbudgeted run."""
    _, _, _, tsc = world
    origins, dirs = rays_at_blobs(rng, 256)
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    full = record_segments_plain(o, d, tsc, TG, k_segments=8)
    short = record_segments_plain(o, d, tsc, TG, k_segments=8, max_steps=5)
    exh = short["exhausted"]
    assert bool(exh.any()) and not bool(full["exhausted"].any())
    assert bool((short["ray_words"][exh] == 5).all())
    c = short["count"]
    for i in range(256):
        k = int(c[i])
        assert torch.equal(short["cells"][i, :k], full["cells"][i, :k])
        assert torch.equal(short["nd"][i, :k], full["nd"][i, :k])
    same = ~exh
    assert torch.equal(short["cells"][same], full["cells"][same])


def test_pallas_recorder_exhausts_an_unsorted_frame():
    """Why the port's active-brick count exceeds the JAX benchmark's: on the
    sparse benchmark's frame, unsorted (as ``bench.py``'s pre-pass records
    it), the Pallas recorder's tiles vote for one superchunk page per round
    and many rays run out of page rounds with a prefix of their segments.
    The port records every ray to the end.  A 1024^2 x 256 terrain world
    with 128 pages stands in for the full one."""
    from brickmap_tpu_torch.app.benchmark import sparse_inverse_rays

    jg = JGrid(grid_size=1024, grid_height=256)
    tg = GridConfig(grid_size=1024, grid_height=256)
    sc = jscene.generate_terrain_scene(jg)
    tsc = tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                  sc.pool_base, device="cpu")
    o, d, _, _ = sparse_inverse_rays(1024, tg, "cpu")
    ref = jax_record(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                     build_paged_scene(sc, jg), jg, k_segments=8,
                     interpret=True)
    got = record_segments_plain(o, d, tsc, tg, k_segments=8)
    exh = np.asarray(ref["exhausted"])
    count = np.asarray(ref["count"])
    cells = np.asarray(ref["cells"])
    assert exh.sum() > 100 and not bool(got["exhausted"].any())
    assert (got["count"].numpy()[exh] > count[exh]).any()
    np.testing.assert_array_equal(got["cells"].numpy()[~exh], cells[~exh])
    for i in np.nonzero(exh)[0]:
        np.testing.assert_array_equal(got["cells"].numpy()[i, :count[i]],
                                      cells[i, :count[i]])


def test_wrapper_on_cpu_is_plain_version(world, rng):
    _, _, _, tsc = world
    origins, dirs = rays_at_blobs(rng, 64)
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    before = krec.record_segments.launches
    res = krec.record_segments(o, d, tsc, TG, k_segments=8, with_slots=True)
    assert krec.record_segments.launches == before   # no kernel on the CPU
    ref = record_segments_plain(o, d, tsc, TG, k_segments=8, with_slots=True)
    assert set(res) == {"cells", "nd", "ncode", "count", "tminn",
                        "entry_normal", "o_cells", "exhausted", "slot"}
    for k, v in res.items():
        assert torch.equal(v, ref[k]), k
    with pytest.raises(ValueError):
        krec.record_segments(torch.zeros((4, 3), device="meta"),
                             torch.zeros((4, 3), device="meta"), tsc, TG)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_record_matches_plain(cuda_device, world, rng):
    _, _, _, tsc = world
    gsc = tsc.to(cuda_device)
    o, d = rays_at_blobs(rng, 1 << 14)
    o = torch.from_numpy(o).to(cuda_device)
    d = torch.from_numpy(d).to(cuda_device)
    for K, slots, steps in ((8, True, 2048), (16, False, 2048), (6, True, 7)):
        before = krec.record_segments.launches
        got = krec.record_segments(o, d, gsc, TG, k_segments=K,
                                   max_steps=steps, with_slots=slots)
        assert krec.record_segments.launches == before + 1
        want = record_segments_plain(o, d, gsc, TG, k_segments=K,
                                     max_steps=steps, with_slots=slots)
        for k, v in got.items():
            assert torch.equal(v, want[k]), k
