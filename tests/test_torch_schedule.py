"""The schedule of kernels B2 and B3 (``csrc/traverse.cu``,
``csrc/record.cu``: one thread per ray in launch order): the SIMD-efficiency
and launch-edge arithmetic of ``app/benchmark.py``, B3's limits, and the
plain versions held against the JAX package on the ray set that
``chip_smoke.py`` uses for the schedule's edge cases
(``app/benchmark.py::schedule_edge_rays``: in every warp, rays that miss at
once beside rays that spend a whole budget).  B2's ``hit``, ``request`` and
``request_pos`` must equal JAX's, ``t`` within 2e-2 and normals within 1e-5
(the tolerances of tests/test_torch_traverse.py); B3's ``cells``, ``ncode``,
``count``, ``exhausted`` and ``slot`` must equal the Pallas recorder's,
``nd`` within 1e-4 (tests/test_torch_record.py).  The ``cuda`` tests hold
the kernels bit for bit against their plain versions at the ray counts
around a warp and around the threads resident on the card at once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.config import GridConfig as JGrid
from brickmap_tpu.ops.traverse import trace_rays as jax_trace
from brickmap_tpu.pallas.paged import build_paged_scene, build_slot_tables
from brickmap_tpu.pallas.record import record_segments as jax_record
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.app import benchmark
from brickmap_tpu_torch.app.benchmark import edge_counts, \
    launch_order_simd, schedule_edge_rays
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.kernels import record as krec
from brickmap_tpu_torch.kernels import traverse as ktrav
from brickmap_tpu_torch.ops.record import record_segments_plain
from brickmap_tpu_torch.ops.traverse import trace_rays

torch.set_num_threads(2)

JG, TG = JGrid(grid_size=128, grid_height=128), \
    GridConfig(grid_size=128, grid_height=128)
N_EDGE = 128          # four warps of the edge-case ray set


@pytest.fixture(scope="module")
def terrain():
    sc = jscene.generate_terrain_scene(JG)
    tsc = tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                  sc.pool_base, device="cpu")
    return sc, tsc


@pytest.fixture(scope="module")
def edge_rays():
    return schedule_edge_rays(N_EDGE, TG, "cpu")


def plain_trace(tsc, o, d, cam=(0, 0, 0), steps=4096):
    return trace_rays(o, d, tsc.index_volume, tsc.pool_words, tsc.pool_base,
                      cam, TG, max_iters=steps)


# ---------------------------------------------------------------------------
# SIMD efficiency, launch edges and B3's limits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 33, 95, 1000])
def test_launch_order_simd_matches_a_direct_count(n, rng):
    """A warp of 32 consecutive rays (the last one ragged) issues steps until
    its longest ray ends."""
    steps = torch.from_numpy(rng.integers(0, 60, n).astype(np.int32))
    total = longest = 0
    for w0 in range(0, n, 32):
        warp = [int(v) for v in steps[w0:w0 + 32]]
        total += sum(warp)
        longest += max(warp)
    assert launch_order_simd(steps) == pytest.approx(
        total / (32 * longest), rel=1e-12)


def test_launch_order_simd_edge_values():
    steps = torch.ones(64, dtype=torch.int32)
    steps[0] = steps[33] = 32
    # Two warps, each lasting as long as its one 32-step ray.
    assert launch_order_simd(steps) == pytest.approx(126 / (32 * 64))
    assert launch_order_simd(torch.full((32,), 7)) == 1.0
    assert launch_order_simd(torch.zeros(5, dtype=torch.int32)) == 0.0


@pytest.mark.parametrize("blocks,threads", [
    (benchmark.B2_BLOCKS_PER_SM, 152_064),
    (benchmark.B3_BLOCKS_PER_SM, 202_752)])
def test_edge_counts_straddle_a_wave_of_blocks(blocks, threads):
    """On the H100's 132 SMs: the threads resident at once (blocks of 128
    on every SM), one ray under and over them, 3.5 waves."""
    counts = edge_counts(blocks, 132)
    assert counts == (1, 31, 33, threads - 1, threads + 1, threads * 7 // 2)
    assert [-(-n // 128) for n in counts[3:5]] == [blocks * 132,
                                                   blocks * 132 + 1]


@pytest.mark.parametrize("size,height", [(8320, 128), (128, 8320)])
def test_record_refuses_grids_beyond_the_packed_cell(size, height):
    """A packed cell has 10 bits an axis: 1040 cells raise on any device."""
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="at most 1024 cells an axis"):
        krec.record_segments(o, o, None, GridConfig(grid_size=size,
                                                    grid_height=height))


def test_segment_slots_fit_shared_memory():
    k = krec.max_segments()
    assert k * 128 * 8 <= 232_448 < (k + 1) * 128 * 8
    assert k == 227


# ---------------------------------------------------------------------------
# The edge-case rays through the plain versions, against the JAX package
# ---------------------------------------------------------------------------

def test_edge_rays_mix_steps_in_every_warp(terrain, edge_rays):
    """Under a small budget every warp holds rays that take no step and
    rays that spend the whole budget."""
    _, tsc = terrain
    o, d = edge_rays
    res = plain_trace(tsc, o, d, steps=24)
    steps = res["ray_iters"].reshape(-1, 32)
    assert bool((steps[:, 0::4] == 0).all())
    exhausted = res["exhausted"].reshape(-1, 32)
    assert bool(exhausted.any(1).all())
    assert bool((steps[exhausted] == 24).all())


@pytest.mark.parametrize("cam", [(0, 0, 0), (400, 0, 0), (900, 0, 0)])
def test_edge_rays_trace_matches_jax(terrain, edge_rays, cam):
    sc, tsc = terrain
    o, d = edge_rays
    port = plain_trace(tsc, o, d, cam=cam)
    ref = jax_trace(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                    jnp.asarray(sc.index_volume), jnp.asarray(sc.pool_words),
                    jnp.asarray(sc.pool_base), jnp.asarray(cam, jnp.int32),
                    JG, max_iters=4096)
    hit = port["hit"].numpy()
    assert not bool(port["exhausted"].any())
    np.testing.assert_array_equal(hit, np.asarray(ref["hit"]))
    np.testing.assert_array_equal(port["request"].numpy(),
                                  np.asarray(ref["request"]))
    np.testing.assert_allclose(port["t"].numpy()[hit],
                               np.asarray(ref["t"])[hit], atol=2e-2)
    np.testing.assert_allclose(port["normal"].numpy()[hit],
                               np.asarray(ref["normal"])[hit], atol=1e-5)
    assert 0 < hit.sum() < N_EDGE


def test_edge_rays_resume_after_a_small_budget(terrain, edge_rays):
    """Rays exhausted by a small budget, traced again from ``resume_t - 2``,
    find JAX's hits."""
    sc, tsc = terrain
    o, d = edge_rays
    short = plain_trace(tsc, o, d, steps=24)
    exh = short["exhausted"]
    off = torch.clamp(short["resume_t"][exh] - 2.0, min=0.0)
    again = plain_trace(tsc, o[exh] + d[exh] * off[:, None], d[exh])
    ref = jax_trace(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                    jnp.asarray(sc.index_volume), jnp.asarray(sc.pool_words),
                    jnp.asarray(sc.pool_base), jnp.zeros(3, jnp.int32), JG,
                    max_iters=4096)
    want_hit = np.asarray(ref["hit"])[exh.numpy()]
    np.testing.assert_array_equal(again["hit"].numpy(), want_hit)
    h = again["hit"].numpy()
    np.testing.assert_allclose((again["t"] + off).numpy()[h],
                               np.asarray(ref["t"])[exh.numpy()][h],
                               atol=2e-2)


@pytest.mark.parametrize("K,slots", [(6, False), (8, True), (16, True)])
def test_edge_rays_record_matches_pallas(terrain, edge_rays, K, slots):
    sc, tsc = terrain
    o, d = edge_rays
    ref = jax_record(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                     build_paged_scene(sc, JG), JG, k_segments=K,
                     interpret=True,
                     slot_tables=tuple(jnp.asarray(a) for a in
                                       build_slot_tables(sc, JG))
                     if slots else None)
    got = record_segments_plain(o, d, tsc, TG, k_segments=K,
                                with_slots=slots)
    for k in ["cells", "ncode", "count", "exhausted"] + (["slot"] if slots
                                                         else []):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["nd"].numpy(), np.asarray(ref["nd"]),
                               atol=1e-4, rtol=0)
    count = got["count"].reshape(-1, 32)
    assert bool((count[:, 0::4] == 0).all()) and int(count.max()) > 0


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_trace_edge_cases(cuda_device, terrain):
    _, tsc = terrain
    gsc = tsc.to(cuda_device)
    keys = ("hit", "t", "normal", "request", "request_pos", "exhausted",
            "resume_t", "ray_iters", "iters")
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for seed, n in enumerate(edge_counts(benchmark.B2_BLOCKS_PER_SM, sms)):
        o, d = schedule_edge_rays(n, TG, cuda_device, seed=seed)
        for steps in (24, 4096):
            a = ktrav.trace(o, d, gsc, (0, 0, 0), TG, steps)
            b = ktrav.trace(o, d, gsc, (400, 0, 0), TG, steps)  # back to back
            for cam, got in (((0, 0, 0), a), ((400, 0, 0), b)):
                want = trace_rays(o, d, gsc.index_volume, gsc.pool_words,
                                  gsc.pool_base, cam, TG, max_iters=steps)
                for k in keys:
                    assert torch.equal(got[k], want[k]), (n, steps, cam, k)


@pytest.mark.cuda
def test_cuda_record_edge_cases(cuda_device, terrain):
    _, tsc = terrain
    gsc = tsc.to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for K in (6, 8, 16):
        for seed, n in enumerate(edge_counts(benchmark.B3_BLOCKS_PER_SM,
                                             sms)):
            o, d = schedule_edge_rays(n, TG, cuda_device, seed=seed)
            for steps in (12, 2048):
                a = krec.record_segments(o, d, gsc, TG, k_segments=K,
                                         max_steps=steps, with_slots=True)
                b = krec.record_segments(o, d, gsc, TG, k_segments=K,
                                         max_steps=steps)
                for slots, got in ((True, a), (False, b)):
                    want = record_segments_plain(o, d, gsc, TG, k_segments=K,
                                                 max_steps=steps,
                                                 with_slots=slots)
                    for k, v in got.items():
                        assert torch.equal(v, want[k]), (K, n, steps, k)
