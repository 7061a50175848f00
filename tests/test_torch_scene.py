"""brickmap_tpu_torch scene, bits and worldgen against the JAX package.

The same inputs, made with numpy, go through ``brickmap_tpu`` and the port;
index words, pools and bases must agree bit for bit.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py configures)
import numpy as np
import pytest
import torch

from brickmap_tpu import bits as jbits, native as jnative, scene as jscene
from brickmap_tpu.config import GridConfig as JGrid
from brickmap_tpu_torch import bits as tbits, native as tnative, \
    scene as tscene
from brickmap_tpu_torch.config import GridConfig

torch.set_num_threads(2)

SMALL = (128, 128)
MULTI = (256, 128)


def grids(size, height):
    return (JGrid(grid_size=size, grid_height=height),
            GridConfig(grid_size=size, grid_height=height))


def assert_same_scene(port, ref):
    iv, pool, base = tscene.to_numpy(port)
    np.testing.assert_array_equal(iv, np.asarray(ref.index_volume))
    np.testing.assert_array_equal(pool, np.asarray(ref.pool_words))
    np.testing.assert_array_equal(base, np.asarray(ref.pool_base))
    assert iv.dtype == np.uint32 and pool.dtype == np.uint32


@pytest.mark.parametrize("size,height,feature_scale,residency", [
    (*SMALL, 64.0, "full"),
    (*SMALL, 64.0, "streaming"),
    (*MULTI, 2048.0, "full"),
    (*MULTI, 2048.0, "streaming"),
])
def test_terrain_matches_jax(size, height, feature_scale, residency):
    jg, tg = grids(size, height)
    ref = jscene.generate_terrain_scene(jg, residency=residency,
                                       feature_scale=feature_scale)
    port = tscene.generate_terrain_scene(tg, residency=residency,
                                         feature_scale=feature_scale,
                                         device="cpu")
    assert_same_scene(port, ref)


def test_terrain_numpy_fallback_matches_jax():
    jg, tg = grids(*SMALL)
    ref = jscene.generate_terrain_scene(jg, feature_scale=64.0,
                                       use_native=False)
    port = tscene.generate_terrain_scene(tg, feature_scale=64.0,
                                         use_native=False, device="cpu")
    assert_same_scene(port, ref)


def test_native_heights_match_jax_native():
    a = jnative.terrain_heights(256, 128, 8, 2048.0)
    b = tnative.terrain_heights(256, 128, 8, 2048.0)
    assert a is not None and b is not None
    np.testing.assert_array_equal(a, b)
    assert jnative.simplex2_at(3.7, -1.25) == tnative.simplex2_at(3.7, -1.25)


@pytest.mark.parametrize("size,height,density,residency", [
    (*SMALL, 0.02, "full"),       # test_scene.py:30 (roundtrip)
    (*MULTI, 0.01, "full"),       # test_scene.py:39 (multi superchunk)
    (*SMALL, 0.05, "full"),       # test_scene.py:49 (lod bytes)
    (*SMALL, 0.02, "streaming"),
])
def test_scene_from_dense_matches_jax(size, height, density, residency, rng):
    jg, tg = grids(size, height)
    dense = rng.random((height, size, size)) < density
    ref = jscene.scene_from_dense(dense, jg, residency=residency)
    port = tscene.scene_from_dense(dense, tg, residency=residency,
                                   device="cpu")
    assert_same_scene(port, ref)


def test_streaming_init_slab():
    """test_scene.py:82: a solid slab, streaming residency."""
    jg, tg = grids(*SMALL)
    dense = np.zeros((128, 128, 128), bool)
    dense[:32] = True
    ref = jscene.scene_from_dense(dense, jg, residency="streaming")
    port = tscene.scene_from_dense(dense, tg, residency="streaming",
                                   device="cpu")
    assert_same_scene(port, ref)
    iv = port.index_volume
    nonempty = (iv & -(1 << 29)) != 0
    assert not tbits.index_is_loaded(iv[nonempty]).any()
    assert tbits.index_is_unloaded(iv[nonempty]).all()


def test_scene_from_numpy_roundtrip(rng):
    jg, _ = grids(*SMALL)
    ref = jscene.scene_from_dense(rng.random((128, 128, 128)) < 0.03, jg)
    port = tscene.scene_from_numpy(ref.index_volume, ref.pool_words,
                                   ref.pool_base, device="cpu")
    assert port.index_volume.dtype == torch.int32
    assert_same_scene(port, ref)
    # Bit 31 survives as the sign bit of the int32 pattern.
    loaded = (np.asarray(ref.index_volume) & np.uint32(0x8000_0000)) != 0
    np.testing.assert_array_equal((port.index_volume < 0).numpy(), loaded)


def test_save_load_interchange(tmp_path, rng):
    """The .npz files of both packages load in the other one."""
    jg, tg = grids(*SMALL)
    dense = rng.random((128, 128, 128)) < 0.02
    port = tscene.scene_from_dense(dense, tg, device="cpu")
    p = str(tmp_path / "port.npz")
    tscene.save_scene(p, port)
    assert_same_scene(port, jscene.load_scene(p))
    q = str(tmp_path / "jax.npz")
    jscene.save_scene(q, jscene.scene_from_dense(dense, jg))
    assert_same_scene(tscene.load_scene(q, device="cpu"),
                      jscene.load_scene(q))


def test_chebyshev_distance_matches_jax(rng):
    occ = rng.random((20, 24, 28)) < 0.02
    occ[3, 4, 5] = True
    ref = jscene.chebyshev_distance_field(occ)
    got = tscene.chebyshev_distance_field(torch.from_numpy(occ))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_scene_summary_counts():
    _, tg = grids(*MULTI)
    port = tscene.generate_terrain_scene(tg, device="cpu")
    info = tscene.scene_summary(port)
    assert info["nonempty_bricks"] == info["loaded_bricks"] \
        == info["num_bricks"] > 0
    assert info["pool_bytes"] == port.num_bricks * 64


# ---------------------------------------------------------------------------
# Bit helpers
# ---------------------------------------------------------------------------

def test_pack_index_word_matches_jax(rng):
    n = 500
    slot = rng.integers(0, 5000, n)
    lod = rng.integers(0, 300, n)
    flags = rng.random((3, n)) < 0.5
    ref = jbits.pack_index_word(slot, lod, loaded=flags[0],
                                unloaded=flags[1], requested=flags[2])
    got = tbits.pack_index_word(torch.from_numpy(slot), torch.from_numpy(lod),
                                loaded=torch.from_numpy(flags[0]),
                                unloaded=torch.from_numpy(flags[1]),
                                requested=torch.from_numpy(flags[2]))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    ref_s = jbits.pack_index_word(slot, lod, loaded=False, unloaded=True)
    got_s = tbits.pack_index_word(torch.from_numpy(slot),
                                  torch.from_numpy(lod), loaded=False,
                                  unloaded=True)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32), ref_s)


def test_index_field_readers_match_jax(rng):
    words = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(tbits.index_slot(t).numpy(),
                                  jbits.index_slot(words))
    np.testing.assert_array_equal(tbits.index_lod_byte(t).numpy(),
                                  jbits.index_lod_byte(words))
    for name in ("index_is_loaded", "index_is_unloaded",
                 "index_is_requested"):
        np.testing.assert_array_equal(getattr(tbits, name)(t).numpy(),
                                      getattr(jbits, name)(words), name)


def test_brick_word_packing_matches_jax(rng):
    dense = rng.random((6, 8, 8, 8)) < 0.4
    ref = jbits.brick_words_from_dense(dense)
    got = tbits.brick_words_from_dense(torch.from_numpy(dense))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(tbits.dense_from_brick_words(got).numpy(),
                                  jbits.dense_from_brick_words(ref))
    np.testing.assert_array_equal(
        tbits.lod_byte_from_dense(torch.from_numpy(dense)).numpy(),
        jbits.lod_byte_from_dense(dense))
    x, y, z = (rng.integers(0, 8, 6) for _ in range(3))
    np.testing.assert_array_equal(
        tbits.test_voxel_bit(got, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(z)).numpy(),
        jbits.test_voxel_bit(ref, x, y, z))
    wi, bi = tbits.voxel_bit_position(torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(z))
    rwi, rbi = jbits.voxel_bit_position(x, y, z)
    np.testing.assert_array_equal(wi.numpy(), rwi)
    np.testing.assert_array_equal(bi.numpy(), rbi)
