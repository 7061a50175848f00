"""brickmap_tpu_torch scene, bits and worldgen against the JAX package.

The same inputs, made with numpy, go through ``brickmap_tpu`` and the port;
index words, pools and bases must agree bit for bit.
"""

import json

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


def assert_same_summary(port, ref):
    """scene_summary of the port equal to the JAX package's, key for key
    (the port adds ``resident_bytes``)."""
    assert list(port) == list(ref) + ["resident_bytes"]
    for k, v in ref.items():
        if k == "per_superchunk_loaded":
            assert port[k].dtype == v.dtype and port[k].shape == v.shape
            np.testing.assert_array_equal(port[k], v)
        else:
            assert port[k] == v, k


def test_scene_summary_counts():
    jg, tg = grids(*MULTI)
    port = tscene.generate_terrain_scene(tg, device="cpu")
    info = tscene.scene_summary(port, tg)
    assert info["nonempty_bricks"] == info["loaded_bricks"] \
        == info["num_bricks"] > 0
    assert info["pool_bytes"] == port.num_bricks * 64
    assert info["per_superchunk_loaded"].shape == (1, 2, 2)
    assert int(info["per_superchunk_loaded"].sum()) == info["loaded_bricks"]
    assert_same_summary(info, jscene.scene_summary(
        jscene.generate_terrain_scene(jg), jg))


def test_scene_summary_matches_jax_partly_loaded(rng):
    """Some bricks loaded, some unloaded, over four superchunks, and a
    non-default superchunk size."""
    for sc_size in (16, 8):
        jg = JGrid(grid_size=256, grid_height=128,
                   supergrid_cell_size=sc_size)
        tg = GridConfig(grid_size=256, grid_height=128,
                        supergrid_cell_size=sc_size)
        ref = jscene.generate_terrain_scene(jg, feature_scale=64.0)
        iv = np.asarray(ref.index_volume).copy()
        flip = ((iv & np.uint32(0x8000_0000)) != 0) \
            & (rng.random(iv.shape) < 0.4)
        iv[flip] = (iv[flip] & np.uint32(0xFF000)) | np.uint32(0x4000_0000)
        ref = jscene.VoxelScene(index_volume=iv, pool_words=ref.pool_words,
                                pool_base=ref.pool_base)
        port = tscene.scene_from_numpy(iv, ref.pool_words, ref.pool_base,
                                       device="cpu")
        assert_same_summary(tscene.scene_summary(port, tg),
                            jscene.scene_summary(ref, jg))


def jax_scene_with_fields(rng, jg):
    ref = jscene.scene_from_dense(rng.random((128, 128, 128)) < 0.02, jg)
    p = ref.pool_words.shape[0]
    return jscene.VoxelScene(
        index_volume=ref.index_volume, pool_words=ref.pool_words,
        pool_base=ref.pool_base,
        occupancy=rng.random((p, 8, 8, 8)).astype(np.float32),
        albedo=rng.random((p, 8, 8, 8, 3)).astype(np.float32))


def assert_same_npz(a: str, b: str):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            np.testing.assert_array_equal(x[k], y[k])


def test_save_load_fields_interchange(tmp_path, rng):
    """occupancy/albedo survive the .npz round trip both ways: a JAX file
    loads in the port and is saved back with the same keys, dtypes and
    values; a port file with fields loads in the JAX package."""
    jg, _ = grids(*SMALL)
    ref = jax_scene_with_fields(rng, jg)
    q = str(tmp_path / "jax.npz")
    jscene.save_scene(q, ref)
    port = tscene.load_scene(q, device="cpu")
    assert port.occupancy.dtype == torch.float32
    np.testing.assert_array_equal(port.albedo.numpy(), ref.albedo)
    assert_same_scene(port, ref)
    q2 = str(tmp_path / "port.npz")
    tscene.save_scene(q2, port)
    assert_same_npz(q, q2)

    port2 = tscene.scene_from_numpy(ref.index_volume, ref.pool_words,
                                    ref.pool_base, device="cpu")
    port2 = tscene.TorchScene(port2.index_volume, port2.pool_words,
                              port2.pool_base,
                              occupancy=torch.from_numpy(ref.occupancy),
                              albedo=torch.from_numpy(ref.albedo))
    assert port2.to("cpu").albedo is not None
    p = str(tmp_path / "port2.npz")
    tscene.save_scene(p, port2)
    back = jscene.load_scene(p)
    np.testing.assert_array_equal(back.occupancy, ref.occupancy)
    np.testing.assert_array_equal(back.albedo, ref.albedo)
    assert_same_npz(p, q)
    # Without fields, neither package writes the keys.
    p3 = str(tmp_path / "bare.npz")
    tscene.save_scene(p3, tscene.TorchScene(
        port2.index_volume, port2.pool_words, port2.pool_base))
    bare = tscene.load_scene(p3, device="cpu")
    assert bare.occupancy is None and bare.albedo is None
    assert jscene.load_scene(p3).occupancy is None


def test_cli_info_matches_jax(tmp_path, rng, capsys):
    """The port's ``info`` prints the JAX ``info`` dict for the same file."""
    import argparse

    from brickmap_tpu.app import cli as jcli
    from brickmap_tpu_torch.app import cli as tcli

    jg, _ = grids(*MULTI)
    ref = jscene.generate_terrain_scene(jg, residency="streaming")
    q = str(tmp_path / "world.npz")
    jscene.save_scene(q, ref)
    assert jcli.cmd_info(argparse.Namespace(load=q)) == 0
    want = capsys.readouterr().out.strip()
    for argv in (["info", q], ["info", "--load", q]):
        assert tcli.main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out.strip()
        assert json.loads(got) == json.loads(want)
        assert got == want
    assert tcli.main(["info", str(tmp_path / "no.npz"), "--device",
                      "cpu"]) == 2


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
