"""Kernels R1 and R2 (``csrc/replay.cu``) built with g++ through
``csrc/host_shim.h`` and run on the CPU, against their plain versions
(:mod:`brickmap_tpu_torch.ops.replay`).

The launchers are driven through the wrappers' own ctypes signatures and
arguments (:func:`~brickmap_tpu_torch.kernels.replay.segment_geom_args`,
``composite_sse_args``) with CPU tensors.  Every operation of both kernels
is an IEEE add, multiply, divide, floor, ceil, trunc or compare, which the
g++ build (no FMA contraction) and torch's CPU kernels round alike, so both
are held bit for bit:

* R1 on the segments of a terrain world's record at K = 8 and on column
  cuts of it at K = 2 and 4 (row stride 8, as the replay's slices pass
  them), on rays with zero and axis-aligned direction components, and on
  random segments (cells outside the map, start-cell and entry-face
  codes, far entry distances): slots and visited voxels equal;
* R2 on B4f's values of those segments over the terrain's fields, and on
  random values with occupancies exactly 0 and 1, outside [0, 1] and
  masked, at K = 2, 4 and 8: each ray's SSE and every cotangent equal;
* both at 1, 31, 33, 127 and 129 rays and K = 2, 4 and 8 (partial warps
  and blocks: R2 stages a warp's rows and R1 a block's through shared
  memory, with barriers, which the shim runs as on the card);
* R1 on segments whose crossing counts saturate (direction components near
  0, far entry distances), where the ranks of an axis are not monotone and
  the kernel keeps merge_offsets' search; a build with the search on every
  axis equals the plain version too, and one with the sweep on every axis
  differs there (so those segments reach the search).

Skipped only where there is no g++.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.diff import sparse as tsparse
from brickmap_tpu_torch.kernels import replay as krep
from brickmap_tpu_torch.kernels.record import record_segments
from brickmap_tpu_torch.ops.extract import extract_fwd_plain
from brickmap_tpu_torch.ops.replay import composite_sse_plain, \
    segment_geom_plain
from _host_build import host_build

torch.set_num_threads(2)

GRID = GridConfig(grid_size=256, grid_height=128)
NVOX = krep.NVOX
K = 8


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    so = ctypes.CDLL(host_build(
        "replay", str(tmp_path_factory.mktemp("rhost"))))
    krep._bind(so)
    return so


@pytest.fixture(scope="module")
def merge_libs(tmp_path_factory):
    """Builds with the search (1) and the sweep (2) on every axis."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = str(tmp_path_factory.mktemp("rmerge"))
    libs = {}
    for mode in (1, 2):
        libs[mode] = ctypes.CDLL(host_build(
            "replay", out, defines=(f"BM_R1_MERGE={mode}",)))
        krep._bind(libs[mode])
    return libs


@pytest.fixture(scope="module")
def terrain():
    """The world, its cellmap, fields (bitmask x 0.8 with a random albedo)
    and the record of 2,000 rays at K = 8, some axis-aligned."""
    sc = tscene.generate_terrain_scene(GRID, feature_scale=64.0,
                                       device="cpu")
    rng = np.random.default_rng(21)
    n = 2000
    o = np.stack([rng.uniform(16, 240, n), rng.uniform(16, 240, n),
                  np.full(n, 120.0)], 1).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d[:40] = [0.0, 0.0, -1.0]
    d[40:80, 0] = 0.0
    d[80:120, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = torch.from_numpy(d.astype(np.float32))
    segs = record_segments(torch.from_numpy(o), d, sc, GRID, k_segments=K)
    cellmap = tsparse.cell_pool_map(sc, GRID)
    occ, alb = tsparse.pool_fields_from_bitmask(sc)
    alb = alb * torch.from_numpy(rng.uniform(0.1, 1.0, alb.shape).astype(
        np.float32))
    field4 = tsparse._pack_field(occ * 0.8, alb)
    return segs, d, cellmap, field4


def random_segments(seed, n, cellmap):
    """Segments of no record: random cells (some off the map or empty),
    entry distances, face codes (-1 takes the entry normal) and rays."""
    rng = np.random.default_rng(seed)
    cz, cy, cx = cellmap.shape
    cells = (rng.integers(0, cx + 2, (n, K)) | (rng.integers(0, cy, (n, K))
             << 10) | (rng.integers(0, cz, (n, K)) << 20)).astype(np.int32)
    cells[rng.random((n, K)) < 0.1] = -1
    nd = rng.uniform(0.0, 40.0, (n, K)).astype(np.float32)
    ncode = rng.integers(-1, 3, (n, K)).astype(np.int32)
    d = rng.normal(size=(n, 3))
    d[rng.random((n, 3)) < 0.05] = 0.0
    d[:, 2] += 1e-3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(0.0, 32.0, (n, 3))
    enorm = np.eye(3)[rng.integers(0, 3, n)] * rng.choice([-1.0, 1.0], (n, 1))
    return tuple(torch.from_numpy(a.astype(np.float32) if a.dtype.kind == "f"
                                  else a)
                 for a in (o, d, cells, nd, ncode, enorm))


def saturating_segments(seed, n, cellmap):
    """Random segments whose rays have a direction component of magnitude
    1e-12 to 1e-7 (its crossings ~1e7 to 1e12 apart) and far entry
    distances: the other axes' crossing counts saturate their int32
    conversion there."""
    o, d, cells, nd, ncode, enorm = random_segments(seed, n, cellmap)
    rng = np.random.default_rng(seed + 100)
    d = d.numpy().astype(np.float64)
    axis = rng.integers(0, 3, n)
    d[np.arange(n), axis] = rng.choice([-1.0, 1.0], n) * 10.0 ** \
        rng.uniform(-12, -7, n)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nd = torch.from_numpy(rng.uniform(0.0, 2000.0, (n, K)).astype(np.float32))
    return o, torch.from_numpy(d.astype(np.float32)), cells, nd, ncode, enorm


def host_geom(lib, o, d, cells, nd, ncode, enorm, cellmap):
    c, k = cells.shape
    out = (torch.full((c * k,), 7, dtype=torch.int32),
           torch.full((c * k, NVOX), 7, dtype=torch.int32))
    args, keep = krep.segment_geom_args(o, d, cells, nd, ncode, enorm,
                                        cellmap, GRID, out, None)
    assert lib.replay_geom_launch(*args) == 0
    del keep
    return out


def host_composite(lib, vals, lin2, bg, tgt):
    out = (torch.full((bg.shape[0],), 7.0),
           torch.full(vals.shape, 7.0))
    args, keep = krep.composite_sse_args(vals, lin2, bg, tgt, out, None)
    assert lib.replay_composite_launch(*args) == 0
    del keep
    return out


def assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        bad = g != w
        assert not bool(bad.any()), f"{int(bad.sum())} of {g.numel()} differ"


@pytest.mark.parametrize("keff", [2, 4, 8])
def test_r1_on_the_record(host_lib, terrain, keff):
    segs, d, cellmap, _ = terrain
    args = (segs["o_cells"], d, segs["cells"][:, :keff],
            segs["nd"][:, :keff], segs["ncode"][:, :keff],
            segs["entry_normal"], cellmap)
    got = host_geom(host_lib, *args)
    want = segment_geom_plain(*args, GRID)
    assert_equal(got, want)
    assert int((want[1] >= 0).sum()) > 1000


@pytest.mark.parametrize("seed", [0, 1])
def test_r1_on_random_segments(host_lib, terrain, seed):
    cellmap = terrain[2]
    o, d, cells, nd, ncode, enorm = random_segments(seed, 1500, cellmap)
    got = host_geom(host_lib, o, d, cells, nd, ncode, enorm, cellmap)
    want = segment_geom_plain(o, d, cells, nd, ncode, enorm, cellmap, GRID)
    assert_equal(got, want)
    assert int((want[1] >= 0).sum()) > 1000


@pytest.mark.parametrize("keff", [2, 4, 8])
def test_r2_on_the_terrain_fields(host_lib, terrain, keff):
    """B4f's values of the recorded segments over bitmask x 0.8 fields:
    every empty voxel of a visited brick sits exactly at 0."""
    segs, d, cellmap, field4 = terrain
    args = (segs["o_cells"], d, segs["cells"][:, :keff],
            segs["nd"][:, :keff], segs["ncode"][:, :keff],
            segs["entry_normal"], cellmap)
    slots, lin2 = segment_geom_plain(*args, GRID)
    vals = extract_fwd_plain(field4, slots, lin2)
    n = d.shape[0]
    rng = np.random.default_rng(keff)
    bg = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    got = host_composite(host_lib, vals, lin2, bg, tgt)
    want = composite_sse_plain(vals, lin2, bg, tgt)
    assert_equal(got, want)
    assert bool((vals[:, :NVOX][lin2 >= 0] == 0).any())
    assert bool((want[1][:, :NVOX] != 0).any())


def unaligned(a):
    """``a`` as a view one element past an aligned buffer's start."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype)
    v = buf[1:].view(a.shape)
    v.copy_(a)
    return v


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("keff", [2, 4, 8])
def test_r2_on_random_values(host_lib, keff, offset):
    """Occupancies exactly 0 and 1, outside [0, 1], and masked steps; with
    ``offset``, vals and lin2 are views 4 bytes off their rows' alignment,
    which the arguments refuse (the kernel copies them in 16- and 8-byte
    pieces)."""
    rng = np.random.default_rng(30 + keff)
    c = 500
    cs = c * keff
    x = rng.uniform(0.0, 0.4, (cs, NVOX)).astype(np.float32)
    pick = rng.integers(0, 12, (cs, NVOX))
    x[pick == 0] = 0.0
    x[pick == 1] = 1.0
    x[pick == 2] = -0.25
    x[pick == 3] = 1.25
    vals = np.concatenate(
        [x, rng.uniform(-0.2, 1.2, (cs, 3 * NVOX)).astype(np.float32)], 1)
    lin2 = rng.integers(0, 512, (cs, NVOX)).astype(np.int32)
    lin2[rng.random((cs, NVOX)) < 0.3] = -1
    bg = rng.uniform(0, 1, (c, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (c, 3)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (vals, lin2, bg, tgt)]
    want = composite_sse_plain(*args)
    if offset:
        for i, what in ((0, "vals"), (1, "lin2")):
            bad = list(args)
            bad[i] = unaligned(args[i])
            with pytest.raises(ValueError, match=f"{what} must be"):
                host_composite(host_lib, *bad)
    assert_equal(host_composite(host_lib, *args), want)


@pytest.mark.parametrize("keff", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129])
def test_r1_r2_at_ray_counts(host_lib, terrain, n, keff):
    """R1 and R2 on the first n rays' segments at K = keff (column cuts of
    the record), R2 on their B4f values and on random values there."""
    segs, d, cellmap, field4 = terrain
    args = (segs["o_cells"][:n], d[:n], segs["cells"][:n, :keff],
            segs["nd"][:n, :keff], segs["ncode"][:n, :keff],
            segs["entry_normal"][:n], cellmap)
    got = host_geom(host_lib, *args)
    want = segment_geom_plain(*args, GRID)
    assert_equal(got, want)
    slots, lin2 = want
    rng = np.random.default_rng(1000 * n + keff)
    bg = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    vals = extract_fwd_plain(field4, slots, lin2)
    assert_equal(host_composite(host_lib, vals, lin2, bg, tgt),
                 composite_sse_plain(vals, lin2, bg, tgt))
    x = rng.uniform(-0.25, 1.25, (n * keff, 4 * NVOX)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = 0.0
    x[rng.random(x.shape) < 0.1] = 1.0
    vals = torch.from_numpy(x)
    assert_equal(host_composite(host_lib, vals, lin2, bg, tgt),
                 composite_sse_plain(vals, lin2, bg, tgt))


@pytest.mark.parametrize("seed", [0, 1])
def test_r1_on_saturating_segments(host_lib, merge_libs, terrain, seed):
    """Where the counts saturate: the kernel and its search-only build equal
    the plain version; the sweep-only build does not (the ranks wrap)."""
    cellmap = terrain[2]
    segs = saturating_segments(seed, 1500, cellmap)
    want = segment_geom_plain(*segs, cellmap, GRID)
    assert int((want[1] >= 0).sum()) > 1000
    assert_equal(host_geom(host_lib, *segs, cellmap), want)
    assert_equal(host_geom(merge_libs[1], *segs, cellmap), want)
    swept = host_geom(merge_libs[2], *segs, cellmap)
    assert not torch.equal(swept[1], want[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_r1_search_build_on_random_segments(merge_libs, terrain, seed):
    """The search on every axis (the first design's merge) equals the plain
    version on the random segments and the record."""
    segs, d, cellmap, _ = terrain
    o, d2, cells, nd, ncode, enorm = random_segments(seed, 1500, cellmap)
    assert_equal(host_geom(merge_libs[1], o, d2, cells, nd, ncode, enorm,
                           cellmap),
                 segment_geom_plain(o, d2, cells, nd, ncode, enorm, cellmap,
                                    GRID))
    args = (segs["o_cells"], d, segs["cells"], segs["nd"], segs["ncode"],
            segs["entry_normal"], cellmap)
    assert_equal(host_geom(merge_libs[1], *args),
                 segment_geom_plain(*args, GRID))
