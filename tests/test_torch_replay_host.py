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
  masked, at K = 2, 4 and 8: each ray's SSE and every cotangent equal.

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


@pytest.mark.parametrize("keff", [2, 4, 8])
def test_r2_on_random_values(host_lib, keff):
    """Occupancies exactly 0 and 1, outside [0, 1], and masked steps."""
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
    got = host_composite(host_lib, *args)
    want = composite_sse_plain(*args)
    assert_equal(got, want)
