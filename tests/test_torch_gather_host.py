"""Kernel W2 of ``csrc/wave.cu`` (the wave's gather fused with the
world-box clip) on the CPU: built with g++ through ``csrc/host_shim.h``
and held bit for bit against its plain version
(``ops/wave.py::gather_clip_plain``), NaN in the same places.

W2 launches at most the blocks resident at once (the shim's: 2 SMs x 2
blocks), which walk the count's 256-row tiles with a grid-stride loop and
store each tile's [256, 3] outputs as runs of 16-byte words.  The cases:

* counts 0, 1, 255, 256, 257, the capacity less one and the capacity (12
  tiles: three a block), with the position map absent and present; every
  row at or past the count keeps its sentinel (outputs, and the map's rows
  of lanes past the count), so the last partial tile stores no word past
  its rows;
* a capacity of 70,001 rows (274 tiles, 68 or 69 a block) at counts on
  and around a tile's edge;
* the lanes' patterns of the wave: one run of consecutive rows (bounce
  0's), a run from a row that is not a multiple of 4, runs broken by gaps
  (a dense bounce's), and a run's rows out of order;
* two launches back to back into the same outputs agree (the kernel keeps
  no state between launches);
* outputs off their 16-byte alignment are refused by the launcher.

The rays start inside, outside and on the planes of the box, some with a
zero direction component.  The launcher is driven through the wrapper's
own ctypes signature and arguments
(:func:`~brickmap_tpu_torch.kernels.wave.gather_clip_args`).  Skipped only
where there is no g++.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.kernels import wave as kwave
from brickmap_tpu_torch.ops import wave as owave
from _host_build import host_build

torch.set_num_threads(2)

GRID = GridConfig(grid_size=256, grid_height=128)
CAP = 3072            # 12 tiles of 256 rows: 3 a block of the shim's 4
ROWS = 4000           # rows of the ray buffers the lanes index
TILE = 256            # rows a tile of W2 (csrc/wave.cu: kGatherTile)
RESIDENT_BLOCKS = 4   # the shim's resident grid (csrc/host_shim.h)
SENTINEL = -5.0       # no output row is written with it
OK_SENTINEL = 7       # ok's byte where no launch wrote (it writes 0 or 1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = str(tmp_path_factory.mktemp("gather_host"))
    wave = ctypes.CDLL(host_build("wave", out))
    kwave._bind(wave)
    return wave


def rays(n, seed=0):
    """``n`` rays around the 256 x 256 x 128 box: origins inside, outside
    and on its planes, unit directions, a fifth with a zero component (an
    eighth of those on a plane they run along)."""
    rng = np.random.default_rng(seed)
    hi = np.array(GRID.world_max, np.float32)
    o = rng.uniform(-0.3 * hi, 1.3 * hi, (n, 3)).astype(np.float32)
    on, axis = rng.integers(0, 3, 2)
    o[: n // 20, on] = 0.0
    o[n // 20: n // 10, axis] = hi[axis]
    d = rng.normal(size=(n, 3))
    d[: n // 40, on] = 0.0           # on a plane and parallel to it
    d[n // 10: n // 5, rng.integers(0, 3)] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def lanes_for(count, cap, rows, seed):
    """W0's output over ``cap`` rows: ``count`` distinct rows of the ray
    buffers in ascending order, then rows no launch may read (in range, so
    that a read past the count shows in the position map, not as a
    fault)."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, rows, cap).astype(np.int32)
    lanes[:count] = np.sort(rng.choice(rows, count, replace=False))
    return torch.from_numpy(lanes)


def sentinel_outputs(cap):
    out = (torch.full((cap, 3), SENTINEL), torch.full((cap, 3), SENTINEL),
           torch.full((cap, 3), SENTINEL), torch.full((cap,), SENTINEL),
           torch.zeros(cap, dtype=torch.bool))
    out[4].view(torch.uint8).fill_(OK_SENTINEL)
    return out


def launch(lib, rays_o, rays_d, lanes, count, pos, out):
    n = torch.tensor([count], dtype=torch.int32)   # held over the launch
    return lib.wave_gather_clip_launch(*kwave.gather_clip_args(
        rays_o, rays_d, lanes, n, GRID, pos, out, None))


def same(a, b) -> bool:
    """Equal bit for bit, NaN equal to NaN."""
    if a.is_floating_point():
        both = torch.isnan(a) & torch.isnan(b)
        return bool(((a == b) | both).all()) and a.shape == b.shape
    return torch.equal(a, b)


def check(lib, count, cap, with_pos, seed=0, lanes=None):
    rays_o, rays_d = rays(max(ROWS, cap + 1), seed)
    if lanes is None:
        lanes = lanes_for(count, cap, rays_o.shape[0], seed + 1)
    pos_k = torch.full((rays_o.shape[0],), -1, dtype=torch.int32)
    pos_p = pos_k.clone()
    got = sentinel_outputs(cap)
    assert launch(lib, rays_o, rays_d, lanes, count,
                  pos_k if with_pos else None, got) == 0
    want = owave.gather_clip_plain(
        rays_o, rays_d, lanes, torch.tensor([count], dtype=torch.int32),
        GRID, pos_p if with_pos else None)
    names = ("clipped", "dirs", "entry_normal", "tminn", "ok")
    for name, a, b in zip(names, got, want):
        assert same(a[:count], b[:count]), f"{name}: rows below the count"
    for name, a in zip(names[:4], got[:4]):
        assert bool((a[count:] == SENTINEL).all()), \
            f"{name}: rows past the count written"
    assert bool((got[4].view(torch.uint8)[count:] == OK_SENTINEL).all()), \
        "ok: rows past the count written"
    assert bool((got[4].view(torch.uint8)[:count] <= 1).all())
    assert torch.equal(pos_k, pos_p), "position map"
    if with_pos:
        assert int((pos_k >= 0).sum()) == count
    return got, want


@pytest.mark.parametrize("with_pos", [False, True], ids=["no-pos", "pos"])
@pytest.mark.parametrize("count", [0, 1, 255, 256, 257, CAP - 1, CAP])
def test_w2_equals_gather_clip_plain(lib, count, with_pos):
    """A count from 0 to the capacity: the rows below it equal the plain
    version's, every row past it keeps its sentinel."""
    got, want = check(lib, count, CAP, with_pos)
    if count == CAP:
        # The rays reach every branch of the clip.
        assert bool(want[4].any()) and not bool(want[4].all())
        assert bool((want[3] > 0).any()) and bool((want[3] == 0).any())
        assert bool((want[1] == 0).any(1).any())


@pytest.mark.parametrize("count", [TILE * 68 - 1, TILE * 68, TILE * 68 + 1,
                                   70001 - 3, 70001])
def test_w2_takes_more_tiles_than_its_grid(lib, count):
    """70,001 rows of capacity: 274 tiles on the shim's 4 resident blocks,
    so each block walks 68 or 69 of them; counts on a tile's edge, a
    block's share of the tiles and the capacity."""
    cap = 70001
    assert -(-count // TILE) > 16 * RESIDENT_BLOCKS
    check(lib, count, cap, with_pos=True, seed=count)


def run_lanes(kind, count, cap):
    """Lanes whose tiles are runs of consecutive rows (bounce 0's, from
    row 0 or row 5), runs broken by gaps, or a run's rows out of
    order."""
    lanes = lanes_for(count, cap, ROWS, 9)
    if kind == "run at 0":
        head = np.arange(count)
    elif kind == "run at 5":
        head = np.arange(count) + 5
    elif kind == "gaps":      # a gap every 300 rows: some tiles are runs
        head = np.arange(count) + np.arange(count) // 300
    else:                     # each tile's run reversed
        head = np.arange(count).reshape(-1, 8)[:, ::-1].reshape(-1)
    lanes[:count] = torch.from_numpy(head.astype(np.int32))
    return lanes


@pytest.mark.parametrize("kind", ["run at 0", "run at 5", "gaps",
                                  "reversed"])
@pytest.mark.parametrize("count", [1000, CAP])
def test_w2_loads_runs_of_rows(lib, kind, count):
    """The lanes' patterns of a wave's traces, the last partial tile
    included: every row equal to the plain version's."""
    check(lib, count, CAP, with_pos=True,
          lanes=run_lanes(kind, count, CAP))


def test_w2_launches_back_to_back_agree(lib):
    """Two launches into the same outputs, then one with a smaller count:
    the first rows equal a fresh launch's, the rows between the two counts
    keep what the first launch wrote."""
    rays_o, rays_d = rays(ROWS, 3)
    lanes = lanes_for(CAP, CAP, ROWS, 4)
    out = sentinel_outputs(CAP)
    for _ in range(2):
        assert launch(lib, rays_o, rays_d, lanes, CAP, None, out) == 0
    first = tuple(a.clone() for a in out)
    fresh = sentinel_outputs(CAP)
    assert launch(lib, rays_o, rays_d, lanes, CAP, None, fresh) == 0
    assert all(same(a, b) for a, b in zip(first, fresh))
    assert launch(lib, rays_o, rays_d, lanes, 700, None, out) == 0
    assert all(same(a, b) for a, b in zip(out, first))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_w2_refuses_unaligned_outputs(lib, which):
    """A [*, 3] output that does not start on a 16-byte boundary (here 4
    bytes past one) is refused: its tiles' 16-byte stores would fault on
    the card."""
    rays_o, rays_d = rays(ROWS)
    lanes = lanes_for(10, CAP, ROWS, 1)
    out = list(sentinel_outputs(CAP))
    out[which] = torch.full((CAP * 3 + 1,), SENTINEL)[1:].view(CAP, 3)
    assert out[which].data_ptr() % 16 == 4
    assert launch(lib, rays_o, rays_d, lanes, 10, None, tuple(out)) != 0
    assert bool((out[which] == SENTINEL).all())
