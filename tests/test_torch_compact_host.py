"""The wave's sync-free trace on the CPU: kernels W0 (compaction) and W4
(the rescue) of ``csrc/wave.cu``, and the device-side counts of W2 and B2
(``csrc/traverse.cu``), built with g++ through ``csrc/host_shim.h`` and
held against their plain versions (:mod:`brickmap_tpu_torch.ops.wave`)
bit for bit.

* W0 gives ``torch.nonzero``'s indices, in its order, and their count, on
  masks of 1 to 70,001 rows (a partial tile, warps and blocks around the
  4,096-row tile, 18 tiles: more than the shim's resident grid of 4 blocks,
  so a block takes several tiles and looks back across them), all-false
  and all-true, and over the first ``limit`` rows of a mask (the exhausted
  rays among a trace's compacted ones, ``limit`` around a tile's edge);
  its look-back adds the aggregates that running blocks published (tile
  statuses set in the scratch as a block of the card may find them: 32 at
  a time, back to before the first tile, or up to an inclusive status);
  each launch leaves its scratch zeroed (cursor, exits, statuses), so a
  launch with ``limit`` 0 after one that set statuses, and two launches
  back to back on one scratch, give ``torch.nonzero``'s results;
* W2 and B2 given a count below their capacity write rows below it as a
  launch of exactly that many does, and leave the rows past it as they
  were;
* W4 on rays made to exhaust (a starved budget on the 128^3 terrain, fully
  resident and with a third of its bricks unloaded) equals the host loop
  of rescue passes (``rescue_plain``) on every key, rays still exhausted
  after the passes included, with more rays than the shim's resident grid
  has threads (its warps take 32 rays at a time from the cursor); at a
  count of 0 it writes nothing, and it leaves its scratch zeroed.

The launchers are driven through the wrappers' own ctypes signatures and
arguments (:func:`~brickmap_tpu_torch.kernels.wave.compact_args`,
``gather_clip_args``, ``rescue_args``,
:func:`~brickmap_tpu_torch.kernels.traverse.launch_args`).  Skipped only
where there is no g++.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import BRICK_FLAG_BITS, BRICK_LOD_BITS, \
    BRICK_UNLOADED_BIT, BrickmapConfig, GridConfig, RenderConfig, i32
from brickmap_tpu_torch.kernels import traverse as ktrav, wave as kwave
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.ops import wave as owave
from brickmap_tpu_torch.ops.traverse import trace_clipped_rays
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for
from brickmap_tpu_torch.render.pathtrace import RESCUE_PASSES, rescue_budget
from brickmap_tpu_torch.render.sampling import draw_wave_uniforms
from _host_build import host_build

torch.set_num_threads(2)

W, H = 48, 32          # 1,536 lanes, 3,072 rays
N = W * H
CFG = BrickmapConfig(grid=GridConfig(grid_size=128, grid_height=128),
                     render=RenderConfig(width=W, height=H, max_bounces=1,
                                         max_top_steps=64))
CAM = (2, 2, 12)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = str(tmp_path_factory.mktemp("compact_host"))
    wave = ctypes.CDLL(host_build("wave", out))
    kwave._bind(wave)
    trav = ctypes.CDLL(host_build("traverse", out))
    ktrav._bind(trav)
    return wave, trav


# The shim's resident grid: 2 SMs x 2 blocks (csrc/host_shim.h).
RESIDENT_BLOCKS = 4
TILE = 4096
INCLUSIVE, AGGREGATE = 2 << 32, 1 << 32   # csrc/wave.cu's status flags


def new_scratch(rows=N * 2):
    return torch.zeros(kwave.scratch_words(rows), dtype=torch.int64)


def host_compact(lib, mask, limit=None, scratch=None):
    m = mask.shape[0]
    out = torch.full((m,), -7, dtype=torch.int32)
    count = torch.full((1,), -7, dtype=torch.int32)
    scratch = new_scratch(m) if scratch is None else scratch
    assert lib.wave_compact_launch(*kwave.compact_args(
        mask, limit, out, count, scratch, None)) == 0
    assert not bool(scratch.any()), "the launch left its scratch dirty"
    return out, count


def assert_nonzero(got, count, mask):
    want = torch.nonzero(mask).squeeze(1).int()
    assert int(count) == want.shape[0]
    assert torch.equal(got[:want.shape[0]], want)


def masks():
    cases = []
    for n in (1, 31, 33, 1025, 70001):
        rng = np.random.default_rng(n)
        cases += [(f"{n}-random", rng.random(n) < 0.37),
                  (f"{n}-dense", rng.random(n) < 0.97),
                  (f"{n}-false", np.zeros(n, bool)),
                  (f"{n}-true", np.ones(n, bool))]
    return cases


@pytest.mark.parametrize("name,mask", masks(), ids=[c[0] for c in masks()])
def test_w0_equals_nonzero(libs, name, mask):
    mask = torch.from_numpy(mask)
    got, count = host_compact(libs[0], mask)
    want = torch.nonzero(mask).squeeze(1).int()
    assert int(count) == want.shape[0]
    assert torch.equal(got[:want.shape[0]], want)
    plain, plain_count = owave.compact_plain(mask)
    assert torch.equal(plain_count, count)
    assert torch.equal(plain[:want.shape[0]], want)


@pytest.mark.parametrize("limit", [0, 1, 15, 17, 4095, 4096, 4097, 40001,
                                   70001])
def test_w0_over_the_first_rows(libs, limit):
    """``limit``: only the first rows count (W0 over B2's exhausted flags,
    the trace's count of them compacted)."""
    mask = torch.from_numpy(np.random.default_rng(5).random(70001) < 0.5)
    lim = torch.tensor([limit], dtype=torch.int32)
    got, count = host_compact(libs[0], mask, lim)
    want = torch.nonzero(mask[:limit]).squeeze(1).int()
    assert int(count) == want.shape[0]
    assert torch.equal(got[:want.shape[0]], want)
    plain, plain_count = owave.compact_plain(mask, lim)
    assert torch.equal(plain_count, count)
    assert torch.equal(plain[:want.shape[0]], want)


def test_w0_takes_more_tiles_than_its_grid(libs):
    """18 tiles on the shim's 4 resident blocks: the first block takes the
    tiles one after another from the cursor and finds each one's offset in
    the inclusive status of the tile before."""
    mask = torch.from_numpy(np.random.default_rng(7).random(18 * TILE - 3)
                            < 0.6)
    assert kwave.scratch_words(mask.shape[0]) - 2 > RESIDENT_BLOCKS
    got, count = host_compact(libs[0], mask)
    assert_nonzero(got, count, mask)


@pytest.mark.parametrize("first,inclusive_at", [
    (40, None),   # 40 aggregates: two windows of 32, then before tile 0
    (40, 3),      # aggregates back to tile 4, tile 3 inclusive
    (33, 32),     # the nearest predecessor inclusive
    (1, None)])   # tile 0 published as an aggregate alone
def test_w0_looks_back_over_published_aggregates(libs, first,
                                                 inclusive_at):
    """A launch whose cursor starts at tile ``first``, the statuses of the
    tiles before it set as blocks still running on the card leave them
    (each tile's own count as an aggregate; at ``inclusive_at`` the count
    with every tile before it): the look-back adds them up, so the tiles
    from ``first`` on land at their offsets in ``torch.nonzero``'s list,
    the count is the whole mask's, and the launch zeroes the statuses."""
    rng = np.random.default_rng(first)
    mask = torch.from_numpy(rng.random((first + 5) * TILE - 9) < 0.3)
    per_tile = [int(mask[t * TILE:(t + 1) * TILE].sum())
                for t in range(first)]
    scratch = new_scratch(mask.shape[0])
    scratch[:1] = first                     # the W0 cursor (int32 word 0)
    for t, c in enumerate(per_tile):
        scratch[2 + t] = (INCLUSIVE | sum(per_tile[:t + 1])
                          if t == inclusive_at else AGGREGATE | c)
    got, count = host_compact(libs[0], mask, scratch=scratch)
    want = torch.nonzero(mask).squeeze(1).int()
    skip = sum(per_tile)
    assert int(count) == want.shape[0]
    assert torch.equal(got[skip:want.shape[0]], want[skip:])
    assert bool((got[:skip] == -7).all()), "tiles before the cursor"


def test_w0_resets_its_scratch_between_launches(libs):
    """Launches back to back on one scratch: a full mask, then ``limit``
    0 (the statuses the first set are zeroed, else the count would be
    read from them), then two other masks."""
    scratch = new_scratch(70001)
    rng = np.random.default_rng(11)
    first = torch.from_numpy(rng.random(70001) < 0.5)
    assert_nonzero(*host_compact(libs[0], first, scratch=scratch), first)
    got, count = host_compact(libs[0], first,
                              torch.zeros(1, dtype=torch.int32), scratch)
    assert int(count) == 0
    for n, p in ((70001, 0.9), (5000, 0.1)):
        mask = torch.from_numpy(rng.random(n) < p)
        assert_nonzero(*host_compact(libs[0], mask, scratch=scratch), mask)


@pytest.fixture(scope="module")
def scenes():
    sc = tscene.generate_terrain_scene(CFG.grid, feature_scale=64.0,
                                       device="cpu")
    iv = sc.index_volume.clone()
    occupied = (iv & i32(BRICK_FLAG_BITS)) != 0
    flip = occupied & torch.from_numpy(
        np.random.default_rng(3).random(iv.shape) < 1 / 3)
    iv[flip] = (iv[flip] & BRICK_LOD_BITS) | BRICK_UNLOADED_BIT
    return {"resident": sc,
            "streaming": tscene.TorchScene(iv, sc.pool_words, sc.pool_base)}


def primary_state():
    """The wave's state after W1 (plain): N live primaries over the
    terrain, the shadow rows dead."""
    d = np.array([1.0, 1.0, -0.45])
    cam = Camera(position=(20.0, 20.0, 100.0),
                 direction=tuple(d / np.linalg.norm(d)), lens_radius=0.3,
                 focal_distance=2.0)
    arr = camera_arrays_for(
        cam, tss.sun_direction_from_position((0.05, 0.1), "cpu"), W, H,
        "cpu")
    gen = torch.Generator()
    gen.manual_seed(17)
    u = draw_wave_uniforms(N, 0, gen, "cpu")
    st = owave.new_state(N, "cpu")
    owave.primary_plain(torch.arange(N), u, arr, W, H, st)
    return st


def sentinel_outputs(cap):
    """B2's outputs over ``cap`` rows, filled with values no launch
    writes."""
    out = ktrav._outputs(cap, torch.device("cpu"))
    for k, v in out.items():
        v.fill_(True if v.dtype == torch.bool else -3)
    return out


@pytest.mark.parametrize("count", [0, 1, 33, 777, N - 1])
def test_b2_and_w2_stop_at_the_device_count(libs, scenes, count):
    """W2 and B2 launched over the capacity (the wave's 2N rows) with a
    count below it: rows below the count equal a launch of exactly that
    many rays, rows past it are left as they were."""
    wave, trav = libs
    sc = scenes["streaming"]
    st = primary_state()
    cap = 2 * N
    rng = np.random.default_rng(count)
    lanes = torch.from_numpy(rng.permutation(cap)[:cap].astype(np.int32))
    lanes[:count] = torch.from_numpy(np.sort(
        rng.choice(N, count, replace=False)).astype(np.int32))
    n_dev = torch.tensor([count], dtype=torch.int32)

    def gather(cap_lanes, n, pos):
        m = cap_lanes.shape[0]
        out = tuple(torch.full(s, -5.0) for s in ((m, 3), (m, 3), (m, 3),
                                                   (m,))) + (
            torch.ones(m, dtype=torch.bool),)
        assert wave.wave_gather_clip_launch(*kwave.gather_clip_args(
            st["rays_o"], st["rays_d"], cap_lanes, n, CFG.grid, pos, out,
            None)) == 0
        return out

    pos_cap = torch.full((cap,), -1, dtype=torch.int32)
    pos_exact = pos_cap.clone()
    got = gather(lanes, n_dev, pos_cap)
    exact = gather(lanes[:count].clone(), n_dev, pos_exact)
    assert torch.equal(pos_cap, pos_exact)
    for a, b in zip(got, exact):
        assert torch.equal(a[:count], b), "W2 rows below the count"
    for a in got[:4]:
        assert bool((a[count:] == -5.0).all()), "W2 rows past the count"
    assert bool(got[4][count:].all())

    res_cap = sentinel_outputs(cap)
    res_exact = sentinel_outputs(count)
    for out, inputs, n in ((res_cap, got, n_dev),
                           (res_exact, tuple(a[:count].clone() for a in got),
                            n_dev.clone())):
        assert trav.traverse_launch(*ktrav.launch_args(
            inputs, sc.index_volume, sc, CAM, CFG.grid, 12, out, None,
            n)) == 0
    want = trace_clipped_rays(*exact, sc.index_volume, sc.pool_words,
                              sc.pool_base, CAM, CFG.grid, max_iters=12)
    untouched = sentinel_outputs(cap)
    for k, v in res_cap.items():
        assert torch.equal(v[:count], res_exact[k]), k
        assert torch.equal(v[:count], want[k]), k
        assert torch.equal(v[count:], untouched[k][count:]), k
    if count > 100:
        assert bool(want["hit"].any()) and bool(want["exhausted"].any())
        assert bool(want["request"].any())


def starved_trace(sc, steps):
    """The plain W0, W2 and B2 over a primary state with ``steps`` DDA
    steps a ray: (res over the capacity, lanes, count, state)."""
    st = primary_state()
    lanes, count = owave.compact_plain(st["live"])
    inputs = owave.gather_clip_plain(st["rays_o"], st["rays_d"], lanes,
                                     count, CFG.grid, pos=st["pos"])
    m = int(count)
    res = sentinel_outputs(lanes.shape[0])
    part = trace_clipped_rays(*(a[:m] for a in inputs), sc.index_volume,
                              sc.pool_words, sc.pool_base, CAM, CFG.grid,
                              max_iters=steps)
    for k in res:
        res[k][:m] = part[k]
    return res, lanes, count, st


@pytest.mark.parametrize("residency", ["resident", "streaming"])
@pytest.mark.parametrize("budget,passes", [
    (None, RESCUE_PASSES),      # the wave's: every ray rescued
    (9, RESCUE_PASSES),         # some still exhausted after the passes
    (40, 1), (40, 0)])
def test_w4_equals_the_rescue_passes(libs, scenes, residency, budget,
                                     passes):
    sc = scenes[residency]
    budget = rescue_budget(CFG) if budget is None else budget
    res, lanes, count, st = starved_trace(sc, 6)
    rows, n_rows = owave.compact_plain(res["exhausted"], count)
    assert int(n_rows) > 100
    # More rays than the shim's resident grid has threads: warps take
    # 32 rays at a time from the cursor until none is left.
    assert int(n_rows) > RESIDENT_BLOCKS * 128
    got = {k: v.clone() for k, v in res.items()}
    want = {k: v.clone() for k, v in res.items()}
    scratch = new_scratch()
    assert libs[0].wave_rescue_launch(*kwave.rescue_args(
        got, rows, n_rows, lanes, st["rays_o"], st["rays_d"], sc, CAM,
        CFG.grid, budget, passes, scratch, None)) == 0
    assert not bool(scratch.any()), "W4 left its scratch dirty"
    owave.rescue_plain(want, rows, n_rows, lanes, st["rays_o"], st["rays_d"],
                       sc, CAM, CFG.grid, budget, passes)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    left = int(want["exhausted"][:int(count)].sum())
    if passes == 0:
        assert left == int(n_rows)
    elif budget == rescue_budget(CFG):
        assert left == 0
    else:
        assert 0 < left < int(n_rows)
    if passes:
        assert not torch.equal(want["hit"], res["hit"])


def test_w4_at_a_zero_count(libs, scenes):
    """W4 launched over a trace's capacity with a count of 0 writes no row
    and leaves the scratch as it found it (zeroed)."""
    sc = scenes["resident"]
    res, lanes, count, st = starved_trace(sc, 6)
    rows, _ = owave.compact_plain(res["exhausted"], count)
    got = {k: v.clone() for k, v in res.items()}
    scratch = new_scratch()
    assert libs[0].wave_rescue_launch(*kwave.rescue_args(
        got, rows, torch.zeros(1, dtype=torch.int32), lanes, st["rays_o"],
        st["rays_d"], sc, CAM, CFG.grid, rescue_budget(CFG), RESCUE_PASSES,
        scratch, None)) == 0
    assert not bool(scratch.any())
    for k in got:
        assert torch.equal(got[k], res[k]), k
