"""Kernel B2's CUDA source (``csrc/traverse.cu``) built with g++ through
``csrc/host_shim.h`` and run on the CPU, against its plain version.

The launcher is driven through the wrapper's own ctypes signature and
arguments (:func:`brickmap_tpu_torch.kernels.traverse.launch_args`) with
CPU tensors, so the kernel's reads of the index words and brick rows and
its outputs are checked here before the card runs them.  Every output must
equal ``trace_rays`` bit for bit, ``t`` and ``resume_t`` included: the
scenes of ``tests/test_torch_traverse.py`` (box and noise, resident and
with a third of the bricks unloaded), cameras on each side of the LoD
switches, a tiny budget, a world whose cell extents do not divide by 4
(superchunks of 5 bricks), and the launch's edges; warps in which one
lane descends beside 31 stepping lanes, all 32 descend at once, budgets
run out inside descends or in top steps while other lanes descend, and
LoD bytes and bricks are descended in one warp; and device counts up to
more tiles than the shim's resident blocks.  Skipped only where there is
no g++.  ``notes/test_probe_torch_b2_host.py`` holds the probe's unshipped
builds to the same warp and count cases.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import BRICK_FLAG_BITS, BRICK_LOD_BITS, \
    BRICK_UNLOADED_BIT, GridConfig, i32
from brickmap_tpu_torch.kernels import traverse as ktrav
from brickmap_tpu_torch.ops.traverse import trace_rays
from _host_build import host_build

torch.set_num_threads(2)

G128 = GridConfig(grid_size=128, grid_height=128)
# 25 x 25 x 15 cells: no extent divides by 4 (superchunks of 5 bricks).
GODD = GridConfig(grid_size=200, grid_height=120, supergrid_cell_size=5)
KEYS = ("hit", "t", "normal", "request", "request_pos", "exhausted",
        "resume_t", "ray_iters")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    so = ctypes.CDLL(host_build(
        "traverse", str(tmp_path_factory.mktemp("b2host"))))
    ktrav._bind(so)
    return so


def host_trace(lib, o, d, sc, cam, grid, steps, count=None, out=None):
    """B2 through ``lib`` over the rays ``o, d`` (the capacity), the first
    ``count`` of them traced (all by default), into ``out`` when given."""
    inputs, fresh = ktrav.launch_inputs(o, d, grid)
    out = fresh if out is None else out
    n = torch.tensor([o.shape[0] if count is None else count],
                     dtype=torch.int32)
    assert lib.traverse_launch(*ktrav.launch_args(
        inputs, sc.index_volume, sc, cam, grid, steps, out, None, n)) == 0
    return out


def unloaded_copy(sc, rng, share=1 / 3):
    """The scene with ``share`` of its occupied bricks turned back to
    ``unloaded | lod`` (a streaming scene part way in)."""
    iv = sc.index_volume.clone()
    occupied = (iv & i32(BRICK_FLAG_BITS)) != 0
    flip = occupied & torch.from_numpy(rng.random(iv.shape) < share)
    iv[flip] = (iv[flip] & BRICK_LOD_BITS) | BRICK_UNLOADED_BIT
    return tscene.TorchScene(iv, sc.pool_words, sc.pool_base)


def box_dense():
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    return dense


def odd_dense():
    rng = np.random.default_rng(7)
    dense = rng.random((120, 200, 200)) < 0.01
    dense[:40, 30:170, 20:150] |= rng.random((40, 140, 130)) < 0.5
    return dense


SCENES = {
    "box": lambda: (tscene.scene_from_dense(box_dense(), G128, device="cpu"),
                    G128),
    "noise": lambda: (tscene.scene_from_dense(
        np.random.default_rng(104).random((128, 128, 128)) < 0.015, G128,
        device="cpu"), G128),
    "odd": lambda: (tscene.scene_from_dense(odd_dense(), GODD,
                                            device="cpu"), GODD),
}


@pytest.fixture(scope="module")
def scenes():
    return {k: f() for k, f in SCENES.items()}


def rays(rng, n, grid):
    hi = np.array(grid.world_max, np.float32)
    o = rng.uniform(-0.15 * hi, 1.15 * hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 8, rng.integers(0, 3)] = 0.0       # axis-parallel components
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("residency", ["resident", "streaming"])
@pytest.mark.parametrize("cam,steps", [((0, 0, 0), 4096),
                                       ((400, 0, 0), 4096),
                                       ((900, 0, 0), 4096),
                                       ((0, 0, 0), 6)])
def test_host_kernel_matches_plain(host_lib, scenes, name, residency, cam,
                                   steps, rng):
    sc, grid = scenes[name]
    if residency == "streaming":
        sc = unloaded_copy(sc, rng)
    o, d = rays(rng, 1500, grid)
    got = host_trace(host_lib, o, d, sc, cam, grid, steps)
    want = trace_rays(o, d, sc.index_volume, sc.pool_words, sc.pool_base,
                      cam, grid, max_iters=steps)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    if steps == 6:
        assert bool(want["exhausted"].any())
    else:
        assert bool(want["hit"].any())


@pytest.mark.parametrize("n", [0, 1, 31, 33, 129, 1000])
def test_host_kernel_launch_edges(host_lib, scenes, n):
    """Ray counts around a warp and a block, each warp mixing rays that take
    no step with rays that spend the budget
    (``app/benchmark.py::schedule_edge_rays``, as chip_smoke.py phase 4)."""
    from brickmap_tpu_torch.app import benchmark

    sc, grid = scenes["noise"]
    o, d = benchmark.schedule_edge_rays(n, grid, "cpu", seed=n)
    for steps in (24, 4096):
        got = host_trace(host_lib, o, d, sc, (0, 0, 0), grid, steps)
        want = trace_rays(o, d, sc.index_volume, sc.pool_words,
                          sc.pool_base, (0, 0, 0), grid, max_iters=steps)
        for k in KEYS:
            assert torch.equal(got[k], want[k]), k


def box_scene(layer: bool):
    """The 128^3 box world, or only the box's bottom voxel layer (a descend
    from above then takes 8 steps to its hit)."""
    dense = np.zeros((128, 128, 128), bool)
    dense[16:17 if layer else 48, 32:96, 32:96] = True
    return tscene.scene_from_dense(dense, G128, device="cpu")


def warp_rays(case: str):
    """32 rays (one warp) and the scene, camera and budgets of ``case``.
    Rays going down from z = 100 reach the box in 2 top steps; rays going
    along x at z = 50.5, over the box's top, take 12-13 top steps through
    empty cells and no descend."""
    lane = np.arange(32)
    down_o = np.stack([40 + 1.5 * lane, np.full(32, 64.0),
                       np.full(32, 100.0)], 1)
    down_d = np.tile([0.0, 0.0, -1.0], (32, 1))
    down_d[:, 0] = 0.01 * (lane % 3)
    along_o = np.stack([np.full(32, 1.0), 36 + 1.7 * lane,
                        np.full(32, 50.5)], 1)
    along_d = np.tile([1.0, 0.02, 0.0], (32, 1))
    cam, budgets = (0, 0, 0), (4096,)
    layer = False
    if case in ("one holds, 31 step", "8 hold, 24 run out stepping"):
        k = 1 if case.startswith("one") else 8
        o = np.concatenate([down_o[:k], along_o[k:]])
        d = np.concatenate([down_d[:k], along_d[k:]])
        budgets = (4096,) if k == 1 else tuple(range(1, 14))
    elif case == "32 hold at once":
        o, d = down_o, down_d
    elif case == "32 run out in held descends":
        o, d, layer, budgets = down_o, down_d, True, tuple(range(1, 12))
    else:   # bytes and bricks: cells x <= 7 are past lod_distance_2
        o = np.stack([33 + 2.0 * lane, np.full(32, 64.0),
                      np.full(32, 100.0)], 1)
        d, cam = down_d, (324, 0, 0)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)), box_scene(layer), cam,
            budgets)


WARP_CASES = ["one holds, 31 step", "32 hold at once",
              "32 run out in held descends", "8 hold, 24 run out stepping",
              "bytes and bricks in one warp"]


def check_warp(trace, case):
    """The warp of ``case`` through ``trace`` (``host_trace``'s signature
    without the library), every output bit-equal to ``trace_rays``; the
    plain version's step counts show that the warp is the case it names."""
    o, d, sc, cam, budgets = warp_rays(case)
    seen = set()
    for steps in budgets:
        got = trace(o, d, sc, cam, G128, steps)
        want = trace_rays(o, d, sc.index_volume, sc.pool_words,
                          sc.pool_base, cam, G128, max_iters=steps)
        for k in KEYS:
            assert torch.equal(got[k], want[k]), (steps, k)
        bricks, exh = want["ray_bricks"] > 0, want["exhausted"]
        descended = want["ray_iters"] > want["ray_words"]
        if bool(bricks[:1].all() and not bricks[1:].any()):
            seen.add("one holds")
        if bool(bricks.all() and want["hit"].all()):
            seen.add("all hold")
        if bool((exh & bricks).all()) and steps > 2:
            seen.add("run out descending")
        if bool(want["hit"][:8].all() and exh[8:].all()
                and not bricks[8:].any()):
            seen.add("run out stepping")
        if bool((descended & ~bricks & want["hit"]).any()
                and (bricks & want["hit"]).any()):
            seen.add("bytes and bricks")
    assert {"one holds, 31 step": "one holds",
            "32 hold at once": "all hold",
            "32 run out in held descends": "run out descending",
            "8 hold, 24 run out stepping": "run out stepping",
            "bytes and bricks in one warp": "bytes and bricks"}[case] in seen


@pytest.mark.parametrize("case", WARP_CASES)
def test_host_schedule_warps(host_lib, case):
    """Warps that mix descending and stepping lanes and run out of budget
    in either, through csrc/traverse.cu."""
    check_warp(lambda *a: host_trace(host_lib, *a), case)


COUNTS = [0, 1, 33, 700, 1500]


def check_device_count(trace, scenes, rng, count):
    """A launch through ``trace`` over 1,500 rows with a device count at or
    below it: rows below the count equal ``trace_rays`` of those rays, rows
    past it are left as they were.  1,500 rays are 47 warps' tiles, more
    than the 16 warps of the shim's resident grid (2 SMs x 2 blocks of
    128)."""
    sc, grid = scenes["noise"]
    sc = unloaded_copy(sc, rng)
    o, d = rays(rng, 1500, grid)
    out = ktrav._outputs(1500, torch.device("cpu"))
    for v in out.values():
        v.fill_(True if v.dtype == torch.bool else -3)
    trace(o, d, sc, (400, 0, 0), grid, 4096, count=count, out=out)
    want = trace_rays(o[:count], d[:count], sc.index_volume, sc.pool_words,
                      sc.pool_base, (400, 0, 0), grid, max_iters=4096)
    for k in KEYS:
        assert torch.equal(out[k][:count], want[k]), k
        untouched = out[k][count:]
        assert bool((untouched == (True if untouched.dtype == torch.bool
                                   else -3)).all()), k


@pytest.mark.parametrize("count", COUNTS)
def test_host_kernel_stops_at_the_device_count(host_lib, scenes, rng, count):
    """csrc/traverse.cu at device counts from 0 to its capacity."""
    check_device_count(lambda *a, **k: host_trace(host_lib, *a, **k),
                       scenes, rng, count)
