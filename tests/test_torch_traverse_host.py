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
(superchunks of 5 bricks), and the launch's edges.  Skipped only where
there is no g++.
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


def host_trace(lib, o, d, sc, cam, grid, steps):
    inputs, out = ktrav.launch_inputs(o, d, grid)
    count = torch.tensor([o.shape[0]], dtype=torch.int32)
    status = lib.traverse_launch(*ktrav.launch_args(
        inputs, sc.index_volume, sc, cam, grid, steps, out, None, count))
    assert status == 0
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
