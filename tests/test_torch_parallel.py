"""Ray-sharded data parallelism of brickmap_tpu_torch over torch.distributed
(gloo, CPU) against the JAX package's ``shard_map`` paths on the virtual
8-device CPU mesh of tests/conftest.py.

One process group of 2 and one of 4 processes (tests/test_torch_gloo_worker.py)
are started once, side by side, and run every case; each test holds one case
of one group against the JAX function on a mesh of the same size:

* the sharded wave (each shard's uniforms drawn as the JAX shard draws them,
  from ``fold_in(key, shard)``), divisible and not: rgb rtol 1e-4 / atol
  1e-5, counts, traced, exhausted, mask and pos equal;
* the dense step: loss rtol 1e-6, gradients atol 1e-6;
* the sparse step, JAX in interpret mode: loss rtol 1e-5, gradients atol
  1e-5 (tests/test_torch_diff.py's end-to-end tolerances);
* one step of ``InverseRenderer(mesh=...)``: loss rtol 1e-6, the updated
  fields atol 1e-6;
* the ``scaling`` CLI with ``--distributed`` in 2 processes.

Every rank must return the same result.  The ``cuda`` test holds the wave at
world size 1 over NCCL on the card.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.app import scaling as jscaling
from brickmap_tpu.config import BrickmapConfig as JConfig, \
    GridConfig as JGrid, RenderConfig as JRender
from brickmap_tpu.diff import sparse as jsparse
from brickmap_tpu.diff.optim import InverseRenderer as JInverseRenderer
from brickmap_tpu.ops import sunsky as jss
from brickmap_tpu.pallas.paged import build_paged_scene
from brickmap_tpu.parallel import render as jpar
from brickmap_tpu.render import pathtrace as jpt
from brickmap_tpu.render.camera import Camera as JCamera
from brickmap_tpu_torch.app import scaling as tscaling
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for
import test_torch_gloo_worker as worker
from test_torch_render import jax_wave_uniforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (2, 4)
JCFG = JConfig(grid=JGrid(grid_size=worker.GRID, grid_height=worker.GRID),
               render=JRender(width=32, height=16,
                              max_bounces=worker.BOUNCES,
                              max_top_steps=worker.TOP_STEPS))
CAM = dict(position=(10.0, 10.0, 80.0),
           direction=tuple(np.array([1.0, 1.0, -0.4])
                           / np.linalg.norm([1.0, 1.0, -0.4])))
WAVE_KEY = 5
SCALING = [sys.executable, "-m", "brickmap_tpu_torch", "scaling", "--device",
           "cpu", "--width", "32", "--height", "16", "--bounces", "1",
           "--world", "128", "--world-height", "128", "--max-steps", "64",
           "--waves", "1", "--inverse-rays", "256", "--distributed",
           "--num-processes", "2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _problem():
    """The inputs of every case (tests/test_parallel.py's worlds and rays),
    as numpy, plus what the JAX side needs."""
    x, j = {}, {}
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    sc = jscene.scene_from_dense(dense, JCFG.grid)
    x.update(iv=sc.index_volume, pw=sc.pool_words, pb=sc.pool_base)
    j["scene"] = jscene.VoxelScene(index_volume=jnp.asarray(sc.index_volume),
                                   pool_words=jnp.asarray(sc.pool_words),
                                   pool_base=jnp.asarray(sc.pool_base))
    jcam = JCamera(**CAM)
    x["cam_brick"] = np.asarray(jcam.brick_position, np.int32)
    for w, h in worker.RESOLUTIONS:
        arr = camera_arrays_for(
            Camera(**CAM), tss.sun_direction_from_position((0.05, 0.1), "cpu"),
            w, h, "cpu")
        x.update({f"cam{w}x{h}_{k}": v.numpy() for k, v in arr.items()})
        j[(w, h)] = jpt.camera_arrays_for(
            jcam, jss.sun_direction_from_position(jnp.asarray([0.05, 0.1])),
            w, h)
        for d in SIZES:
            local = -(-w * h // d)
            for s in range(d):
                u = jax_wave_uniforms(
                    jax.random.fold_in(jax.random.PRNGKey(WAVE_KEY), s),
                    local, worker.BOUNCES)
                x.update({worker.uniform_key(d, (w, h), s, k): v.numpy()
                          for k, v in u.items()})

    rng = np.random.default_rng(41)
    x["dense_occ"] = rng.uniform(0.1, 0.7, (8, 8, 8)).astype(np.float32)
    x["dense_alb"] = rng.uniform(0.2, 0.9, (8, 8, 8, 3)).astype(np.float32)
    n = 64
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x["dense_d"] = dirs
    x["dense_o"] = (np.array([4, 4, 4]) - dirs * 14).astype(np.float32)
    x["dense_bg"] = np.zeros((n, 3), np.float32)
    x["dense_tgt"] = np.full((n, 3), 0.4, np.float32)

    dense = np.zeros((128, 128, 128), bool)
    dense[16:40, 40:80, 40:80] = True
    ssc = jscene.scene_from_dense(dense, JCFG.grid)
    x.update(s_iv=ssc.index_volume, s_pw=ssc.pool_words, s_pb=ssc.pool_base)
    j["psc"] = jax.tree.map(jnp.asarray, build_paged_scene(ssc, JCFG.grid))
    j["cellmap"] = jnp.asarray(jsparse.cell_pool_map(ssc, JCFG.grid))
    occ, alb = jsparse.pool_fields_from_bitmask(ssc)
    x["s_occ"], x["s_alb"] = occ * 0.6, alb
    origins = np.array([[60.0, 60.0, 120.0]] * n, np.float32)
    d = (np.array([60, 60, 28], np.float32) - origins
         + rng.normal(scale=20, size=(n, 3)).astype(np.float32))
    x["s_d"] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)
    x["s_o"] = origins
    x["s_bg"] = np.zeros((n, 3), np.float32)
    x["s_tgt"] = np.full((n, 3), 0.4, np.float32)
    return x, j


class Groups:
    """The gloo groups, started side by side; ``results(d)`` waits for
    group ``d`` and returns each rank's results."""

    def __init__(self, inputs: str, base):
        self.procs, self.dirs = {}, {}
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        for d in SIZES:
            self.dirs[d] = base / f"d{d}"
            self.dirs[d].mkdir()
            port = _free_port()
            self.procs[d] = [subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests",
                                              "test_torch_gloo_worker.py"),
                 inputs, str(self.dirs[d]), str(d), str(r), str(port)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(d)]
        self.done = {}
        port = _free_port()
        self.scaling = [subprocess.Popen(
            SCALING + ["--coordinator", f"127.0.0.1:{port}",
                       "--process-id", str(r)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]

    def results(self, d):
        if d not in self.done:
            logs = [p.communicate(timeout=180)[0] for p in self.procs[d]]
            for p, log in zip(self.procs[d], logs):
                assert p.returncode == 0, log[-3000:]
            self.done[d] = [dict(np.load(self.dirs[d] / f"r{r}.npz"))
                            for r in range(d)]
        return self.done[d]

    def close(self):
        for ps in [*self.procs.values(), self.scaling]:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("gloo")
    x, j = _problem()
    np.savez(base / "inputs.npz", **x)
    groups = Groups(str(base / "inputs.npz"), base)
    try:
        yield x, j, groups
    finally:
        groups.close()


def _ranks(groups, d, prefix):
    """Rank 0's results under ``prefix``, after checking that every rank
    holds the same ones."""
    res = groups.results(d)
    keys = [k for k in res[0] if k.startswith(prefix)]
    assert keys
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k])
    return {k[len(prefix):]: res[0][k] for k in keys}


@pytest.mark.parametrize("d,res", [(2, (32, 16)), (4, (32, 16)),
                                   (4, (33, 15))],
                         ids=["2-32x16", "4-32x16", "4-33x15"])
def test_render_wave_sharded_matches_jax(setup, d, res):
    x, j, groups = setup
    w, h = res
    rgb_j, cnt_j, req_j = jpar.render_wave_sharded(
        jpar.make_mesh(d), jax.random.PRNGKey(WAVE_KEY), j["scene"], j[res],
        jnp.asarray(x["cam_brick"]), JCFG, w, h)
    got = _ranks(groups, d, f"wave{w}x{h}_")
    assert got["rgb"].shape == (w * h, 3)
    np.testing.assert_allclose(got["rgb"], np.asarray(rgb_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got["count"], np.asarray(cnt_j))
    np.testing.assert_array_equal(got["mask"], np.asarray(req_j["mask"]))
    np.testing.assert_array_equal(got["pos"], np.asarray(req_j["pos"]))
    assert int(got["traced"]) == int(req_j["traced_rays"]) > w * h
    assert int(got["exhausted"]) == int(req_j["exhausted_rays"]) == 0
    assert float(got["rgb"].sum()) > 0


@pytest.mark.parametrize("d", SIZES)
def test_inverse_train_step_matches_jax(setup, d):
    x, _, groups = setup
    loss_j, docc_j, dalb_j = jpar.inverse_train_step(
        jpar.make_mesh(d), *(jnp.asarray(x[f"dense_{k}"]) for k in
                             ("o", "d", "occ", "alb", "bg", "tgt")),
        max_steps=worker.DENSE_STEPS)
    got = _ranks(groups, d, "dense_")
    np.testing.assert_allclose(float(got["loss"]), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(got["docc"], np.asarray(docc_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["dalb"], np.asarray(dalb_j), rtol=0,
                               atol=1e-6)
    assert np.abs(got["docc"]).sum() > 0


@pytest.mark.parametrize("d", SIZES)
def test_inverse_train_step_sparse_matches_jax(setup, d):
    x, j, groups = setup
    loss_j, docc_j, dalb_j = jpar.inverse_train_step_sparse(
        jpar.make_mesh(d), jnp.asarray(x["s_o"]), jnp.asarray(x["s_d"]),
        j["psc"], j["cellmap"], jnp.asarray(x["s_occ"]),
        jnp.asarray(x["s_alb"]), jnp.asarray(x["s_bg"]),
        jnp.asarray(x["s_tgt"]), JCFG.grid, k_segments=worker.K,
        interpret=True)
    got = _ranks(groups, d, "sparse_")
    np.testing.assert_allclose(float(got["loss"]), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(got["docc"], np.asarray(docc_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["dalb"], np.asarray(dalb_j), rtol=0,
                               atol=1e-5)
    assert np.abs(got["dalb"]).sum() > 0


def test_inverse_renderer_with_mesh_matches_jax(setup):
    x, _, groups = setup
    d = 4
    ir = JInverseRenderer(grid_shape=(8, 8, 8),
                          max_steps_per_ray=worker.DENSE_STEPS,
                          mesh=jpar.make_mesh(d))
    loss = ir.train_step(*(jnp.asarray(x[f"dense_{k}"])
                           for k in ("o", "d", "bg", "tgt")))
    got = _ranks(groups, d, "ir_")
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-6)
    np.testing.assert_allclose(got["occ"], np.asarray(ir.occupancy), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["alb"], np.asarray(ir.albedo), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12])
def test_device_counts_match_jax(n):
    assert tscaling._device_counts(n) == jscaling._device_counts(n)


def test_device_counts_cases():
    """The three cases of tests/test_scaling.py."""
    assert tscaling._device_counts(8) == [1, 2, 4, 8]
    assert tscaling._device_counts(6) == [1, 2, 4, 6]
    assert tscaling._device_counts(1) == [1]


def test_scaling_cli_distributed_two_processes(setup):
    procs = setup[2].scaling
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    recs = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert recs[0] == recs[1]
    out = recs[0]
    assert out["num_processes"] == 2 and out["platform"] == "cpu"
    assert out["device_counts"] == [1, 2] and len(out["rows"]) == 2
    assert out["resolution"] == [32, 16] and out["inverse_rays"] == 256
    # The keys of brickmap_tpu's run_scaling_benchmark rows.
    keys = {"devices", "forward_rays_per_s", "inverse_rays_per_s",
            "forward_efficiency_pct", "inverse_efficiency_pct"}
    r1 = out["rows"][0]
    for d, row in zip([1, 2], out["rows"]):
        assert set(row) == keys and row["devices"] == d
        assert row["forward_rays_per_s"] > 0 and row["inverse_rays_per_s"] > 0
        for k in ("forward", "inverse"):
            assert row[f"{k}_efficiency_pct"] == round(
                100.0 * (row[f"{k}_rays_per_s"]
                         / r1[f"{k}_rays_per_s"]) / d, 1)
    assert r1["forward_efficiency_pct"] == r1["inverse_efficiency_pct"] \
        == 100.0


@pytest.mark.cuda
def test_cuda_sharded_wave_world_size_one():
    """World size 1 over NCCL on the card: the sharded wave equals
    wave_for_indices on the same pixels and uniforms, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from brickmap_tpu_torch import scene as tscene
    from brickmap_tpu_torch.kernels import traverse as ktrav
    from brickmap_tpu_torch.parallel import render as par
    from brickmap_tpu_torch.render import pathtrace as tpt
    from brickmap_tpu_torch.render.sampling import draw_wave_uniforms

    x, _ = _problem()
    dev = torch.device("cuda")
    tscaling.init_single_process(dev)
    try:
        mesh = par.make_mesh(1)
        sc = tscene.scene_from_numpy(x["iv"], x["pw"], x["pb"], device=dev)
        arrays = {k[len("cam32x16_"):]: torch.from_numpy(v).to(dev)
                  for k, v in x.items() if k.startswith("cam32x16_")}
        cfg = worker.configs()
        u = draw_wave_uniforms(32 * 16, worker.BOUNCES,
                               torch.Generator(dev).manual_seed(0), dev)
        before = ktrav.trace.launches
        rgb, cnt, req = par.render_wave_sharded(
            mesh, sc, arrays, tuple(x["cam_brick"]), cfg, 32, 16, uniforms=u)
        assert ktrav.trace.launches > before
        rgb1, cnt1, req1 = tpt.wave_for_indices(
            sc, torch.arange(32 * 16, device=dev), arrays,
            tuple(x["cam_brick"]), cfg, 32, 16, uniforms=u)
        assert torch.equal(rgb, rgb1) and torch.equal(cnt, cnt1)
        assert torch.equal(req["mask"], req1["mask"])
        assert int(req["traced_rays"]) == int(req1["traced_rays"])
    finally:
        dist.destroy_process_group()
