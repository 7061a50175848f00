"""brickmap_tpu_torch.stream against brickmap_tpu.stream.

The port's counterparts of the non-paged cases of ``tests/test_stream.py``,
then the residency state after the same request sequences, bit for bit
against the JAX manager, a 3-wave cold-start streaming render against the
JAX wave, the ``render --streaming --metrics`` CLI and the streaming
benchmark, all on the CPU (the traversal is kernel B2's plain version).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene, stream as jstream
from brickmap_tpu.config import GridConfig as JGrid
from brickmap_tpu.render import pathtrace as jpt
from brickmap_tpu_torch import scene as tscene, stream as tstream
from brickmap_tpu_torch.app import benchmark, cli
from brickmap_tpu_torch.config import GridConfig, RenderConfig, \
    BrickmapConfig
from brickmap_tpu_torch.kernels.traverse import trace as ktrace
from brickmap_tpu_torch.render import pathtrace as tpt
from brickmap_tpu_torch.stream import StreamingScene, pull_requests
from test_torch_render import JCFG, TCFG, W, H, jax_wave_uniforms, \
    world  # noqa: F401  (a fixture)

torch.set_num_threads(2)

GRID = GridConfig(grid_size=128, grid_height=128)
JG = JGrid(grid_size=128, grid_height=128)
CAM = (0, 0, 0)


def port_scene(ref):
    """A JAX VoxelScene's arrays as a CPU TorchScene."""
    return tscene.scene_from_numpy(ref.index_volume, ref.pool_words,
                                   ref.pool_base, device="cpu")


@pytest.fixture(scope="module")
def box():
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    return tscene.scene_from_dense(dense, GRID, device="cpu")


def trace(sc, origins, dirs, grid=GRID):
    return ktrace(torch.as_tensor(origins, dtype=torch.float32),
                  torch.as_tensor(dirs, dtype=torch.float32), sc, CAM, grid,
                  512)


def requested(res):
    mask = res["request"]
    return [tuple(p) for p in res["request_pos"][mask].tolist()]


def converge(mgr, origins, dirs, grid=GRID, rounds=50):
    for _ in range(rounds):
        res = trace(mgr.device_scene(), origins, dirs, grid)
        if not res["request"].any():
            break
        if mgr.process_requests(requested(res)) == 0:
            break


def assert_same_state(port: StreamingScene, ref: jstream.StreamingScene):
    """The port's residency state equal to the JAX manager's, bit for bit."""
    st = port.state()
    dev = ref.device_scene()
    for k, want in (("index_volume", dev.index_volume),
                    ("pool_words", dev.pool_words),
                    ("pool_base", dev.pool_base),
                    ("capacity", ref.capacity), ("highest", ref.highest)):
        want = np.asarray(want)
        assert st[k].dtype == want.dtype and st[k].shape == want.shape, k
        np.testing.assert_array_equal(st[k], want, err_msg=k)
    assert st["total_uploaded"] == ref.total_uploaded
    assert st["total_dropped"] == ref.total_dropped


def rays_around(rng, n, center, dist):
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (np.asarray(center) - dirs * dist).astype(np.float32), dirs


# ---------------------------------------------------------------------------
# The port's counterparts of tests/test_stream.py
# ---------------------------------------------------------------------------

def test_round_trip_request_then_resident(box):
    mgr = StreamingScene(box, GRID, device="cpu")
    origins = np.array([[0.5, 64.0, 30.0]], np.float32)
    directions = np.array([[1.0, 0.0, 0.0]], np.float32)
    res = trace(mgr.device_scene(), origins, directions)
    assert bool(res["hit"][0]) and bool(res["request"][0])
    assert mgr.process_requests(requested(res)) == 1
    res2 = trace(mgr.device_scene(), origins, directions)
    assert bool(res2["hit"][0]) and not bool(res2["request"][0])
    assert abs(float(res2["t"][0]) - 31.5) < 1e-3


def test_progressive_residency_converges_to_truth(box, rng):
    mgr = StreamingScene(box, GRID, queue_size=64, device="cpu")
    origins, dirs = rays_around(rng, 256, [64, 64, 32], 100)
    want = trace(box, origins, dirs)
    converge(mgr, origins, dirs)
    res = trace(mgr.device_scene(), origins, dirs)
    assert torch.equal(res["hit"], want["hit"])
    np.testing.assert_allclose(res["t"].numpy(), want["t"].numpy(),
                               atol=1e-3)
    assert not res["request"].any()


def test_pool_growth_and_dump(box):
    mgr = StreamingScene(box, GRID, starting_capacity=4, device="cpu")
    reqs = [(x, y, 5) for x in range(4, 12) for y in range(4, 9)]
    assert mgr.process_requests(reqs) == 40
    assert mgr.capacity[0] == 64 and mgr.dump()[0] == 40
    sc = mgr.device_scene()
    assert sc.pool_words.shape[0] == 64
    truth_iv, truth_pool, truth_base = tscene.to_numpy(box)
    iv, pool, base = tscene.to_numpy(sc)
    for x, y, z in reqs:
        w = int(iv[z, y, x])
        assert w & 0x80000000
        tw = int(truth_iv[z, y, x])
        np.testing.assert_array_equal(pool[base[0] + (w & 0xFFF)],
                                      truth_pool[truth_base[0]
                                                 + (tw & 0xFFF)])


def test_queue_cap_drops_overflow(box):
    mgr = StreamingScene(box, GRID, queue_size=8, device="cpu")
    reqs = [(x, y, 5) for x in range(4, 12) for y in range(4, 9)]
    assert mgr.process_requests(reqs) == 8
    assert mgr.total_dropped == 32
    total = 8
    for _ in range(10):
        total += mgr.process_requests(reqs)
    assert total == 40 and mgr.total_uploaded == 40
    assert mgr.process_requests(reqs) == 0


def test_surface_only_requests_on_terrain(rng):
    """README.md:7: top-down views request no buried brick (all six face
    neighbours completely solid)."""
    truth = tscene.generate_terrain_scene(GRID, feature_scale=64.0,
                                          device="cpu")
    mgr = StreamingScene(truth, GRID, device="cpu")
    n = 400
    origins = np.stack([rng.uniform(5, 123, n), rng.uniform(5, 123, n),
                        np.full(n, 120.0)], 1).astype(np.float32)
    dirs = np.tile(np.array([[0.01, 0.01, -1.0]], np.float32), (n, 1))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    converge(mgr, origins, dirs, rounds=30)

    iv, _, _ = tscene.to_numpy(mgr.device_scene())
    loaded = np.argwhere((iv & 0x80000000) != 0)
    assert len(loaded) > 0
    t_iv, t_pool, t_base = tscene.to_numpy(truth)
    full = (t_pool == 0xFFFFFFFF).all(axis=1)

    def brick_full(z, y, x):
        w = int(t_iv[z, y, x])
        if not w & 0x80000000:
            return False
        s = GRID.supergrid_cell_size
        sc = x // s + (y // s) * GRID.supergrid_xy \
            + (z // s) * GRID.supergrid_xy ** 2
        return bool(full[t_base[sc] + (w & 0xFFF)])

    cz, cyx = t_iv.shape[0], t_iv.shape[1]
    for z, y, x in loaded:
        if 0 < z < cz - 1 and 0 < y < cyx - 1 and 0 < x < cyx - 1:
            assert not all(brick_full(*p) for p in [
                (z - 1, y, x), (z + 1, y, x), (z, y - 1, x),
                (z, y + 1, x), (z, y, x - 1), (z, y, x + 1)]), (x, y, z)
    assert mgr.surface_stats()["loaded_unreachable"] == 0


def test_streaming_parity_non_default_grid(rng):
    grid8 = GridConfig(grid_size=64, grid_height=64, supergrid_cell_size=8)
    dense = np.zeros((64, 64, 64), bool)
    dense[8:24, 16:48, 16:48] = rng.random((16, 32, 32)) < 0.6
    truth8 = tscene.scene_from_dense(dense, grid8, device="cpu")
    origins, dirs = rays_around(rng, 128, [32, 32, 16], 60)
    want = trace(truth8, origins, dirs, grid8)
    mgr = StreamingScene(truth8, grid8, queue_size=64, device="cpu")
    converge(mgr, origins, dirs, grid8)
    res = trace(mgr.device_scene(), origins, dirs, grid8)
    assert torch.equal(res["hit"], want["hit"])
    np.testing.assert_allclose(res["t"].numpy(), want["t"].numpy(),
                               atol=1e-3)
    assert not res["request"].any()
    assert mgr.dump().shape == (grid8.num_superchunks,)


def test_surface_only_invariant_reported(box, rng):
    mgr = StreamingScene(box, GRID, queue_size=64, device="cpu")
    origins, dirs = rays_around(rng, 256, [64, 64, 32], 100)
    converge(mgr, origins, dirs)
    s = mgr.surface_stats()
    assert s["loaded_total"] > 0
    assert s["loaded_unreachable"] == 0, s
    assert s["loaded_surface"] == s["loaded_total"]
    assert s["surface_total"] < s["nonempty_total"]
    assert not mgr.fully_resident()


def test_pull_requests_matches_full_pull(rng):
    """The compacted pull equal to the full host pull and to the JAX
    package's pull; beyond 4 * queue_size lanes the first ones in lane
    order; an empty mask and an empty wave give an empty list."""
    n = 8192
    mask = rng.random(n) < 0.01
    pos = rng.integers(0, 1000, (n, 3)).astype(np.int32)

    def both(m, p, q):
        got = pull_requests({"mask": torch.from_numpy(m),
                             "pos": torch.from_numpy(p)}, queue_size=q)
        assert got == jstream.pull_requests(
            {"mask": jnp.asarray(m), "pos": jnp.asarray(p)}, queue_size=q)
        return got

    assert both(mask, pos, 1024) == [tuple(int(v) for v in r)
                                     for r in pos[mask]]
    got = both(np.ones(n, bool), pos, 16)
    assert got == [tuple(int(v) for v in r) for r in pos[:64]]
    spread = np.zeros(n, bool)
    spread[rng.choice(n, 300, replace=False)] = True
    assert both(spread, pos, 16) == [tuple(int(v) for v in r)
                                     for r in pos[spread][:64]]
    assert both(np.zeros(n, bool), pos, 1024) == []
    assert pull_requests({"mask": torch.zeros(0, dtype=torch.bool),
                          "pos": torch.zeros((0, 3), dtype=torch.int32)},
                         queue_size=4) == []
    total, rows, valid = tstream.compact_requests(
        torch.from_numpy(spread), torch.from_numpy(pos), 512)
    assert int(total) == 300 and int(valid.sum()) == 300
    assert rows.shape == (512, 3) and rows.dtype == torch.int32


# ---------------------------------------------------------------------------
# Residency state against the JAX manager
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def terrain4():
    """A 256^2 x 128 terrain: four superchunks of 16^3 bricks."""
    jg = JGrid(grid_size=256, grid_height=128)
    return jg, jscene.generate_terrain_scene(jg, feature_scale=64.0)


def request_sequences(rng, iv, waves, per_wave):
    """Per wave: random non-empty bricks with repeats, empty cells, and
    bricks requested in earlier waves (already resident or dropped)."""
    nonempty = np.argwhere((iv & np.uint32(0xE000_0000)) != 0)[:, ::-1]
    empty = np.argwhere((iv & np.uint32(0xE000_0000)) == 0)[:, ::-1]
    seqs, earlier = [], []
    for _ in range(waves):
        fresh = nonempty[rng.integers(0, len(nonempty), per_wave)]
        reqs = [tuple(int(v) for v in p) for p in fresh]
        reqs += reqs[: per_wave // 4]
        reqs += [tuple(int(v) for v in p)
                 for p in empty[rng.integers(0, len(empty), 20)]]
        reqs += earlier[: per_wave // 3]
        order = rng.permutation(len(reqs))
        seqs.append([reqs[i] for i in order])
        earlier = reqs
    return seqs


@pytest.mark.parametrize("queue_size,starting_capacity,per_wave", [
    (1024, 16, 300),     # the defaults: growth of several segments a batch
    (64, 16, 300),       # the cap binds: drops, retried later
    (256, 4, 500),       # a small start: many doublings, global re-pads
])
def test_state_matches_jax(terrain4, rng, queue_size, starting_capacity,
                           per_wave):
    jg, ref = terrain4
    tg = GridConfig(grid_size=256, grid_height=128)
    jm = jstream.StreamingScene(ref, jg, queue_size=queue_size,
                                starting_capacity=starting_capacity)
    tm = StreamingScene(port_scene(ref), tg, queue_size=queue_size,
                        starting_capacity=starting_capacity, device="cpu")
    assert_same_state(tm, jm)
    grew_multi = False
    for reqs in request_sequences(rng, np.asarray(ref.index_volume), 6,
                                  per_wave):
        before = tm.capacity.copy()
        assert tm.process_requests(reqs) == jm.process_requests(reqs)
        grew_multi |= int((tm.capacity > before).sum()) > 1
        assert_same_state(tm, jm)
    assert grew_multi
    assert tm.total_uploaded == int(tm.dump().sum())
    if queue_size == 64:
        assert tm.total_dropped > 0


def test_surface_stats_matches_jax(terrain4, rng):
    jg, ref = terrain4
    tg = GridConfig(grid_size=256, grid_height=128)
    jm = jstream.StreamingScene(ref, jg, queue_size=512)
    tm = StreamingScene(port_scene(ref), tg, queue_size=512, device="cpu")
    assert tm.surface_stats() == jm.surface_stats()
    for reqs in request_sequences(rng, np.asarray(ref.index_volume), 3, 400):
        jm.process_requests(reqs)
        tm.process_requests(reqs)
    s = tm.surface_stats()
    assert s == jm.surface_stats()
    assert s["loaded_total"] == tm.total_uploaded > 0
    assert tm.fully_resident() == jm.fully_resident() is False


def test_plan_rejects_requests_outside_the_grid(box):
    mgr = StreamingScene(box, GRID, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        mgr.process_requests([(16, 0, 0)])
    with pytest.raises(ValueError, match="outside"):
        mgr.process_requests([(0, -1, 0)])
    assert mgr.total_uploaded == 0


# ---------------------------------------------------------------------------
# The slice as a whole: a cold-start streaming render, the CLI, the benchmark
# ---------------------------------------------------------------------------

def test_streaming_render_matches_jax(world):  # noqa: F811
    """Three cold-start waves over the tests/test_torch_render.py world
    (queue_size 64, so 4 * 64 request lanes of the 768 are pulled): the
    port's wave against the JAX wave on the JAX manager's scene, then both
    pulls and both servicings."""
    jsc, tsc, jcam, jarr, tarr = world
    ref = jscene.VoxelScene(index_volume=np.asarray(jsc.index_volume),
                            pool_words=np.asarray(jsc.pool_words),
                            pool_base=np.asarray(jsc.pool_base))
    jm = jstream.StreamingScene(ref, JCFG.grid, queue_size=64,
                                starting_capacity=256)
    tm = StreamingScene(tsc, TCFG.grid, queue_size=64, starting_capacity=256,
                        device="cpu")
    cam = jnp.asarray(jcam.brick_position, jnp.int32)
    for wave in range(3):
        key = jax.random.PRNGKey(20 + wave)
        d = jm.device_scene()
        rgb_j, _, req_j = jpt.render_wave(
            key, jscene.VoxelScene(d.index_volume, d.pool_words,
                                   d.pool_base), jarr, cam, JCFG, W, H)
        rgb_t, _, req_t = tpt.render_wave(
            tm.device_scene(), tarr, jcam.brick_position, TCFG, W, H,
            uniforms=jax_wave_uniforms(key, W * H, TCFG.render.max_bounces))
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(req_t["mask"].numpy(),
                                      np.asarray(req_j["mask"]))
        got_t = pull_requests(req_t, tm.queue_size)
        got_j = jstream.pull_requests(req_j, jm.queue_size)
        assert got_t == got_j
        if wave == 0:
            assert int(req_t["mask"].sum()) > 4 * tm.queue_size
            assert len(got_t) == 4 * tm.queue_size
        assert tm.process_requests(got_t) == jm.process_requests(got_j)
        assert_same_state(tm, jm)
    assert tm.total_uploaded > 64


def test_cli_render_streaming_metrics(tmp_path, capsys):
    m = tmp_path / "m.jsonl"
    out = tmp_path / "r.png"
    assert cli.main(["render", "--device", "cpu", "--out", str(out),
                     "--width", "24", "--height", "16", "--spp", "3",
                     "--bounces", "1", "--world", "128", "--world-height",
                     "128", "--max-steps", "64", "--camera", "20", "20",
                     "100", "--look", "64", "64", "40", "--streaming",
                     "--metrics", str(m), "--engine", "xla"]) == 0
    cap = capsys.readouterr()
    lines = [ln for ln in cap.err.splitlines() if ln.startswith("streaming:")]
    assert len(lines) == 2 and "0 unreachable" in lines[1]
    recs = [json.loads(ln) for ln in m.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert {"wave_s", "traced", "mrays_s", "uploads",
                "exhausted"} <= set(r)
        assert r["exhausted"] == 0 and r["traced"] >= 24 * 16
    assert recs[0]["uploads"] > 0
    resident = int(lines[0].split()[1])
    assert resident == sum(r["uploads"] for r in recs)
    assert json.loads(cap.out.strip().splitlines()[-1])["waves"] == 3
    assert out.read_bytes().startswith(b"\x89PNG")


def test_run_streaming_benchmark_on_cpu():
    """The benchmark at a tiny size, from a viewpoint (4, looking in from
    outside) whose waves fill the queue: drops and segment growth.  Its
    request lists replayed into the JAX manager end in the same state."""
    cfg = BrickmapConfig(grid=GRID, render=RenderConfig(
        width=24, height=16, max_bounces=1, max_top_steps=64))
    truth = tscene.generate_terrain_scene(GRID, feature_scale=64.0,
                                          device="cpu")
    seen = []
    out = benchmark.run_streaming_benchmark(
        truth, cfg, view=4, width=24, height=16, waves=4, queue_size=32,
        starting_capacity=16, device="cpu",
        on_wave=lambda i, row, reqs: seen.append((i, row, reqs)))
    rows = out["per_wave"]
    assert out["waves"] == len(rows) == len(seen) == 4
    assert out["device"] == "cpu" and out["mrays_during_convergence"] > 0
    assert out["bricks_uploaded"] == sum(r["uploads"] for r in rows) > 0
    assert out["upload_bricks_per_s"] > 0
    for r in rows:
        assert r["exhausted"] == 0 and r["uploads"] <= 32
        assert r["requests"] <= 4 * 32 and r["traced"] >= 24 * 16
        assert {"wave_ms", "pull_ms", "plan_ms", "install_ms", "dropped",
                "grew", "pool_rows"} <= set(r)
    assert any(r["grew"] for r in rows) and any(r["dropped"] for r in rows)
    mgr = out["manager"]
    iv, _, _ = tscene.to_numpy(mgr.device_scene())
    assert mgr.total_uploaded == int(mgr.dump().sum()) \
        == int(((iv & 0x80000000) != 0).sum())
    ref = jscene.VoxelScene(*tscene.to_numpy(truth))
    jm = jstream.StreamingScene(ref, JG, queue_size=32, starting_capacity=16)
    for _, _, reqs in seen:
        jm.process_requests(reqs)
    assert_same_state(mgr, jm)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_manager_matches_cpu(terrain4, rng, cuda_device):
    """A manager on the card against one on the CPU, same requests."""
    jg, ref = terrain4
    tg = GridConfig(grid_size=256, grid_height=128)
    truth = port_scene(ref)
    gpu = StreamingScene(truth.to(cuda_device), tg, queue_size=64,
                         starting_capacity=4, device=cuda_device)
    cpu = StreamingScene(truth, tg, queue_size=64, starting_capacity=4,
                         device="cpu")
    for reqs in request_sequences(rng, np.asarray(ref.index_volume), 5, 300):
        assert gpu.process_requests(reqs) == cpu.process_requests(reqs)
        a, b = gpu.state(), cpu.state()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert gpu.device_scene().device.type == "cuda"
