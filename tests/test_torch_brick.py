"""Kernel B1 (brick DDA) of brickmap_tpu_torch against the JAX package.

On the CPU the port's wrapper runs B1's plain version; it is held against the
Pallas kernel in interpret mode and the scalar oracle on the cases of
tests/test_pallas_brick.py, and on the rays of bench.py's brick stage.  The
``cuda`` test holds the CUDA kernel against the plain version on the card,
every output equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import bits as jbits
from brickmap_tpu.ops import dda_ref, sunsky as jss
from brickmap_tpu.pallas.brick import trace_single_brick as jax_brick
from brickmap_tpu.pallas.single_brick import render_single_brick as jax_render
from brickmap_tpu.render.camera import Camera as JCamera
from brickmap_tpu_torch import bits as tbits
from brickmap_tpu_torch.app import benchmark
from brickmap_tpu_torch.kernels import brick as kbrick
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.render.camera import Camera
from brickmap_tpu_torch.single_brick import render_single_brick

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def brick():
    rng = np.random.default_rng(103)
    dense = rng.random((8, 8, 8)) < 0.12  # [z, y, x]
    dense[4, 3, 2] = True
    words = np.asarray(jbits.brick_words_from_dense(dense[None])[0],
                       np.uint32)
    return dense, words


def jax_primary_uniforms(key, n):
    """The draws of brickmap_tpu primary_rays_from_arrays (camera.py:93-108,
    stratified_2d sampling.py:40-44) for ``key``, as numpy."""
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    return {"stratum": np.asarray(jax.random.randint(ka, (n,), 0, 16)),
            "jitter": np.asarray(jax.random.uniform(kb, (n, 2))),
            "lens": np.asarray(jax.random.uniform(k2, (n, 2)))}


def to_torch(u):
    return {k: torch.from_numpy(np.array(v)) for k, v in u.items()}


def run_all(words, origins, dirs):
    """(port, Pallas interpret, oracle list) on the same rays."""
    port = kbrick.trace_single_brick(torch.from_numpy(origins),
                                     torch.from_numpy(dirs),
                                     torch.from_numpy(words.view(np.int32)))
    pallas = jax_brick(jnp.asarray(origins), jnp.asarray(dirs),
                       jnp.asarray(words), interpret=True)
    oracle = [dda_ref.intersect_brick(o, d, words, np.zeros(3, np.float32))
              for o, d in zip(origins, dirs)]
    return port, pallas, oracle


def assert_match(port, pallas, oracle, dirs):
    hit, t, axis = (port[k].numpy() for k in ("hit", "t", "axis"))
    np.testing.assert_array_equal(hit, np.asarray(pallas["hit"]))
    np.testing.assert_array_equal(axis, np.asarray(pallas["axis"]))
    np.testing.assert_allclose(t, np.asarray(pallas["t"]), atol=1e-4)
    for i, (h, normal, dist) in enumerate(oracle):
        assert bool(hit[i]) == h, i
        if h:
            np.testing.assert_allclose(t[i], dist, atol=1e-4, err_msg=str(i))
            want = np.zeros(3)
            if axis[i] >= 0:
                want[axis[i]] = -np.sign(dirs[i][axis[i]])
            np.testing.assert_allclose(normal, want, atol=1e-6)


def test_brick_matches_jax_random(brick, rng):
    _, words = brick
    n = 300
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    start = (np.array([4.0, 4.0, 4.0]) - dirs * 20.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        t1 = (0.0 - start) / dirs
        t2 = (8.0 - start) / dirs
    tenter = np.minimum(t1, t2).max(axis=1) + 1e-3
    origins = (start + dirs * tenter[:, None]).astype(np.float32)
    inside = ((origins > 0) & (origins < 8)).all(axis=1)
    origins, dirs = origins[inside][:257], dirs[inside][:257]
    assert_match(*run_all(words, origins, dirs), dirs)


def test_brick_matches_jax_axis_aligned(brick):
    _, words = brick
    origins, dirs = [], []
    for axis in range(3):
        for sign in (1, -1):
            for a in range(8):
                for b in range(8):
                    o = [a + 0.5, b + 0.5]
                    o.insert(axis, 0.01 if sign > 0 else 7.99)
                    d = [0.0, 0.0]
                    d.insert(axis, float(sign))
                    origins.append(o)
                    dirs.append(d)
    origins = np.asarray(origins, np.float32)
    dirs = np.asarray(dirs, np.float32)
    assert_match(*run_all(words, origins, dirs), dirs)


def test_brick_matches_jax_inside_start(brick, rng):
    _, words = brick
    origins = rng.uniform(0.05, 7.95, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    assert_match(*run_all(words, origins, dirs), dirs)


@pytest.mark.parametrize("fill", [0, 0xFFFFFFFF])
def test_brick_empty_and_full(fill):
    words = np.full(16, fill, np.uint32)
    o = np.array([[0.01, 4.0, 4.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0]], np.float32)
    port, pallas, oracle = run_all(words, o, d)
    assert_match(port, pallas, oracle, d)
    assert bool(port["hit"][0]) == bool(fill)
    if fill:
        assert float(port["t"][0]) == 0.0  # entry-cell hit


def test_render_single_brick_matches_jax(brick):
    dense, words = brick
    w, h = 48, 40
    d = np.array([10.0, 9.0, -8.0])
    d /= np.linalg.norm(d)
    jcam = JCamera(position=(-6.0, -5.0, 12.0), direction=tuple(d))
    cam = Camera(position=(-6.0, -5.0, 12.0), direction=tuple(d))
    jsun = jss.sun_direction_from_position(jnp.asarray([0.05, 0.1]))
    key = jax.random.PRNGKey(0)
    rgb_j, hit_j = jax_render(jnp.asarray(words), jcam, w, h, jsun, key=key,
                              interpret=True)
    rgb_t, hit_t = render_single_brick(
        torch.from_numpy(words.view(np.int32)), cam, w, h,
        tss.sun_direction_from_position((0.05, 0.1), "cpu"),
        uniforms=to_torch(jax_primary_uniforms(key, w * h)), device="cpu")
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    assert hit_t.any() and not hit_t.all()
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-5,
                               atol=1e-6)


def test_wrapper_refuses_other_devices(brick):
    _, words = brick
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        kbrick.trace_single_brick(o, o, torch.zeros(16, dtype=torch.int32,
                                                    device="meta"))


def bench_recipe(n):
    """bench.py::_pallas_brick_bench's inputs (bench.py:538-549), repeated
    here in numpy: words uint32 [16], origins and dirs float32 [n, 3]."""
    rng = np.random.default_rng(0)
    dense = rng.random((8, 8, 8)) < 0.12
    words = np.asarray(jbits.brick_words_from_dense(dense[None])[0],
                       np.uint32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    start = np.array([4.0, 4.0, 4.0]) - dirs * 20
    with np.errstate(divide="ignore"):
        tenter = np.minimum((0.0 - start) / dirs,
                            (8.0 - start) / dirs).max(1) + 1e-3
    origins = (start + dirs * tenter[:, None]).astype(np.float32)
    return words, origins, dirs


def test_brick_benchmark_rays_equal_bench_recipe():
    words, origins, dirs = benchmark.brick_benchmark_rays(4096)
    w_ref, o_ref, d_ref = bench_recipe(4096)
    assert words.dtype == np.uint32 and origins.dtype == np.float32
    np.testing.assert_array_equal(words, w_ref)
    np.testing.assert_array_equal(origins.view(np.int32),
                                  o_ref.view(np.int32))
    np.testing.assert_array_equal(dirs.view(np.int32), d_ref.view(np.int32))


def test_brick_plain_matches_pallas_on_bench_rays():
    words, origins, dirs = benchmark.brick_benchmark_rays(4096)
    hit, t, axis, steps = kbrick.intersect_brick_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(origins),
        torch.from_numpy(dirs))
    ref = jax_brick(jnp.asarray(origins), jnp.asarray(dirs),
                    jnp.asarray(words), interpret=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref["hit"]))
    np.testing.assert_array_equal(axis.numpy(), np.asarray(ref["axis"]))
    np.testing.assert_allclose(t.numpy(), np.asarray(ref["t"]), rtol=0,
                               atol=1e-6)
    assert 0 < int(hit.sum()) < 4096 and int(steps.max()) <= kbrick.MAX_STEPS


def test_run_brick_benchmark_on_cpu():
    out = benchmark.run_brick_benchmark(device="cpu", n=4096, calls=2)
    assert set(out) == {"brick_mrays_per_s", "call_ms", "wrapper_host_ms",
                        "kernel_ms", "rays", "hits", "device"}
    assert out["rays"] == 4096 and out["device"] == "cpu"
    assert out["kernel_ms"] is None  # no kernel runs on the CPU
    assert out["brick_mrays_per_s"] > 0 and out["wrapper_host_ms"] > 0
    w, o, d = benchmark.brick_benchmark_rays(4096)
    assert out["hits"] == int(kbrick.intersect_brick_plain(
        torch.from_numpy(w.view(np.int32)), torch.from_numpy(o),
        torch.from_numpy(d))[0].sum())


@pytest.mark.parametrize("n", [1, 3, 5])
def test_wrapper_on_cpu_small_n(brick, n):
    _, words = brick
    w_np, origins, dirs = benchmark.brick_benchmark_rays(64)
    o, d = origins[:n], dirs[:n]
    port = kbrick.trace_single_brick(torch.from_numpy(o),
                                     torch.from_numpy(d),
                                     torch.from_numpy(words.view(np.int32)))
    ref = jax_brick(jnp.asarray(o), jnp.asarray(d), jnp.asarray(words),
                    interpret=True)
    assert all(port[k].shape == (n,) for k in ("hit", "t", "axis"))
    np.testing.assert_array_equal(port["hit"].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_array_equal(port["axis"].numpy(),
                                  np.asarray(ref["axis"]))
    np.testing.assert_allclose(port["t"].numpy(), np.asarray(ref["t"]),
                               rtol=0, atol=1e-6)


def test_wrapper_on_cpu_offset_view(brick):
    _, words = brick
    _, origins, dirs = benchmark.brick_benchmark_rays(257)
    o_all, d_all = torch.from_numpy(origins), torch.from_numpy(dirs)
    w = torch.from_numpy(words.view(np.int32))
    full = kbrick.trace_single_brick(o_all, d_all, w)
    view = kbrick.trace_single_brick(o_all[1:], d_all[1:], w)
    for k in ("hit", "t", "axis"):
        assert torch.equal(view[k], full[k][1:]), k


@pytest.mark.parametrize("rays", [1, 65536, 1 << 20, 1 << 21, 1 << 23])
def test_hbm_copies_exceed_twice_the_l2(monkeypatch, rays):
    """B1's timed launches take enough copies of their rays (33 B a ray)
    that together they hold more than twice the H100's 50 MiB L2."""
    props = type("Props", (), {"L2_cache_size": 50 << 20})()
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: props)
    copies = benchmark.hbm_copies(33 * rays, "cuda")
    assert copies * 33 * rays > 2 * (50 << 20)
    assert (copies - 1) * 33 * rays <= 2 * (50 << 20)  # no more than needed


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_brick_matches_plain(cuda_device, rng):
    n = 1 << 16
    # the threads resident at 1..8 blocks of 256 an SM: B1's persistent
    # grid takes a second pass past one of them
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    resident = [sms * 256 * k for k in range(1, 9)]
    o_e, d_e = benchmark.brick_edge_rays(resident[-1] + 1)
    o_e = torch.from_numpy(o_e).to(cuda_device)
    d_e = torch.from_numpy(d_e).to(cuda_device)
    for density in (0.1, 0.5):
        occ = torch.from_numpy(rng.random((8, 8, 8)) < density).to(
            cuda_device)
        words = tbits.brick_words_from_dense(occ)
        o = torch.from_numpy(rng.uniform(-0.1, 8.1, (n, 3)).astype(
            np.float32)).to(cuda_device)
        d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(
            cuda_device)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        cases = [(o, d), (o[1:], d[1:]), (o_e, d_e)]
        cases += [(o_e[:m], d_e[:m]) for m in (
            1, 3, 4, 5, 1023, 1025, *(r + e for r in resident
                                      for e in (-1, 1)))]
        for oo, dd in cases:
            before = kbrick.trace_single_brick.launches
            got = kbrick.trace_single_brick(oo, dd, words)
            assert kbrick.trace_single_brick.launches == before + 1
            hit, t, axis, _ = kbrick.intersect_brick_plain(words, oo, dd)
            assert torch.equal(got["hit"], hit), oo.shape[0]
            assert torch.equal(got["axis"], axis), oo.shape[0]
            # t bit for bit (NaN where both are NaN: edge rays with a
            # denormal direction reach 0 * inf)
            same = (got["t"].view(torch.int32) == t.view(torch.int32)) | (
                got["t"].isnan() & t.isnan())
            assert bool(same.all()), oo.shape[0]


@pytest.mark.cuda
def test_cuda_brick_rcp_matches_ieee(cuda_device):
    """The padded walk's reciprocal rounds as IEEE ``1 / d`` on every float
    of +-[2^-126, 2^126), the range the walk takes: its ``t`` then equals
    the plain version's."""
    assert kbrick.rcp_mismatches(cuda_device) == 0
