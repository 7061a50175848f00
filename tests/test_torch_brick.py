"""Kernel B1 (brick DDA) of brickmap_tpu_torch against the JAX package.

On the CPU the port's wrapper runs B1's plain version; it is held against the
Pallas kernel in interpret mode and the scalar oracle on the cases of
tests/test_pallas_brick.py.  The ``cuda`` test holds the CUDA kernel against
the plain version on the card.
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


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_brick_matches_plain(cuda_device, rng):
    n = 1 << 16
    for density in (0.1, 0.5):
        occ = torch.from_numpy(rng.random((8, 8, 8)) < density).to(
            cuda_device)
        words = tbits.brick_words_from_dense(occ)
        o = torch.from_numpy(rng.uniform(-0.1, 8.1, (n, 3)).astype(
            np.float32)).to(cuda_device)
        d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(
            cuda_device)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        before = kbrick.trace_single_brick.launches
        got = kbrick.trace_single_brick(o, d, words)
        assert kbrick.trace_single_brick.launches == before + 1
        hit, t, axis, _ = kbrick.intersect_brick_plain(words, o, d)
        assert torch.equal(got["hit"], hit)
        assert torch.equal(got["axis"], axis)
        assert float((got["t"] - t).abs().max()) <= 1e-4
