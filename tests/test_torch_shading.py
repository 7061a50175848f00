"""Shading inputs of brickmap_tpu_torch against the JAX package: the sun/sky
model, the samplers given the JAX samplers' own uniforms, and primary rays.

JAX draws its uniforms from threefry keys inside each sampler; the helpers
here replay the same key splits with ``jax.random`` and hand the draws to the
port's transforms, which must then agree to float rounding.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu.config import SunSkyConfig as JSky
from brickmap_tpu.ops import sunsky as jss
from brickmap_tpu.render import camera as jcam, sampling as jsamp
from brickmap_tpu_torch.config import SunSkyConfig
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.render import camera as tcam, sampling as tsamp
from test_sunsky import GOLD_VIEWS, SKY_GOLD, SUN_GOLD, SUNSKY_GOLD

torch.set_num_threads(2)

SUN_J = jss.sun_direction_from_position(jnp.asarray([0.05, 0.1]))
SUN_T = tss.sun_direction_from_position((0.05, 0.1), "cpu")


def direction_grid(n_theta=24, n_phi=48):
    th = np.linspace(0.01, math.pi - 0.01, n_theta)
    ph = np.linspace(0.0, 2 * math.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    d = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)],
                 -1).reshape(-1, 3)
    return np.concatenate([d, np.asarray(SUN_J)[None]]).astype(np.float32)


def test_sun_direction_matches_jax():
    np.testing.assert_allclose(SUN_T.numpy(), np.asarray(SUN_J), rtol=1e-6,
                               atol=1e-7)
    for pos in ((0.3, 0.2), (0.9, 0.45)):
        np.testing.assert_allclose(
            tss.sun_direction_from_position(pos, "cpu").numpy(),
            np.asarray(jss.sun_direction_from_position(jnp.asarray(pos))),
            rtol=1e-6, atol=1e-7)
    assert tss.cone_extent(SunSkyConfig()) == jss.cone_extent(JSky())


@pytest.mark.parametrize("fn", ["sun", "sky", "sunsky"])
@pytest.mark.parametrize("cfg", [{}, {"sky_factor": 2.0, "turbidity": 2.0}])
def test_radiance_matches_jax(fn, cfg):
    dirs = direction_grid()
    ref = np.asarray(getattr(jss, fn)(jnp.asarray(dirs), SUN_J, JSky(**cfg)))
    got = getattr(tss, fn)(torch.from_numpy(dirs), SUN_T,
                           SunSkyConfig(**cfg)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)


def test_radiance_goldens():
    """The frozen reference-formula values of tests/test_sunsky.py."""
    views = np.stack([np.asarray(SUN_J, np.float64) if v is None
                      else np.asarray(v, np.float64) for v in GOLD_VIEWS])
    dirs = torch.from_numpy(views.astype(np.float32))
    np.testing.assert_allclose(tss.sky(dirs, SUN_T).numpy(), SKY_GOLD,
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(tss.sunsky(dirs, SUN_T).numpy(), SUNSKY_GOLD,
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(tss.sun(dirs, SUN_T).numpy(), SUN_GOLD,
                               rtol=2e-4, atol=1e-7)


def t(a):
    return torch.from_numpy(np.array(a))


def test_stratified_2d_matches_jax():
    key = jax.random.PRNGKey(11)
    n = 4096
    ref = np.asarray(jsamp.stratified_2d(key, n))
    ka, kb = jax.random.split(key)
    got = tsamp.stratified_2d(t(jax.random.randint(ka, (n,), 0, 16)),
                              t(jax.random.uniform(kb, (n, 2))))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_concentric_disk_matches_jax(rng):
    u = rng.random((4096, 2)).astype(np.float32)
    u[:4] = [[0.5, 0.5], [0.5, 0.9], [0.1, 0.5], [0.0, 1.0]]
    np.testing.assert_allclose(tsamp.concentric_disk(t(u)).numpy(),
                               np.asarray(jsamp.concentric_disk(
                                   jnp.asarray(u))), atol=1e-6, rtol=0)


def test_cosine_hemisphere_matches_jax(rng):
    key = jax.random.PRNGKey(12)
    nrm = rng.normal(size=(4096, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[:6] = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    ref = np.asarray(jsamp.cosine_hemisphere(key, jnp.asarray(nrm)))
    k1, k2 = jax.random.split(key)
    got = tsamp.cosine_hemisphere(t(jax.random.uniform(k1, (4096,))),
                                  t(jax.random.uniform(k2, (4096,))), t(nrm))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert ((got * t(nrm)).sum(1) >= -1e-6).all()


def test_cone_sample_matches_jax():
    key = jax.random.PRNGKey(13)
    ext = jss.cone_extent(JSky())
    n = 4096
    ref = np.asarray(jsamp.cone_sample(key, SUN_J, ext, shape=(n,)))
    k1, k2 = jax.random.split(key)
    got = tsamp.cone_sample(t(jax.random.uniform(k1, (n,))),
                            t(jax.random.uniform(k2, (n,))), SUN_T, ext)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_ortho_vector_and_basis_match_jax(rng):
    v = rng.normal(size=(512, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    np.testing.assert_array_equal(tsamp.ortho_vector(t(v)).numpy(),
                                  np.asarray(jsamp.ortho_vector(
                                      jnp.asarray(v))))
    for a, b in zip(tsamp.orthonormal_basis(t(v)),
                    jsamp.orthonormal_basis(jnp.asarray(v))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("lens_radius", [0.0, 0.5])
def test_primary_rays_match_jax(lens_radius):
    w, h = 40, 24
    d = np.array([0.3, 0.9, -0.2])
    kw = dict(position=(30.0, 20.0, 90.0), direction=tuple(d / np.linalg.norm(d)),
              lens_radius=lens_radius, focal_distance=2.0)
    jc, tc = jcam.Camera(**kw), tcam.Camera(**kw)
    ja = jcam.camera_arrays_for(jc, SUN_J, w, h)
    ta = tcam.camera_arrays_for(tc, SUN_T, w, h, "cpu")
    for k in ja:
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    key = jax.random.PRNGKey(14)
    idx = np.random.default_rng(0).permutation(w * h).astype(np.int32)
    ro, rd = jcam.primary_rays_from_arrays(key, ja, jnp.asarray(idx), w, h)
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    n = w * h
    o, dd = tcam.primary_rays_from_arrays(
        t(jax.random.randint(ka, (n,), 0, 16)),
        t(jax.random.uniform(kb, (n, 2))), t(jax.random.uniform(k2, (n, 2))),
        ta, t(idx), w, h)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=1e-6,
                               atol=1e-5)
    # dirs = (position + 3 * to_focal) - origins cancels ~5 bits at this
    # camera position (|p| ~ 90 against a step of 3): a rounding difference
    # of half an ulp of 90 (3.8e-6) in either frame moves a unit direction
    # by ~1.3e-6, so the tolerance is 4e-6, not the samplers' 1e-6.
    np.testing.assert_allclose(dd.numpy(), np.asarray(rd), atol=4e-6, rtol=0)
    assert tc.brick_position == jc.brick_position


def test_camera_from_angles_matches_jax():
    for pos, (hz, vt) in (((512.0, 512.0, 300.0), (-61863.5, -0.501796)),
                          ((11298.6, 3113.03, 598.019), (-61866.3, -0.14))):
        a = tcam.Camera.from_angles(pos, hz, vt)
        b = jcam.Camera.from_angles(pos, hz, vt)
        assert a.position == b.position and a.direction == b.direction
        np.testing.assert_array_equal(tcam.camera_basis(a, 1920, 1080),
                                      jcam.camera_basis(b, 1920, 1080))


def test_draw_wave_uniforms_shapes_and_ranges():
    g = torch.Generator().manual_seed(3)
    u = tsamp.draw_wave_uniforms(1000, 3, g, "cpu")
    assert u["stratum"].shape == (1000,) and u["cone"].shape == (4, 2, 1000)
    assert u["hemi"].shape == (4, 2, 1000) and u["lens"].shape == (1000, 2)
    assert 0 <= int(u["stratum"].min()) and int(u["stratum"].max()) < 16
    for k in ("jitter", "lens", "cone", "hemi"):
        assert float(u[k].min()) >= 0.0 and float(u[k].max()) < 1.0
    again = tsamp.draw_wave_uniforms(1000, 3,
                                     torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(u[k], again[k]) for k in u)
