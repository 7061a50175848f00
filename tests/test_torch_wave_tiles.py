"""The port's sample wave over more than one 128-pixel tile, against the JAX
package, at 136x40 (N = 5,440 lanes: two tile columns) on the world of
tests/test_torch_render.py, seed 4.

* The port's ``render_wave`` equals JAX's ``wave_for_indices`` over the same
  tile order (the JAX wave with no bucket ladder): counts, request mask,
  request positions and traced rays equal, rgb within rtol 1e-4.
* JAX's ``render_wave`` differs from both only on the lanes at or past
  floor(N / 1024) * 1024 = 5,120 of the tile order: its bounce 0 traces
  through the ladder's bucket of that size (``brickmap_tpu/render/
  pathtrace.py:261-266``), and the scatter drops the lanes past it, so they
  shade as sky.  This pins that fault of the reference, so that no parity
  test adopts it; the port traces every lane.

At this frame and seed no lane's path crosses a voxel corner, so the two
packages' paths agree lane for lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.config import BrickmapConfig as JConfig, \
    GridConfig as JGrid, RenderConfig as JRender
from brickmap_tpu.ops import sunsky as jss
from brickmap_tpu.render import pathtrace as jpt
from brickmap_tpu.render.camera import Camera as JCamera
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import BrickmapConfig, GridConfig, \
    RenderConfig
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.render import pathtrace as tpt
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for
from test_torch_render import jax_wave_uniforms

torch.set_num_threads(2)

W, H = 136, 40
N = W * H
BUCKET = N // 1024 * 1024          # 5,120: JAX's bounce-0 bucket
JCFG = JConfig(grid=JGrid(grid_size=128, grid_height=128),
               render=JRender(width=W, height=H, max_bounces=2,
                              max_top_steps=64))
TCFG = BrickmapConfig(grid=GridConfig(grid_size=128, grid_height=128),
                      render=RenderConfig(width=W, height=H, max_bounces=2,
                                          max_top_steps=64))


@pytest.fixture(scope="module")
def waves():
    """(port render_wave, JAX wave_for_indices, JAX render_wave), each as
    numpy (rgb, count, mask, pos, traced) in row-major pixel order, and the
    tile permutation."""
    sc = jscene.generate_terrain_scene(JCFG.grid, feature_scale=64.0)
    jsc = jscene.VoxelScene(index_volume=jnp.asarray(sc.index_volume),
                            pool_words=jnp.asarray(sc.pool_words),
                            pool_base=jnp.asarray(sc.pool_base))
    tsc = tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                  sc.pool_base, device="cpu")
    d = np.array([1.0, 1.0, -0.45])
    kw = dict(position=(20.0, 20.0, 100.0),
              direction=tuple(d / np.linalg.norm(d)))
    jcam, tcam = JCamera(**kw), Camera(**kw)
    jarr = jpt.camera_arrays_for(
        jcam, jss.sun_direction_from_position(jnp.asarray([0.05, 0.1])), W, H)
    tarr = camera_arrays_for(
        tcam, tss.sun_direction_from_position((0.05, 0.1), "cpu"), W, H,
        "cpu")
    key = jax.random.PRNGKey(4)
    cam_brick = jnp.asarray(jcam.brick_position, jnp.int32)
    perm, inv = jpt._tile_permutation(W, H)

    def as_np(rgb, count, req, order=None):
        out = [np.asarray(rgb), np.asarray(count), np.asarray(req["mask"]),
               np.asarray(req["pos"])]
        if order is not None:
            out = [a[order] for a in out]
        return out + [int(req["traced_rays"]), int(req["exhausted_rays"])]

    port = as_np(*tpt.render_wave(
        tsc, tarr, jcam.brick_position, TCFG, W, H,
        uniforms=jax_wave_uniforms(key, N, TCFG.render.max_bounces)))
    indices = as_np(*jpt.wave_for_indices(
        key, jnp.asarray(perm), jsc, jarr, cam_brick, JCFG, W, H), inv)
    ladder = as_np(*jpt.render_wave(key, jsc, jarr, cam_brick, JCFG, W, H))
    return port, indices, ladder, perm


def test_port_equals_jax_wave_for_indices(waves):
    port, indices, _, _ = waves
    np.testing.assert_allclose(port[0], indices[0], rtol=1e-4, atol=1e-5)
    for i in (1, 2, 3):
        np.testing.assert_array_equal(port[i], indices[i])
    assert port[4] == indices[4] > N
    assert port[5] == indices[5] == 0
    assert np.isfinite(port[0]).all()


def test_jax_render_wave_skips_lanes_past_its_bucket(waves):
    port, indices, ladder, perm = waves
    lanes = np.arange(N)
    past = np.zeros(N, bool)
    past[perm[lanes >= BUCKET]] = True        # pixels of the dropped lanes
    close = np.isclose(ladder[0], indices[0], rtol=1e-4, atol=1e-5).all(1)
    assert close[~past].all()
    assert not close[past].all()
    np.testing.assert_array_equal(ladder[2][~past], indices[2][~past])
    assert ladder[4] < indices[4]              # fewer rays traced
    assert not np.isclose(ladder[0], port[0], rtol=1e-4, atol=1e-5).all()
