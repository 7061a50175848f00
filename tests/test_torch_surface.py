"""The port's public surface against the JAX package's: for every module
of ``brickmap_tpu`` with a counterpart in ``brickmap_tpu_torch``, each name
of the JAX ``__all__`` is in the port's, apart from the names the port
leaves out by choice (ROADMAP.md §A, "No counterpart, by choice"); every
name a port ``__all__`` lists exists; and the package re-exports what
``brickmap_tpu/__init__.py`` does.
"""

import importlib

import pytest

import brickmap_tpu
import brickmap_tpu_torch

# JAX names with no counterpart in the port, and why.
LEFT_OUT = {
    "diff.render": {"render_image"},       # a one-line alias
    "noise": {"simplex2_scalar"},          # a test oracle
    "ops.traverse": {"trace_rays_blocked"},  # a TPU mechanism
    "scene": {"VoxelScene"},               # a JAX pytree; TorchScene here
    "utils.debug": {"pallas_interpret",    # no interpreter to force
                    "enable_x64_guard"},   # torch has no global x64 mode
    "render.pathtrace": {"Film"},          # listed, but defined nowhere
    "pallas.brick": {"intersect_brick_tiles"},  # the TPU's (8, 128) tiles
}
MODULES = ["app.benchmark", "app.cli", "app.scaling", "bits", "config",
           "diff.optim", "diff.render", "diff.sparse", "native", "noise",
           "ops.sunsky", "ops.traverse", "parallel.render",
           "render.camera", "render.pathtrace", "render.sampling", "scene",
           "stream", "utils.debug", "utils.image", "utils.metrics",
           "utils.preview", "utils.profiling"]
# The Pallas kernels' modules: their counterparts live under kernels/.
RENAMED = {"pallas.brick": "kernels.brick", "pallas.record": "kernels.record",
           "pallas.single_brick": "single_brick"}


@pytest.mark.parametrize("name", MODULES + sorted(RENAMED))
def test_all_lists_match(name):
    jmod = importlib.import_module(f"brickmap_tpu.{name}")
    tmod = importlib.import_module(
        f"brickmap_tpu_torch.{RENAMED.get(name, name)}")
    jall = set(getattr(jmod, "__all__", ()))
    tall = set(getattr(tmod, "__all__", ()))
    assert jall - tall == LEFT_OUT.get(name, set())
    assert all(hasattr(tmod, n) for n in tall)
    for n in LEFT_OUT.get(name, ()):
        assert not hasattr(tmod, n)


def test_package_reexports():
    assert brickmap_tpu_torch.__all__ == brickmap_tpu.__all__
    for n in brickmap_tpu_torch.__all__:
        assert hasattr(brickmap_tpu_torch, n)
    assert set(brickmap_tpu_torch.PRESETS) == set(brickmap_tpu.PRESETS)
    assert brickmap_tpu_torch.GridConfig().grid_size == \
        brickmap_tpu.GridConfig().grid_size
    assert not hasattr(brickmap_tpu.render.pathtrace, "Film")
