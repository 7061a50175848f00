"""brickmap_tpu_torch — the brickmap sparse-voxel path tracer in PyTorch + CUDA.

The port of ``brickmap_tpu`` (JAX/Pallas on a TPU) to one NVIDIA H100.  It
imports torch, never jax, and nothing of ``brickmap_tpu``; where it needs a
NumPy-only module of the JAX package it keeps its own copy.  Its TPU kernels
are hand-written CUDA for sm_90a (``csrc/``), built with nvcc on first use
(:mod:`brickmap_tpu_torch.kernels.build`), each with a plain torch version
beside it that runs for tensors on the CPU.

Layers, entry point down:

* :mod:`.app.cli` / :mod:`.app.benchmark` — ``render`` (with the live
  viewer of :mod:`.utils.preview` and :mod:`.utils.profiling`), ``bench``,
  ``inverse``, ``info`` and ``scaling`` (:mod:`.app.scaling`).
* :mod:`.parallel.render` — ray-sharded rendering and training steps over
  ``torch.distributed``.
* :mod:`.stream` — brick residency streaming: request pull, servicing,
  pool growth.
* :mod:`.render.pathtrace` — one sample wave: primary rays, bounces, NEE;
  :mod:`.kernels.wave` — kernels W1-W3, the wave's stages around the
  traversal (plain versions :mod:`.ops.wave`).
* :mod:`.render.camera`, :mod:`.render.sampling`, :mod:`.ops.sunsky`.
* :mod:`.diff.sparse` — the differentiable renderer over the sparse brick
  pool: record (:mod:`.kernels.record`, kernel B3), then replay a slice at
  a time through kernels R1 and R2 (:mod:`.kernels.replay`, plain versions
  :mod:`.ops.replay`) and B4f/B4b (:mod:`.kernels.extract`);
  :mod:`.diff.render` (the dense compositor), :mod:`.diff.optim` (Adam).
* :mod:`.kernels.traverse` — kernel B2, the hierarchical traversal
  (plain version :mod:`.ops.traverse`).
* :mod:`.kernels.brick` + :mod:`.single_brick` — kernel B1, config 1.
* :mod:`.scene` — the world as flat int32 tensors on the device.
* :mod:`.config`, :mod:`.bits`, :mod:`.noise`, :mod:`.native` — settings,
  the brick bit layout, terrain noise and the g++-built heightfield.
"""

from . import bits, config
from .config import (
    BrickmapConfig,
    GridConfig,
    MeshConfig,
    PRESETS,
    RenderConfig,
    SunSkyConfig,
)

__version__ = "0.1.0"

__all__ = [
    "bits",
    "config",
    "BrickmapConfig",
    "GridConfig",
    "MeshConfig",
    "PRESETS",
    "RenderConfig",
    "SunSkyConfig",
]
