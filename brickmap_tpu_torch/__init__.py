"""brickmap_tpu_torch — the brickmap sparse-voxel path tracer in PyTorch + CUDA.

The port of ``brickmap_tpu`` (JAX/Pallas on a TPU) to one NVIDIA H100.  It
imports torch, never jax, and nothing of ``brickmap_tpu``; where it needs a
NumPy-only module of the JAX package it keeps its own copy.  Its TPU kernels
are hand-written CUDA for sm_90a (``csrc/``), built with nvcc on first use
(:mod:`brickmap_tpu_torch.kernels.build`), each with a plain torch version
beside it that runs for tensors on the CPU.

Layers, entry point down:

* :mod:`.app.cli` / :mod:`.app.benchmark` — ``render``, ``bench``,
  ``inverse`` and ``info``.
* :mod:`.stream` — brick residency streaming: request pull, servicing,
  pool growth.
* :mod:`.render.pathtrace` — one sample wave: primary rays, bounces, NEE.
* :mod:`.render.camera`, :mod:`.render.sampling`, :mod:`.ops.sunsky`.
* :mod:`.kernels.traverse` — kernel B2, the hierarchical traversal
  (plain version :mod:`.ops.traverse`).
* :mod:`.kernels.brick` + :mod:`.single_brick` — kernel B1, config 1.
* :mod:`.scene` — the world as flat int32 tensors on the device.
"""

__version__ = "0.1.0"
