"""Debug modes: the port's counterpart of ``brickmap_tpu/utils/debug.py``.

The reference has no sanitizers (atomics + a frame-end device sync are its
whole concurrency story, voxel.cuh:229-238, kernel.cu:431).  What the JAX
package offers there and torch can mean:

* NaN trapping (:func:`debug_nans`), JAX's ``jax_debug_nans``;
* deterministic re-runs: every wave is replayable from its uniforms
  (``render_wave(..., uniforms=...)``).

Pallas interpret mode and the x64 guard have no torch meaning (each kernel
of the port has a plain torch version that the CPU runs instead).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["debug_nans"]


@contextmanager
def debug_nans(enable: bool = True):
    """Raise ``FloatingPointError`` at the first torch op inside the context
    whose floating-point output holds a NaN.

    A ``TorchDispatchMode`` checks every op's outputs (one device sync per
    op: a debugging mode, not for timing).  Outputs of the ctypes-launched
    CUDA kernels are not torch ops: a NaN they write is caught at the next
    torch op that consumes it.  Leaving the context restores the previous
    state; ``enable=False`` adds no trap.
    """
    if not enable:
        yield
        return
    with _NanTrap():
        yield


class _NanTrap(TorchDispatchMode):
    """Runs each op, then checks its floating-point outputs for NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (debug_nans)")
        return out
