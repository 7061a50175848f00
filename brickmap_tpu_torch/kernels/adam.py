"""Kernel A1: one Adam step with the clip to [0, 1], one pass a field.

The JAX package leaves the update to optax under XLA
(``brickmap_tpu/diff/optim.py``); the port runs it as one hand-written CUDA
kernel (``csrc/adam.cu``), which reads a field's parameters, gradient and
moments once and writes the parameters and moments once, 28 bytes an
element.

:func:`adam_update` takes one field ``p`` with its gradient ``g``, its
moments ``m`` and ``v`` and the step count on the host (1 for the first),
and updates ``p``, ``m`` and ``v`` in place.  For tensors on the card it
launches the kernel once, on the current stream; for tensors on the CPU it
runs the plain version,
:func:`brickmap_tpu_torch.ops.adam.adam_update_plain`; on any other device
it raises.  ``adam_update.launches`` counts kernel
launches and ``adam_update.events`` is the event hook of
:mod:`brickmap_tpu_torch.kernels`.  While a torch profiler records, each
launch sits inside an operator range named ``brickmap::adam_update`` (a
RecordFunction of operator scope, as Inductor wraps its Triton launches),
so that the profiler ties A1's kernel to that operator and through it to
the host spans around it; a ctypes launch outside any operator is tied to
none.  :func:`adam_args` builds the launcher's arguments (the host
rehearsal of ``csrc/adam.cu``, ``tests/test_torch_adam_host.py``, drives the
launcher with them).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.adam import adam_update_plain, step_scalars
from . import build, hooked

__all__ = ["adam_update", "adam_args"]

_recording = torch.autograd._profiler_enabled


def _bind(lib) -> None:
    p, f = ctypes.c_void_p, ctypes.c_float
    lib.adam_launch.argtypes = [p, p, p, p, ctypes.c_longlong, f, f,
                                f, f, f, f, f, p]
    lib.adam_launch.restype = ctypes.c_int


def _check(p, g, m, v, step: int) -> None:
    """Raise unless ``g``, ``m`` and ``v`` are float32 on ``p``'s device with
    its shape, ``p``, ``m`` and ``v`` contiguous, and ``step`` is at least
    1."""
    for name, a in (("p", p), ("g", g), ("m", m), ("v", v)):
        if a.dtype != torch.float32 or a.device != p.device \
                or a.shape != p.shape:
            raise ValueError(f"adam_update: {name} must be float32 on "
                             f"{p.device} of shape {tuple(p.shape)}")
        if name != "g" and not a.is_contiguous():
            raise ValueError(f"adam_update: {name} must be contiguous (it "
                             f"is updated in place)")
    if step < 1:
        raise ValueError(f"adam_update: step is {step}")


def adam_args(p, g, m, v, step: int, lr: float, betas, eps: float,
              stream) -> tuple:
    """``adam_launch``'s arguments for one field (``p``, ``g``, ``m`` and
    ``v`` contiguous) at step ``step``."""
    b1, b2 = betas
    return (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), *step_scalars(lr, b1, b2, step), b1, 1.0 - b1, b2,
            1.0 - b2, eps, stream)


def adam_update(p, g, m, v, step: int, lr: float, betas,
                eps: float) -> None:
    """Step ``step`` of Adam with the clip to [0, 1] of one field ``p`` by
    its gradient ``g``, with its moments ``m`` and ``v``, all in place:
    one launch of kernel A1 for tensors on the card, the plain version for
    tensors on the CPU."""
    step = int(step)
    if p.device.type == "cpu":
        b1, b2 = betas
        adam_update_plain(p, g, m, v, b1, b2, eps,
                          *step_scalars(lr, b1, b2, step))
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_update: unsupported device {p.device}")
    _check(p, g, m, v, step)
    if not p.numel():
        return
    g = g.contiguous()
    lib = build.load("adam", _bind)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        args = adam_args(p, g, m, v, step, lr, betas, eps, stream)
        if _recording():
            with torch._C._profiler._RecordFunctionFast(
                    "brickmap::adam_update"):
                status = hooked(adam_update, lib.adam_launch, *args)
        else:
            status = hooked(adam_update, lib.adam_launch, *args)
    build.check(status, "adam_kernel")
    adam_update.launches += 1


adam_update.launches = 0
adam_update.events = None
