"""One Adam step with the clip to [0, 1], in torch: the plain version of
kernel A1 (``csrc/adam.cu``).

The JAX package's inverse loop is optax's ``adam``, ``apply_updates`` and a
clip of the fields to [0, 1] (``brickmap_tpu/diff/optim.py``).  Here, with
the step count ``t`` on the host and the scalars taken in double
(:func:`step_scalars`), each leaf ``p`` with gradient ``g`` and moments
``m``, ``v`` is updated in place as

    m = m*b1 + (1-b1)*g
    v = v*b2 + ((1-b2)*g)*g
    d = sqrt(v) / sqrt(1 - b2^t) + eps
    p = p + (-lr / (1 - b1^t)) * (m/d), then clipped to [0, 1]

(``torch.optim.Adam``'s arithmetic, term by term).  Each operation is one
torch op on float32 tensors, rounded once, with the scalars rounded to
float as torch rounds a Python scalar, in the kernel's order, and none
rounds differently on the card and on the CPU: the square root is taken
in double and rounded to float, which is the correctly rounded float
square root on both (torch's float32 ``sqrt`` on the CPU is not: an ulp
off on ~0.6% of inputs, with AVX-512), the bias correction divides by a
0-dim tensor on the leaf's device (``tensor / python_float`` is a product
with the float reciprocal on the card), and the clip is a select on
``p < 0`` and ``p > 1``, which keeps a NaN (as ``clamp_`` does).
"""

from __future__ import annotations

import math

import torch

__all__ = ["step_scalars", "adam_update_plain"]


def step_scalars(lr: float, beta1: float, beta2: float,
                 step: int) -> tuple[float, float]:
    """``(step_size, sqrt_bc2)`` of step ``step`` (1 for the first), in
    double: ``-lr / (1 - beta1^step)`` and ``sqrt(1 - beta2^step)``."""
    return -lr / (1.0 - beta1 ** step), math.sqrt(1.0 - beta2 ** step)


@torch.no_grad()
def adam_update_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, beta1: float, beta2: float,
                      eps: float, step_size: float,
                      sqrt_bc2: float) -> None:
    """One update of ``p`` and its moments ``m``, ``v`` by ``g``, in place,
    then the clip of ``p`` to [0, 1]."""
    m.mul_(beta1).add_(g * (1.0 - beta1))
    v.mul_(beta2).add_(g * (1.0 - beta2) * g)
    d = v.double().sqrt_().float().div_(
        torch.tensor(sqrt_bc2, dtype=v.dtype, device=v.device)).add_(eps)
    p.add_(m.div(d).mul_(step_size))
    p.copy_(torch.where(p < 0.0, 0.0, torch.where(p > 1.0, 1.0, p)))
