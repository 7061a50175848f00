"""Inverse-rendering optimizer: fit voxel occupancy + albedo to target
images.

The port of ``brickmap_tpu/diff/optim.py``: Adam with optax's defaults
(beta 0.9 / 0.999, eps 1e-8) and the clip of the fields to [0, 1] after
each update, as :class:`ClippedAdam`, whose step is kernel A1
(``kernels/adam.py``): one pass a field on the card, the plain torch
version on the CPU.  Its state is ``torch.optim.Adam``'s (``step``,
``exp_avg``, ``exp_avg_sq`` a parameter).  The sparse fields, views of
one ``field4`` [P*512, 4] (``diff/field4.py``, their one layout), step as
that ``field4`` in one call when their gradients and moments are views of
one ``field4`` too; their moments are made so.  Checkpoints keep the JAX
package's ``.npz`` layout (``step``, ``occupancy``, ``albedo`` and the optax
state's leaves as ``opt_i`` in ``jax.tree_util.tree_flatten`` order:
count, mu of each field, nu of each field), so a JAX checkpoint resumes here
and the other way round.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.adam import adam_update
from ..utils.profiling import annotate
from .field4 import field4_of, field4_views

__all__ = ["InverseRenderer", "ClippedAdam", "make_adam", "adam_step",
           "adam_state_arrays", "load_adam_state"]


class ClippedAdam(torch.optim.Optimizer):
    """Adam (``torch.optim.Adam``'s arithmetic, no weight decay) whose
    update clips each parameter to [0, 1], one call of
    :func:`~brickmap_tpu_torch.kernels.adam.adam_update` a parameter, or
    one a group whose two parameters, their gradients and both moments are
    each the views of one ``field4`` (:func:`~brickmap_tpu_torch.diff.
    field4.field4_of`).  The moments are made as zeros at a parameter's
    first step, as the views of one zero ``field4`` each for such a pair;
    ``step`` is a float32 tensor on the host, as ``torch.optim.Adam``
    keeps it."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "betas": tuple(betas),
                                  "eps": eps})

    def _init_state(self, params) -> None:
        """Step 0 and zero moments for each of ``params`` without state."""
        fresh = [p for p in params if not self.state[p]]
        field4 = field4_of(*fresh) if len(fresh) == 2 else None

        def zeros():
            if field4 is not None:
                return field4_views(torch.zeros_like(field4))
            return [torch.zeros_like(p, memory_format=torch.preserve_format)
                    for p in fresh]

        for p, m, v in zip(fresh, zeros(), zeros()):
            self.state[p].update(step=torch.tensor(0.0, dtype=torch.float32),
                                 exp_avg=m, exp_avg_sq=v)

    def _field4_args(self, params):
        """``adam_update``'s (p, g, m, v) as the ``field4`` of each pair
        where ``params`` are one pair at one step, else None."""
        if len(params) != 2:
            return None
        states = [self.state[p] for p in params]
        if float(states[0]["step"]) != float(states[1]["step"]):
            return None
        args = [field4_of(*pair) for pair in (
            params, [p.grad for p in params],
            [st["exp_avg"] for st in states],
            [st["exp_avg_sq"] for st in states])]
        return None if any(a is None for a in args) else args

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            self._init_state(params)
            hp = (group["lr"], group["betas"], group["eps"])
            args = self._field4_args(params)
            if args is not None:
                for p in params:
                    self.state[p]["step"] += 1
                adam_update(*args, int(self.state[params[0]]["step"]), *hp)
                continue
            for p in params:
                st = self.state[p]
                st["step"] += 1
                adam_update(p, p.grad, st["exp_avg"], st["exp_avg_sq"],
                            int(st["step"]), *hp)


def make_adam(params, learning_rate: float) -> ClippedAdam:
    """Adam with optax's defaults, and the clip to [0, 1], over ``params``
    (plain tensors)."""
    return ClippedAdam(list(params), lr=learning_rate, betas=(0.9, 0.999),
                       eps=1e-8)


def adam_step(opt: ClippedAdam, params, grads) -> None:
    """One Adam update of ``params`` by ``grads`` with the clip to [0, 1]
    (the inverse loop of the JAX package: optax update, apply, clip)."""
    with annotate("bm.optim.adam_step"):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None


def adam_state_arrays(opt: ClippedAdam, params) -> list[np.ndarray]:
    """The optax ``adam`` state's leaves in tree-flatten order:
    [count (int32), mu_0, ..., mu_k, nu_0, ..., nu_k]."""
    states = [opt.state.get(p, {}) for p in params]
    count = int(states[0]["step"]) if states[0] else 0
    def moment(st, key, p):
        return (st[key] if st else torch.zeros_like(p)).cpu().numpy()
    return ([np.asarray(count, np.int32)]
            + [moment(st, "exp_avg", p) for st, p in zip(states, params)]
            + [moment(st, "exp_avg_sq", p) for st, p in zip(states, params)])


@torch.no_grad()
def load_adam_state(opt: ClippedAdam, params, leaves) -> None:
    """Inverse of :func:`adam_state_arrays`: the moments are copied into
    the parameters' moments in place (made first where a parameter has
    none), so that a ``field4`` pair keeps stepping in one call."""
    k = len(params)
    count = int(np.asarray(leaves[0]))
    opt._init_state(params)
    for i, p in enumerate(params):
        st = opt.state[p]
        st["step"] = torch.tensor(float(count), dtype=torch.float32)
        for key, leaf in (("exp_avg", leaves[1 + i]),
                          ("exp_avg_sq", leaves[1 + k + i])):
            st[key].copy_(torch.as_tensor(leaf).reshape(p.shape))


@dataclass
class InverseRenderer:
    grid_shape: tuple = (32, 32, 32)     # (Z, Y, X)
    learning_rate: float = 0.05
    max_steps_per_ray: int = 128
    rays_per_chunk: int = 32768
    mesh: object | None = None           # parallel.render.Mesh: shard rays
    metrics: object | None = None        # anything with .log(step, **kw)
    device: str = "cuda"
    step: int = field(default=0, init=False)

    def __post_init__(self):
        if self.mesh is not None:
            self.device = self.mesh.device
        self.occupancy = torch.full(self.grid_shape, 0.3,
                                    dtype=torch.float32, device=self.device)
        self.albedo = torch.full((*self.grid_shape, 3), 0.5,
                                 dtype=torch.float32, device=self.device)
        self._opt = make_adam(self._params, self.learning_rate)

    @property
    def _params(self):
        return (self.occupancy, self.albedo)

    # ------------------------------------------------------------------
    def train_step(self, origins, directions, background, target) -> float:
        """One gradient step on an L2 image loss; returns the loss.  With a
        mesh every rank passes the whole batch and takes its shard of the
        rays; the gradients are averaged over the mesh, so every rank makes
        the same update."""
        if self.mesh is not None:
            from ..parallel.render import inverse_train_step, shard_rays

            o, d, bg, tgt = shard_rays(self.mesh, (origins, directions,
                                                   background, target))
            loss, docc, dalb = inverse_train_step(
                self.mesh, o, d, self.occupancy, self.albedo, bg, tgt,
                max_steps=self.max_steps_per_ray)
            grads = (docc, dalb)
        else:
            from .render import l2_loss_and_grads

            loss, grads = l2_loss_and_grads(
                origins, directions, self.occupancy, self.albedo, background,
                target, max_steps=self.max_steps_per_ray,
                rays_per_chunk=self.rays_per_chunk)
        adam_step(self._opt, self._params, grads)
        self.step += 1
        if self.metrics is not None:
            self.metrics.log(self.step, loss=float(loss))
        return float(loss)

    # ------------------------------------------------------------------
    # Checkpoint / resume in the JAX package's npz layout.
    def save_checkpoint(self, path: str) -> None:
        leaves = adam_state_arrays(self._opt, self._params)
        np.savez_compressed(
            path,
            step=np.asarray(self.step),
            occupancy=self.occupancy.cpu().numpy(),
            albedo=self.albedo.cpu().numpy(),
            **{f"opt_{i}": a for i, a in enumerate(leaves)},
        )

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            self.step = int(data["step"])
            with torch.no_grad():
                self.occupancy.copy_(torch.from_numpy(data["occupancy"]))
                self.albedo.copy_(torch.from_numpy(data["albedo"]))
            n_leaves = 1 + 2 * len(self._params)
            load_adam_state(self._opt, self._params,
                            [data[f"opt_{i}"] for i in range(n_leaves)])

    # ------------------------------------------------------------------
    def render(self, origins, directions, background):
        from .render import composite_rays

        with torch.no_grad():
            return composite_rays(origins, directions, self.occupancy,
                                  self.albedo, background,
                                  max_steps=self.max_steps_per_ray)
