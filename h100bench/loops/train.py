"""The inverse-rendering loop: Adam steps over one fixed batch of rays.

One client, closed loop: ``inverse --sparse``'s loop with fixed rays, so
the record and its sorts (the segment cache) are paid once, in set-up.  A
step is ``l2_loss_and_grads_sparse`` with the cache, then ``adam_step``
(update and clip), ending in a synchronise.  The configuration gives the
ray frame, K, the fields' start, the target and the learning rate; the rays
are drawn on the card from the run's seed.  Set-up drives the training
object through its first ``steps_before_window`` steps (the first fills the
cache) and hands the same object to the window; the reference follows those
steps from the same inputs.
"""

from __future__ import annotations

import math
import time

import torch

from .. import tracing, yardstick
from ..reference import compare, config as rconfig, sparse as rsparse, \
    world as rworld

__all__ = ["Loop", "make_rays"]


def make_rays(config: dict, seed: int, device):
    """The batch: origins uniform over ``origin_span``^2 at ``origin_z``,
    directions normal with d_z = -|d_z| - 1, normalised (the sparse
    benchmarks' frame, ``app/benchmark.py::sparse_inverse_rays``), drawn
    from a generator on ``device`` seeded from ``seed``; background and
    target constant.  Returns (origins, directions, background, target)."""
    n = int(config["rays"])
    lo, hi = config["origin_span"]
    gen = torch.Generator(device=device)
    gen.manual_seed(tracing.derive_seed(seed, 7))
    xy = lo + (hi - lo) * torch.rand((n, 2), generator=gen, device=device)
    z = torch.full((n, 1), float(config["origin_z"]), device=device)
    d = torch.randn((n, 3), generator=gen, device=device)
    d[:, 2] = -d[:, 2].abs() - 1.0
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    bg = torch.full((n, 3), float(config["background"]), device=device)
    tgt = torch.full((n, 3), float(config["target"]), device=device)
    return torch.cat([xy, z], dim=1).contiguous(), d.contiguous(), bg, tgt


def _diff_norm(p, p0, block: int = 1 << 26) -> float:
    """||p - p0|| with ``p0`` on the host, by blocks, squares in float64."""
    a, b = p.reshape(-1), p0.reshape(-1)
    acc = 0.0
    for i in range(0, a.shape[0], block):
        d = a[i:i + block] - b[i:i + block].to(a.device)
        acc += float(torch.sum(d.double() ** 2))
    return math.sqrt(acc)


class Loop:
    name, unit = "train", "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.k = int(config["k_segments"])
        self.lr = float(config["learning_rate"])
        self.first = int(traffic["steps_before_window"])

    # ---- the program ------------------------------------------------------
    def setup(self) -> None:
        from brickmap_tpu_torch import scene as scene_mod
        from brickmap_tpu_torch.app.benchmark import active_fields
        from brickmap_tpu_torch.config import GridConfig
        from brickmap_tpu_torch.diff import optim, sparse
        from brickmap_tpu_torch.kernels.record import record_segments

        dev = self.device
        marks = [time.perf_counter()]

        def mark():
            if dev.type == "cuda":
                torch.cuda.synchronize()
            marks.append(time.perf_counter())

        self.grid = GridConfig(**self.config["grid"])
        self.sparse, self.optim = sparse, optim
        self.scene = scene_mod.generate_terrain_scene(self.grid, device=dev)
        mark()
        self.rays = make_rays(self.config, self.seed, dev)
        segs = record_segments(self.rays[0], self.rays[1], self.scene,
                               self.grid, k_segments=self.k)
        mark()
        self.cellmap, occ, alb = active_fields(self.scene, self.grid,
                                               segs["cells"])
        del segs
        self.params = (occ, alb)
        self.opt = optim.make_adam(self.params, self.lr)
        self.cache: dict = {}
        mark()
        start = [p.to("cpu", copy=True) for p in self.params]
        mark()
        self.losses = []
        for i in range(self.first):
            loss, grads = self._loss_and_grads()
            optim.adam_step(self.opt, self.params, grads)
            self.losses.append(float(loss))
            del grads
            if i == 0:
                # The first gradient as the optimizer got it: its first
                # moment after one step is (1 - beta1) g (0 where it got
                # none).
                b1 = self.opt.param_groups[0]["betas"][0]
                self.grad_norms = [
                    rsparse.leaf_norms([self.opt.state[p]["exp_avg"]])[0]
                    / (1.0 - b1) if "exp_avg" in self.opt.state.get(p, {})
                    else 0.0 for p in self.params]
        mark()
        self.change_norms = [_diff_norm(p, s)
                             for p, s in zip(self.params, start)]
        self.active = int(occ.shape[0])
        mark()
        self.setup_parts = dict(zip(
            ("world", "rays_record", "active_fields", "copy_start",
             "first_steps", "change_norms"),
            (b - a for a, b in zip(marks, marks[1:]))))

    def _loss_and_grads(self):
        o, d, bg, tgt = self.rays
        occ, alb = self.params
        return self.sparse.l2_loss_and_grads_sparse(
            o, d, self.scene, self.cellmap, occ, alb, bg, tgt, self.grid,
            k_segments=self.k, seg_cache=self.cache)

    def _step(self, spans=None) -> None:
        t0 = time.perf_counter()
        loss, grads = self._loss_and_grads()
        t1 = time.perf_counter()
        self.optim.adam_step(self.opt, self.params, grads)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if spans is not None:
            spans["step"].append(t1 - t0)
        self.last_loss = loss

    def run(self, seconds: float) -> dict:
        spans = {"step": []}
        t_open = time.perf_counter()
        while True:
            self._step(spans)
            t = time.perf_counter()
            if t - t_open >= seconds:
                break
        n = len(spans["step"])
        window_s = t - t_open
        failed = int(not math.isfinite(float(self.last_loss)))
        return {"units": n, "seconds": window_s, "failed": failed,
                "metrics": {"step_ms": window_s / n * 1e3}, "spans": spans}

    def profile(self) -> dict:
        """Three steps under the profiler, their calls in spans."""
        def sub_window():
            for _ in range(3):
                with tracing.span("step"):
                    loss, grads = self._loss_and_grads()
                with tracing.span("adam"):
                    self.optim.adam_step(self.opt, self.params, grads)
                with tracing.span("sync"):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize()
                # Free the gradients before the next step, as the window's
                # steps do, so that the peak is the window's.
                del loss, grads
            return 3

        return tracing.profiled(sub_window, self.device, self.name)

    # ---- the reference ----------------------------------------------------
    def check(self, trace: bool):
        grid = rconfig.GridConfig(**self.config["grid"])
        del self.params, self.opt, self.cache, self.cellmap
        self.last_loss = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        world = rworld.build_world(grid, self.device)
        checks = {"world_cells_differ": float(compare.world_cells_differ(
            self.scene, world, grid))}
        del self.scene
        slices = []

        def on_slice(cells, direction, lin2):
            slices.append(yardstick.slice_counts(cells, direction, lin2))

        c = self.config
        ref = rsparse.follow(world, grid, *self.rays, self.k, self.lr,
                             c["occupancy_scale"], c["albedo"],
                             steps=self.first,
                             on_slice=on_slice if trace else None)
        checks["active_gap"] = compare.relative_gap(self.active,
                                                    ref["active"])
        checks["loss_gap"] = max(compare.relative_gap(a, b) for a, b in
                                 zip(self.losses, ref["losses"]))
        checks["grad_gap"] = compare.leaf_gap(
            self.grad_norms, ref["grad_norms"], ref["grad_norms"])
        checks["change_gap"] = compare.leaf_gap(
            self.change_norms, ref["change_norms"], ref["grad_norms"])
        counts = {"bounds": yardstick.replay_bounds_s(slices)} if trace \
            else {}
        return checks, counts
