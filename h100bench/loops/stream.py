"""The streaming viewer's loop: cold-start brick streaming from one view.

One client, closed loop, on the port's normal streaming path (the one
``render --streaming`` runs): a frame is ``render_wave`` over the manager's
``device_scene()``, ``film_add``, the host's read of ``traced_rays``,
``pull_requests`` and ``process_requests``.  Frames run in cycles of the
traffic's ``cycle`` frames; each cycle starts with
``StreamingScene.reset()`` (every brick unloaded again, as when a viewer
reopens its world), a fresh film and a ``torch.Generator`` seeded from the
run's seed and the cycle.  The reset runs inside the window and outside
every frame's own time.  The truth stays on the host, as the reference's
CPU supergrid does; the device holds the index volume and the resident
pool.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from .. import tracing, yardstick
from ..reference import camera as rcamera, compare, sampling as rsampling, \
    stream as rstream, sunsky as rsunsky, view as rview, world as rworld
from .view import _configs, _sync

__all__ = ["Loop"]


class Loop:
    name, unit = "stream", "frame"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.seed, self.device = config, seed, device
        self.view = int(traffic["view"])
        self.cycle = int(traffic["cycle"])
        self.cfg, self.rcfg = _configs(config)
        self.width = self.cfg.render.width
        self.height = self.cfg.render.height
        self.queue = int(config["streaming"]["queue_size"])
        self.starting_capacity = int(config["streaming"]["starting_capacity"])
        vp = config["viewpoints"]
        scale = self.cfg.grid.grid_size / vp["world_size"]
        self.pose = (tuple(c * scale for c in vp["positions"][self.view]),
                     *vp["angles"][self.view % len(vp["angles"])])
        # The frame the reference recomputes, drawn from the seed among the
        # second cycle's frames, so that a reset lies before it.
        self.compared = self.cycle + random.Random(seed).randrange(self.cycle)

    # ---- the program ------------------------------------------------------
    def setup(self) -> None:
        from brickmap_tpu_torch import scene as scene_mod
        from brickmap_tpu_torch.ops import sunsky as ss
        from brickmap_tpu_torch.render import pathtrace
        from brickmap_tpu_torch.render.camera import Camera, \
            camera_arrays_for
        from brickmap_tpu_torch.stream import StreamingScene, pull_requests

        dev = self.device
        self.pathtrace, self.pull_requests = pathtrace, pull_requests
        t0 = time.perf_counter()
        truth = scene_mod.generate_terrain_scene(self.cfg.grid, device=dev)
        _sync(dev)
        t1 = time.perf_counter()
        self.mgr = StreamingScene(truth, self.cfg.grid,
                                  queue_size=self.queue,
                                  starting_capacity=self.starting_capacity,
                                  device=dev)
        del truth         # the truth now lives on the host only
        _sync(dev)
        t2 = time.perf_counter()
        sun = ss.sun_direction_from_position(self.config["sun_position"], dev)
        cam = Camera.from_angles(*self.pose)
        self.brick = cam.brick_position
        self.arrays = camera_arrays_for(cam, sun, self.width, self.height,
                                        dev)
        # One whole cycle and a reset: every kernel builds, the pool grows.
        gen = torch.Generator(device=dev)
        gen.manual_seed(tracing.derive_seed(self.seed, 1 << 20))
        film = pathtrace.film_init(self.width, self.height, dev)
        for _ in range(self.cycle):
            film = self._frame(film, gen)[0]
        self.mgr.reset()
        _sync(dev)
        self.setup_parts = {"world": t1 - t0, "manager": t2 - t1,
                            "warm_up": time.perf_counter() - t2}

    def _frame(self, film, gen):
        """One frame: (film, rgb, count, req, traced, pulled, uploads,
        host seconds of its phases: the wave's call, the read, the pull and
        the servicing)."""
        pt = self.pathtrace
        t0 = time.perf_counter()
        rgb, count, req = pt.render_wave(self.mgr.device_scene(),
                                         self.arrays, self.brick, self.cfg,
                                         self.width, self.height,
                                         generator=gen)
        t1 = time.perf_counter()
        film = pt.film_add(film, rgb, count)
        traced = int(req["traced_rays"])  # waits for the wave
        t2 = time.perf_counter()
        got = self.pull_requests(req, self.mgr.queue_size)
        t3 = time.perf_counter()
        uploads = self.mgr.process_requests(got)
        phases = (t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3)
        return film, rgb, count, req, traced, got, uploads, phases

    def _cycle_seed(self, cycle: int) -> int:
        return tracing.derive_seed(self.seed, cycle)

    def run(self, seconds: float) -> dict:
        """The window: cycles of frames back to back until ``seconds`` have
        passed (and, were the window too short for it, on to the compared
        frame, untimed).  The snapshot of the state before the compared
        frame is taken out of the window's time."""
        dev, mgr = self.device, self.mgr
        gen = torch.Generator(device=dev)
        frames, phases, exhausted, uploads, resets = [], [], [], [], []
        lists, film = [], None
        f, t_close, taken_out = 0, None, 0.0
        t_open = time.perf_counter()
        while t_close is None or f <= self.compared:
            cycle, k = divmod(f, self.cycle)
            if k == 0:
                t = time.perf_counter()
                mgr.reset()
                if t_close is None:
                    resets.append(time.perf_counter() - t)
                film = self.pathtrace.film_init(self.width, self.height, dev)
                gen.manual_seed(self._cycle_seed(cycle))
            if f == self.compared:
                t = time.perf_counter()
                state = mgr.state()
                if t_close is None:
                    taken_out += time.perf_counter() - t
            t0 = time.perf_counter()
            film, rgb, count, req, traced, got, up, parts = self._frame(
                film, gen)
            t1 = time.perf_counter()
            if t_close is None:
                frames.append(t1 - t0)
                phases.append(parts)
                exhausted.append(req["exhausted_rays"])
                uploads.append(up)
                if t1 - t_open - taken_out >= seconds:
                    _sync(dev)
                    t_close = time.perf_counter()
            if f == self.compared:
                self.kept = {"state": state, "lists": lists, "k": k,
                             "cycle": cycle, "rgb": rgb, "count": count,
                             "traced": traced, "pulled": got}
            elif f < self.compared and cycle == self.compared // self.cycle:
                lists.append(np.asarray(got, np.int32).reshape(-1, 3))
            f += 1
        n = len(frames)
        window_s = t_close - t_open - taken_out
        exh = torch.stack(exhausted).cpu()
        self.window_exhausted = int(exh.sum())
        self.window_over_queue = sum(u > self.queue for u in uploads)
        full = sum(u == self.queue for u in uploads)
        print(f"h100bench: stream {n} frames, {len(resets)} resets "
              f"(mean {sum(resets) / len(resets) * 1e3:.3f} ms), "
              f"{full} frames at the cap of {self.queue}, uploads a frame "
              f"min / mean / max {min(uploads)} / {sum(uploads) / n:.1f} / "
              f"{max(uploads)}, pool rows {mgr.pool_rows}; host ms a frame "
              "p50 / mean: " + ", ".join(
                  f"{name} {yardstick.percentile(v, 50) * 1e3:.3f} / "
                  f"{sum(v) / n * 1e3:.3f}" for name, v in zip(
                      ("wave", "read", "pull", "service"), zip(*phases))),
              file=sys.stderr, flush=True)
        return {"units": n, "seconds": window_s,
                "failed": sum(e > 0 or u > self.queue
                              for e, u in zip(exh.tolist(), uploads)),
                "metrics": {"frame_ms": window_s / n * 1e3,
                            "frame_p95_ms": yardstick.percentile(
                                frames, 95) * 1e3},
                "spans": {"frame": frames}}

    def profile(self) -> dict:
        """One whole cycle under the profiler: a reset and its frames, from
        a fresh film and a generator of its own; the manager's totals after
        it (a reset clears them) are the cycle's."""
        pt, dev, mgr = self.pathtrace, self.device, self.mgr
        gen = torch.Generator(device=dev)

        def sub_window():
            with tracing.span("reset"):
                mgr.reset()
            gen.manual_seed(tracing.derive_seed(self.seed, 1 << 21))
            film = pt.film_init(self.width, self.height, dev)
            for _ in range(self.cycle):
                with tracing.span("wave"):
                    rgb, count, req = pt.render_wave(
                        mgr.device_scene(), self.arrays, self.brick,
                        self.cfg, self.width, self.height, generator=gen)
                with tracing.span("film_add"):
                    film = pt.film_add(film, rgb, count)
                with tracing.span("read"):
                    int(req["traced_rays"])
                with tracing.span("pull"):
                    got = self.pull_requests(req, mgr.queue_size)
                with tracing.span("service"):
                    mgr.process_requests(got)
            return self.cycle

        ctx = tracing.profiled(sub_window, dev, self.name)
        ctx["stream_totals"] = {k: getattr(mgr, k) for k in rstream.TOTALS}
        return ctx

    # ---- the reference ----------------------------------------------------
    def ref_frame(self, world, cycle: int, draws: int, quant=None):
        """The reference's frame over ``world`` whose uniforms are the
        ``draws``-th draw of the cycle's generator: (rgb, count, traced,
        exhausted, req)."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._cycle_seed(cycle))
        for _ in range(draws):
            u = rsampling.draw_wave_uniforms(
                self.width * self.height, self.rcfg.render.max_bounces, gen,
                dev)
        cam = rcamera.Camera.from_angles(*self.pose)
        sun = rsunsky.sun_direction_from_position(
            self.config["sun_position"], dev)
        arrays = rcamera.camera_arrays_for(cam, sun, self.width, self.height,
                                           dev)
        pixels = torch.from_numpy(rview.tile_permutation(
            self.width, self.height)).to(dev)
        return rstream.wave(world, pixels, u, arrays, cam.brick_position,
                            self.rcfg, self.width, self.height, quant)

    def ref_manager(self, cls=rstream.Manager, truth=None):
        """A reference manager, cold, over the program's truth (or
        ``truth``: index volume, pool rows, bases as NumPy)."""
        iv, pool, base = truth if truth is not None \
            else self.mgr.truth_arrays()
        return cls(iv, pool, base, self.rcfg.grid, self.queue,
                   self.starting_capacity)

    def replay(self, cls=rstream.Manager, truth=None, quant=None) -> dict:
        """A reference manager (``cls``) fed the compared cycle's pulled
        lists up to the compared frame, then that frame traced over its
        state: the numbers a run compares."""
        kept = self.kept
        ref = self.ref_manager(cls, truth)
        for got in kept["lists"]:
            ref.process(got)
        rgb, count, traced, exh, req = self.ref_frame(
            ref.world(self.device), kept["cycle"], kept["k"] + 1, quant)
        return {"state": ref.state(), "rgb": rgb, "count": count,
                "traced": traced, "exhausted": exh,
                "pulled": rstream.pull(req, self.queue)}

    def check(self, trace: bool):
        """The numbers compared with the reference: the program's truth
        against the world built again, the state before the compared frame
        against a reference manager's replay of the same request lists, and
        the frame and its requests against the reference's over that
        state."""
        kept, dev = self.kept, self.device
        iv, pool, base = self.mgr.truth_arrays()
        truth = rworld.World(*(torch.from_numpy(a).to(dev) for a in (
            iv.view("int32"), pool.view("int32"), base.astype("int32"))))
        world = rworld.build_world(self.rcfg.grid, dev)
        checks = {"world_cells_differ": float(compare.world_cells_differ(
            truth, world, self.rcfg.grid))}
        del truth, world
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.replay()
        checks["state_differ"] = float(rstream.state_differ(kept["state"],
                                                            ref["state"]))
        checks["px_differ"] = compare.pixels_differ(
            kept["rgb"], kept["count"], ref["rgb"], ref["count"])
        checks["traced_gap"] = compare.relative_gap(kept["traced"],
                                                    ref["traced"])
        checks["requests_differ"] = rstream.requests_differ(kept["pulled"],
                                                            ref["pulled"])
        checks["exhausted"] = float(self.window_exhausted)
        checks["uploads_over_queue"] = float(self.window_over_queue)
        return checks, {}
