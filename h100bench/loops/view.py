"""The viewer's loop: progressive 1 spp sample waves over held viewpoints.

One client, closed loop.  The traffic file names the viewpoints (indices
into the configuration's ``viewpoints``) and ``hold``, the waves each view
accumulates into one film before the next view takes over; the cycle of
views repeats through the window.  A hold draws its uniforms from a
``torch.Generator`` seeded from the run's seed, the hold and the view, as
``cmd_render`` draws them for a frame.  A frame is one wave
(``render_wave``) plus ``film_add``, ending when the host reads the wave's
``traced_rays``.
"""

from __future__ import annotations

import random
import time

import torch

from .. import tracing, yardstick
from ..reference import camera as rcamera, compare, config as rconfig, \
    sampling as rsampling, sunsky as rsunsky, view as rview, world as rworld

__all__ = ["Loop"]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _configs(config: dict):
    """The program's and the reference's configuration of the same data."""
    from brickmap_tpu_torch.config import BrickmapConfig, GridConfig, \
        RenderConfig

    prog = BrickmapConfig(grid=GridConfig(**config["grid"]),
                          render=RenderConfig(**config["render"]))
    ref = rconfig.BrickmapConfig(grid=rconfig.GridConfig(**config["grid"]),
                                 render=rconfig.RenderConfig(
                                     **config["render"]))
    return prog, ref


class Loop:
    name, unit = "view", "frame"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.views = list(traffic["views"])
        self.hold = int(traffic["hold"])
        self.cfg, self.rcfg = _configs(config)
        self.width = self.cfg.render.width
        self.height = self.cfg.render.height
        vp = config["viewpoints"]
        scale = self.cfg.grid.grid_size / vp["world_size"]
        self.poses = [(tuple(c * scale for c in vp["positions"][v]),
                       *vp["angles"][v % len(vp["angles"])])
                      for v in self.views]
        # The frame whose outputs the reference recomputes, drawn from the
        # seed among the first cycle of holds.
        self.compared = random.Random(seed).randrange(
            self.hold * len(self.views))

    # ---- the program ------------------------------------------------------
    def setup(self) -> None:
        from brickmap_tpu_torch import scene as scene_mod
        from brickmap_tpu_torch.ops import sunsky as ss
        from brickmap_tpu_torch.render import pathtrace
        from brickmap_tpu_torch.render.camera import Camera, \
            camera_arrays_for

        dev = self.device
        t0 = time.perf_counter()
        self.pathtrace = pathtrace
        self.scene = scene_mod.generate_terrain_scene(self.cfg.grid,
                                                      device=dev)
        _sync(dev)
        t1 = time.perf_counter()
        sun = ss.sun_direction_from_position(self.config["sun_position"], dev)
        cams = [Camera.from_angles(p, h, v) for p, h, v in self.poses]
        self.bricks = [c.brick_position for c in cams]
        self.arrays = [camera_arrays_for(c, sun, self.width, self.height, dev)
                       for c in cams]
        # Warm up each view's wave once (its first wave copies the tile
        # order and the sky constants to the card).
        gen = torch.Generator(device=dev)
        for i in range(len(self.views)):
            gen.manual_seed(tracing.derive_seed(self.seed, 1 << 20, i))
            rgb, count, req = pathtrace.render_wave(
                self.scene, self.arrays[i], self.bricks[i], self.cfg,
                self.width, self.height, generator=gen)
            pathtrace.film_add(pathtrace.film_init(self.width, self.height,
                                                   dev), rgb, count)
            int(req["traced_rays"])
        self.setup_parts = {"world": t1 - t0,
                            "warm_up": time.perf_counter() - t1}

    def _hold_seed(self, hold: int) -> int:
        return tracing.derive_seed(self.seed, hold,
                                   self.views[hold % len(self.views)])

    def run(self, seconds: float) -> dict:
        """The window: frames back to back until ``seconds`` have passed
        (and, were the window too short for it, on to the compared
        frame, untimed)."""
        pt, dev = self.pathtrace, self.device
        gen = torch.Generator(device=dev)
        frames, waves, exhausted = [], [], []
        film = None
        f, t_close = 0, None
        t_open = time.perf_counter()
        while t_close is None or f <= self.compared:
            hold, k = divmod(f, self.hold)
            i = hold % len(self.views)
            if k == 0:
                film = pt.film_init(self.width, self.height, dev)
                gen.manual_seed(self._hold_seed(hold))
            t0 = time.perf_counter()
            rgb, count, req = pt.render_wave(self.scene, self.arrays[i],
                                             self.bricks[i], self.cfg,
                                             self.width, self.height,
                                             generator=gen)
            t1 = time.perf_counter()
            film = pt.film_add(film, rgb, count)
            traced = int(req["traced_rays"])  # waits for the wave
            t2 = time.perf_counter()
            if t_close is None:
                frames.append(t2 - t0)
                waves.append(t1 - t0)
                exhausted.append(req["exhausted_rays"])
                if t2 - t_open >= seconds:
                    t_close = t2
            if f == self.compared:
                self.kept = {"rgb": rgb, "count": count, "traced": traced,
                             "exhausted": int(req["exhausted_rays"]),
                             "hold": hold, "wave": k, "view": i}
            f += 1
        n = len(frames)
        window_s = t_close - t_open
        exh = torch.stack(exhausted)
        self.window_exhausted = int(exh.sum())
        return {"units": n, "seconds": window_s,
                "failed": int((exh > 0).sum()),
                "metrics": {"frame_ms": window_s / n * 1e3,
                            "frame_p95_ms": yardstick.percentile(
                                frames, 95) * 1e3},
                "spans": {"frame": frames, "wave": waves}}

    def profile(self) -> dict:
        """One frame of each view under the profiler, each from a fresh
        film and its own generator seed."""
        pt, dev = self.pathtrace, self.device
        gen = torch.Generator(device=dev)

        def sub_window():
            for i in range(len(self.views)):
                gen.manual_seed(self._profile_seed(i))
                film = pt.film_init(self.width, self.height, dev)
                with tracing.span("wave"):
                    rgb, count, req = pt.render_wave(
                        self.scene, self.arrays[i], self.bricks[i], self.cfg,
                        self.width, self.height, generator=gen)
                with tracing.span("film_add"):
                    film = pt.film_add(film, rgb, count)
                with tracing.span("read"):
                    int(req["traced_rays"])
            return len(self.views)

        return tracing.profiled(sub_window, dev, self.name)

    def _profile_seed(self, i: int) -> int:
        return tracing.derive_seed(self.seed, 1 << 21, i)

    # ---- the reference ----------------------------------------------------
    def _ref_wave(self, world, i: int, seed: int, draws: int, quant=None):
        """The reference's wave for view ``i`` whose uniforms are the
        ``draws``-th draw of a generator seeded ``seed``."""
        dev = self.device
        n = self.width * self.height
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for _ in range(draws):
            u = rsampling.draw_wave_uniforms(
                n, self.rcfg.render.max_bounces, gen, dev)
        p, h, v = self.poses[i]
        cam = rcamera.Camera.from_angles(p, h, v)
        sun = rsunsky.sun_direction_from_position(
            self.config["sun_position"], dev)
        arrays = rcamera.camera_arrays_for(cam, sun, self.width, self.height,
                                           dev)
        pixels = torch.from_numpy(rview.tile_permutation(
            self.width, self.height)).to(dev)
        return rview.wave(world, pixels, u, arrays, cam.brick_position,
                          self.rcfg, self.width, self.height, quant)

    def check(self, trace: bool):
        """The numbers compared with the reference, and (traced) the
        bounds of the profiled frames' kernels from the reference's own
        traces of the same rays."""
        kept = self.kept
        world = rworld.build_world(self.rcfg.grid, self.device)
        checks = {"world_cells_differ": float(compare.world_cells_differ(
            self.scene, world, self.rcfg.grid))}
        del self.scene, self.arrays
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        rgb_r, count_r, traced_r, _, _ = self._ref_wave(
            world, kept["view"], self._hold_seed(kept["hold"]),
            kept["wave"] + 1)
        checks["px_differ"] = compare.pixels_differ(
            kept["rgb"], kept["count"], rgb_r, count_r)
        checks["traced_gap"] = compare.relative_gap(kept["traced"], traced_r)
        checks["exhausted"] = float(self.window_exhausted)
        counts = {}
        if trace:
            lanes = self.width * self.height
            b2 = 0.0
            w = {k: 0.0 for k in ("W0", "W1", "W2", "W3", "W4")}
            for i in range(len(self.views)):
                traces = self._ref_wave(world, i, self._profile_seed(i), 1)[4]
                b2 += sum(yardstick.b2_bound_s(t) for t in traces)
                for k, s in yardstick.wave_bounds_s(lanes, traces).items():
                    w[k] += s
            counts = {"bounds": {"B2": b2, **w}}
        return checks, counts
