"""The live viewer's loop: a fly-camera tour with brick streaming, every
frame shown.

One viewer, closed loop, on the port's normal path for it (the one
``render --streaming --serve`` runs): each frame is one
``LiveSession.frame`` with that frame's fly-camera input, so the camera
moves every frame, the film restarts, one 1 spp wave is traced over the
streaming manager's residency, its requests are serviced, and the film is
presented as 8 bits and handed to a ``PreviewServer`` on 127.0.0.1 that no
client fetches from.  The next frame starts when the last has been handed
over.

The tour flies from view to view of the traffic's ``views``,
``frames_per_leg`` frames a leg.  Its inputs are computed in set-up from
the waypoints (the reference's float64 fly-camera step, the same the
program takes), so that each leg ends at its view's position and angles:
each frame's rotation takes yaw and pitch a step along the leg, and its
move the position a step along the straight line.  A cycle is
``StreamingScene.reset()`` (a session restarted), the start camera and a
``torch.Generator`` seeded from the run's seed and the cycle, then the
legs; the reset runs inside the window and outside every frame's own time.
"""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np
import torch

from .. import tracing, yardstick
from ..reference import camera as rcamera, compare, live as rlive, \
    sampling as rsampling, stream as rstream, sunsky as rsunsky, \
    view as rview, world as rworld
from .view import _configs, _sync

__all__ = ["Loop", "tour_inputs"]

# The counters the traced leg reads as differences across it.
TOTALS = ("total_rebased_rows",)
PHASES = ("input", "wave", "read", "pull", "service", "present")


def _wrap(a: float) -> float:
    """``a`` taken into [-pi, pi)."""
    return (a + math.pi) % (2.0 * math.pi) - math.pi


def _angles(cam) -> tuple:
    """Yaw and pitch as the fly-camera step reads them from a direction."""
    d = np.asarray(cam.direction, np.float64)
    return math.atan2(d[0], d[1]), math.asin(max(-1.0, min(1.0, d[2])))


def tour_inputs(poses: list, per_leg: int, move_scale: float) -> list:
    """The fly-camera input of each frame of a tour through ``poses``
    ((position, yaw, pitch) each), ``per_leg`` frames from one to the next:
    ``{"move": [forward, right, up], "rot": [dyaw, dpitch]}``.  Each frame
    aims at the point ``k / per_leg`` of the way along its leg: yaw (the
    shorter way round) and pitch interpolated, the position on the straight
    line.  The inputs are solved against the camera the reference's step
    actually reaches, so rounding does not build up and each leg ends at
    its view."""
    cam = rcamera.Camera.from_angles(*poses[0])
    out = []
    for a, b in zip(poses, poses[1:]):
        yaw_a, pitch_a = _angles(rcamera.Camera.from_angles(*a))
        yaw_b, pitch_b = _angles(rcamera.Camera.from_angles(*b))
        turn = _wrap(yaw_b - yaw_a)
        pa, pb = np.asarray(a[0], np.float64), np.asarray(b[0], np.float64)
        for k in range(1, per_leg + 1):
            s = k / per_leg
            yaw, pitch = _angles(cam)
            rot = [_wrap(yaw_a + turn * s - yaw),
                   pitch_a + (pitch_b - pitch_a) * s - pitch]
            # The basis the step moves along: its forward and right vectors
            # after the rotation, and world up.
            y = yaw + rot[0]
            p = max(-rlive.PITCH_LIMIT, min(rlive.PITCH_LIMIT,
                                            pitch + rot[1]))
            fwd = np.array([math.cos(p) * math.sin(y),
                            math.cos(p) * math.cos(y), math.sin(p)])
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= max(np.linalg.norm(right), 1e-9)
            basis = np.stack([fwd, right, [0.0, 0.0, 1.0]], axis=1)
            target = pa + (pb - pa) * s
            move = np.linalg.solve(
                basis, (target - np.asarray(cam.position)) / move_scale)
            deltas = {"move": [float(m) for m in move],
                      "rot": [float(r) for r in rot]}
            out.append(deltas)
            cam = rlive.fly(cam, deltas, move_scale)
    return out


class Loop:
    name, unit = "live", "frame"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.seed, self.device = config, seed, device
        self.views = list(traffic["views"])
        self.per_leg = int(traffic["frames_per_leg"])
        self.cycle = self.per_leg * (len(self.views) - 1)
        self.cfg, self.rcfg = _configs(config)
        self.width = self.cfg.render.width
        self.height = self.cfg.render.height
        self.queue = int(config["streaming"]["queue_size"])
        self.starting_capacity = int(config["streaming"]["starting_capacity"])
        vp = config["viewpoints"]
        scale = self.cfg.grid.grid_size / vp["world_size"]
        self.poses = [(tuple(c * scale for c in vp["positions"][v]),
                       *vp["angles"][v % len(vp["angles"])])
                      for v in self.views]
        # A unit of input moves the camera by this much (render --serve's).
        self.move_scale = max(self.cfg.grid.grid_size / 128.0, 1.0)
        # The frame the reference recomputes, drawn from the seed among the
        # second cycle's frames, so that a reset lies before it.  Its
        # presentation is checked, and that of a second frame drawn from
        # the cycle's first leg, whose camera flies above the terrain: a
        # frame from inside the terrain is black, and there no fault of the
        # presentation shows.
        draw = random.Random(seed)
        self.compared = self.cycle + draw.randrange(self.cycle)
        self.shown = (self.compared, self.cycle + draw.randrange(self.per_leg))

    # ---- the program ------------------------------------------------------
    def setup(self) -> None:
        # The live path first: a program without it stops here, at once.
        from brickmap_tpu_torch.app.live import LiveSession
        from brickmap_tpu_torch import scene as scene_mod
        from brickmap_tpu_torch.ops import sunsky as ss
        from brickmap_tpu_torch.render.camera import Camera
        from brickmap_tpu_torch.stream import StreamingScene
        from brickmap_tpu_torch.utils.preview import PreviewServer

        dev = self.device
        t0 = time.perf_counter()
        self.inputs = tour_inputs(self.poses, self.per_leg, self.move_scale)
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
        self.start = Camera.from_angles(*self.poses[0])
        self.server = PreviewServer(0, host="127.0.0.1")
        self.gen = torch.Generator(device=dev)
        self.session = LiveSession(self.mgr, sun, self.width, self.height,
                                   self.cfg, self.gen, self.start,
                                   server=self.server)
        # The first leg: every kernel builds and runs, streaming at the cap
        # and under it, each frame shown.  No later frame has a new shape
        # (the pool's growth allocates, and compiles nothing).
        self._start_cycle(tracing.derive_seed(self.seed, 1 << 20))
        for k in range(self.per_leg):
            self.session.frame(self.inputs[k])
        _sync(dev)
        self.setup_parts = {"world": t1 - t0, "manager": t2 - t1,
                            "warm_up": time.perf_counter() - t2}

    def _cycle_seed(self, cycle: int) -> int:
        return tracing.derive_seed(self.seed, cycle)

    def _start_cycle(self, seed: int) -> None:
        """A session restarted: residency cold, the start camera with a
        fresh film, the generator seeded ``seed``."""
        self.mgr.reset()
        self.session.set_camera(self.start)
        self.gen.manual_seed(seed)

    def _totals(self) -> dict:
        return {k: getattr(self.mgr, k, None) for k in TOTALS}

    def run(self, seconds: float) -> dict:
        """The window: cycles of the tour back to back until ``seconds``
        have passed (and, were the window too short for it, on to the
        compared frame, untimed).  The snapshot of the residency before
        the compared frame is taken out of the window's time."""
        dev, mgr, session = self.device, self.mgr, self.session
        frames, phases, exhausted, uploads, resets, pools, legs = \
            [], [], [], [], [], [], []
        lists, shown = [], {}
        f, t_close, taken_out = 0, None, 0.0
        t_open = time.perf_counter()
        while t_close is None or f <= self.compared:
            cycle, k = divmod(f, self.cycle)
            if k == 0:
                if f and t_close is None:
                    pools.append(mgr.pool_rows)
                t = time.perf_counter()
                self._start_cycle(self._cycle_seed(cycle))
                if t_close is None:
                    resets.append(time.perf_counter() - t)
            if f == self.compared:
                t = time.perf_counter()
                state = mgr.state()
                if t_close is None:
                    taken_out += time.perf_counter() - t
            t0 = time.perf_counter()
            out = session.frame(self.inputs[k])
            t1 = time.perf_counter()
            if t_close is None:
                frames.append(t1 - t0)
                legs.append(k // self.per_leg)
                phases.append(out.seconds)
                exhausted.append(out.exhausted)
                uploads.append(out.uploads)
                if t1 - t_open - taken_out >= seconds:
                    _sync(dev)
                    t_close = time.perf_counter()
            if f in self.shown:
                shown[f] = (session.film["rgb"], session.film["count"],
                            out.image)
            if f == self.compared:
                film = session.film
                self.kept = {"state": state, "lists": lists, "k": k,
                             "cycle": cycle, "rgb": film["rgb"],
                             "count": film["count"], "traced": out.traced,
                             "pulled": out.pulled, "shown": shown,
                             "camera": session.camera}
            elif f < self.compared and cycle == self.compared // self.cycle:
                lists.append(np.asarray(out.pulled, np.int32).reshape(-1, 3))
            f += 1
        n = len(frames)
        window_s = t_close - t_open - taken_out
        self.window_exhausted = sum(exhausted)
        self.window_over_queue = sum(u > self.queue for u in uploads)
        full = sum(u == self.queue for u in uploads)

        def ms(name):
            v = [p[name] for p in phases]
            return (f"{name} {yardstick.percentile(v, 50) * 1e3:.3f} / "
                    f"{sum(v) / n * 1e3:.3f}")

        def leg_ms(name, which):
            v = [t for t, j in zip(frames, legs) if j in which]
            return (f"{name} {yardstick.percentile(v, 50) * 1e3:.3f} / "
                    f"{sum(v) / len(v) * 1e3:.3f}") if v else f"{name} -"

        # View 3 (z = 44.8) lies under the terrain, so most of the last
        # leg's frames are traced from inside the ground: the first two
        # legs are the frames a user flying above the terrain sees.
        print("h100bench: live frame ms p50 / mean by leg: " + ", ".join(
            leg_ms(f"{j}->{j + 1}", (j,)) for j in range(len(self.views) - 1))
            + ", " + leg_ms("lit legs 0->2", (0, 1)), file=sys.stderr,
            flush=True)
        print(f"h100bench: live {n} frames, {len(resets)} resets "
              f"(mean {sum(resets) / len(resets) * 1e3:.3f} ms); uploads a "
              f"frame min / mean / max {min(uploads)} / "
              f"{sum(uploads) / n:.1f} / {max(uploads)}, {full} frames at "
              f"the cap of {self.queue}; pool rows at each cycle's end "
              f"{pools}; host ms a frame p50 / mean: "
              + ", ".join(map(ms, PHASES)), file=sys.stderr, flush=True)
        return {"units": n, "seconds": window_s,
                "failed": sum(e > 0 or u > self.queue
                              for e, u in zip(exhausted, uploads)),
                "metrics": {"frame_ms": window_s / n * 1e3,
                            "frame_p95_ms": yardstick.percentile(
                                frames, 95) * 1e3},
                "spans": {"frame": frames}}

    def profile(self) -> dict:
        """The second leg of a fresh cycle under the profiler.  The
        profiler runs its sub-window twice and keeps the second: the first
        call is the reset and the first leg (what leads up to the second
        leg, traced and thrown away), the second call the second leg.  The
        manager's counters are read as differences across it."""
        session, legs = self.session, []

        def leg(first: int) -> int:
            for k in range(first, first + self.per_leg):
                session.frame(self.inputs[k])
            return self.per_leg

        def sub_window():
            if not legs:
                legs.append(None)
                self._start_cycle(tracing.derive_seed(self.seed, 1 << 21))
                return leg(0)
            legs.append(self._totals())
            return leg(self.per_leg)

        ctx = tracing.profiled(sub_window, self.device, self.name)
        before, after = legs[1], self._totals()
        ctx["live_totals"] = {k: None if before[k] is None
                              else after[k] - before[k] for k in TOTALS}
        ctx["live_pixels"] = self.width * self.height
        return ctx

    # ---- the reference ----------------------------------------------------
    def ref_camera(self, k: int, dtype=np.float64):
        """The reference's camera after the cycle's inputs up to frame
        ``k``, from the start camera (its step in ``dtype``)."""
        cam = rcamera.Camera.from_angles(*self.poses[0])
        for deltas in self.inputs[:k + 1]:
            cam = rlive.fly(cam, deltas, self.move_scale, dtype)
        return cam

    def ref_frame(self, world, cam, cycle: int, draws: int, quant=None):
        """The reference's wave through ``cam`` over ``world`` whose
        uniforms are the ``draws``-th draw of the cycle's generator: (rgb,
        count, traced, exhausted, req)."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._cycle_seed(cycle))
        for _ in range(draws):
            u = rsampling.draw_wave_uniforms(
                self.width * self.height, self.rcfg.render.max_bounces, gen,
                dev)
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

    def replay(self, cls=rstream.Manager, truth=None, quant=None,
               dtype=np.float64) -> dict:
        """A reference manager (``cls``) fed the compared cycle's pulled
        lists up to the compared frame, the camera flown through the
        cycle's inputs up to it (the step in ``dtype``), then that frame
        traced over the manager's state: the numbers a run compares."""
        kept = self.kept
        ref = self.ref_manager(cls, truth)
        for got in kept["lists"]:
            ref.process(got)
        cam = self.ref_camera(kept["k"], dtype)
        rgb, count, traced, exh, req = self.ref_frame(
            ref.world(self.device), cam, kept["cycle"], kept["k"] + 1, quant)
        return {"state": ref.state(), "camera": cam, "rgb": rgb,
                "count": count, "traced": traced, "exhausted": exh,
                "pulled": rstream.pull(req, self.queue)}

    def frames_differ(self, half: float = 0.5) -> int:
        """The bytes of the 8-bit frames the server received for the
        shown frames (the compared one and the first leg's drawn one) that
        differ from the reference's presentation of the program's films,
        its rounding's offset ``half`` (the calibration's control passes
        0)."""
        return sum(rlive.frames_differ(image, rlive.present(
            rgb, count, self.width, self.height, half).cpu())
            for rgb, count, image in self.kept["shown"].values())

    def check(self, trace: bool):
        """The numbers compared with the reference: the program's truth
        against the world built again; the residency before the compared
        frame against a reference manager's replay of the same request
        lists; the camera after the cycle's inputs against the reference's
        step; the frame and its requests against the reference's over that
        state through that camera; and the 8-bit frames the server received
        for the compared frame and the first leg's drawn one against the
        reference's presentation of the program's own films."""
        kept, dev = self.kept, self.device
        self.server.close()
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
        checks["pose_differ"] = float(rlive.pose_differ(kept["camera"],
                                                        ref["camera"]))
        checks["state_differ"] = float(rstream.state_differ(kept["state"],
                                                            ref["state"]))
        checks["frame8_differ"] = float(self.frames_differ())
        checks["px_differ"] = compare.pixels_differ(
            kept["rgb"], kept["count"], ref["rgb"], ref["count"])
        checks["traced_gap"] = compare.relative_gap(kept["traced"],
                                                    ref["traced"])
        checks["requests_differ"] = rstream.requests_differ(kept["pulled"],
                                                            ref["pulled"])
        checks["exhausted"] = float(self.window_exhausted)
        checks["uploads_over_queue"] = float(self.window_over_queue)
        return checks, {}
