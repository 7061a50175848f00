"""The live viewer's frame: one program path for the CLI and a benchmark.

The reference's interactive window (``main.cpp:26-190``) does the same
four things every frame: it takes the fly camera's input and moves the
camera (``main.cpp:119-127``, ``camera.cpp:3-46``), restarting
accumulation when the camera moved (``kernel.cu:387-403``); it traces a
sample wave into the film; it services that frame's brick requests when
streaming (``Scene.cpp:200-252``); and it shows the frame
(``blit_onto_framebuffer``, ``kernel.cu:357-362``).  :class:`LiveSession`
holds that frame's state (the camera, its arrays, the film, the scene or
streaming manager, the generator and an optional preview server) and
:meth:`LiveSession.frame` runs one.  ``render``'s viewer loop
(``app/cli.py::cmd_render``) is calls of it.

Spans (``utils/profiling.py``): ``bm.live.frame`` around a frame, holding
``bm.live.input`` (the fly-camera step, the camera arrays and the fresh
film), the wave's ``bm.wave``, streaming's ``bm.stream.*`` and
``bm.live.present`` (W5, the 8-bit frame's copy to the host and the hand-off
to the server).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import BrickmapConfig
from ..render import pathtrace
from ..render.camera import Camera, camera_arrays_for
from ..stream import StreamingScene, pull_requests
from ..utils.profiling import annotate

__all__ = ["LiveSession", "LiveFrame"]


def _apply_camera_input(cam, deltas, move_scale: float):
    """Fly-camera update from preview input deltas (camera.cpp:3-46):
    move = [forward, right, up] impulses, rot = [dyaw, dpitch] radians."""
    d = np.asarray(cam.direction, np.float64)
    yaw = math.atan2(d[0], d[1])            # camera.cpp:49-53 convention
    pitch = math.asin(max(-1.0, min(1.0, d[2])))
    yaw += deltas["rot"][0]
    pitch = max(-1.55, min(1.55, pitch + deltas["rot"][1]))
    fwd = np.array([math.cos(pitch) * math.sin(yaw),
                    math.cos(pitch) * math.cos(yaw), math.sin(pitch)])
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= max(np.linalg.norm(right), 1e-9)
    pos = (np.asarray(cam.position, np.float64)
           + move_scale * (deltas["move"][0] * fwd
                           + deltas["move"][1] * right
                           + deltas["move"][2] * np.array([0.0, 0.0, 1.0])))
    return Camera.from_angles(tuple(pos), yaw, pitch,
                              focal_distance=cam.focal_distance,
                              lens_radius=cam.lens_radius)


@dataclass(frozen=True)
class LiveFrame:
    """What one :meth:`LiveSession.frame` did.

    ``traced``/``exhausted``: the wave's ray counters; ``uploads``: bricks
    installed (0 without streaming); ``pulled``: the wave's pulled
    requests (None without streaming); ``image``: the 8-bit frame on the
    host, uint8 [H, W, 3] (None when not presented); ``seconds``: host
    seconds of each phase: ``input``, ``wave`` (``render_wave`` and
    ``film_add``), ``read`` (the counters, which waits for the wave),
    ``pull``, ``service`` and ``present``."""

    traced: int
    exhausted: int
    uploads: int
    pulled: object
    image: np.ndarray | None
    seconds: dict


class LiveSession:
    """One viewer's frames over ``scene`` (a resident
    :class:`~brickmap_tpu_torch.scene.TorchScene`, or a
    :class:`~brickmap_tpu_torch.stream.StreamingScene` whose requests each
    frame services), lit by ``sun`` (a direction), at ``width`` x
    ``height`` with ``cfg``, drawing every wave's uniforms from
    ``generator``, from ``camera``.  ``server`` (a
    :class:`~brickmap_tpu_torch.utils.preview.PreviewServer`) receives
    every presented frame.  ``move_scale`` is the voxels a unit of input
    moves the camera: the world's size / 128, at least 1.

    ``camera``, ``film`` and ``manager`` (the streaming manager, or None)
    are the session's state; the film accumulates until the camera
    changes."""

    def __init__(self, scene, sun, width: int, height: int,
                 cfg: BrickmapConfig, generator: torch.Generator,
                 camera: Camera, server=None):
        streaming = isinstance(scene, StreamingScene)
        self.manager = scene if streaming else None
        self._scene = None if streaming else scene
        self.device = torch.device(scene.device)
        self.sun = sun
        self.width, self.height, self.cfg = width, height, cfg
        self.generator = generator
        self.server = server
        self.move_scale = max(cfg.grid.grid_size / 128.0, 1.0)
        self._look(camera)

    def _look(self, camera: Camera) -> None:
        """Look through ``camera`` with a fresh film."""
        self.camera = camera
        self.arrays = camera_arrays_for(camera, self.sun, self.width,
                                        self.height, self.device)
        self.film = pathtrace.film_init(self.width, self.height, self.device)

    def set_camera(self, camera: Camera) -> None:
        """Look through ``camera``; if it differs from the current one, the
        film restarts (the reference's accumulation reset)."""
        if camera != self.camera:
            self._look(camera)

    def image(self) -> np.ndarray:
        """The film as the 8-bit frame on the host, uint8 [H, W, 3]
        (:func:`~brickmap_tpu_torch.render.pathtrace.present`)."""
        return pathtrace.present(self.film, self.width,
                                 self.height).cpu().numpy()

    def frame(self, deltas: dict | None = None, present: bool = True,
              **stats) -> LiveFrame:
        """One frame: ``deltas`` (the fly camera's ``{"move": [f, r, u],
        "rot": [dyaw, dpitch]}``; None: no input) move the camera by the
        fly-camera step (``_apply_camera_input``) and restart the film;
        a sample wave is traced and added to the film and its counters
        read; when streaming, its requests are pulled and serviced; with
        ``present``, the film is shown as 8 bits and handed to the server
        with ``stats`` and the wave's ``wave_ms``, ``mrays_s`` and
        ``camera``."""
        with annotate("bm.live.frame"):
            t0 = time.perf_counter()
            if deltas is not None:
                with annotate("bm.live.input"):
                    self._look(_apply_camera_input(self.camera, deltas,
                                                   self.move_scale))
            t1 = time.perf_counter()
            scene = self._scene if self.manager is None \
                else self.manager.device_scene()
            rgb, count, req = pathtrace.render_wave(
                scene, self.arrays, self.camera.brick_position, self.cfg,
                self.width, self.height, generator=self.generator)
            self.film = pathtrace.film_add(self.film, rgb, count)
            t2 = time.perf_counter()
            traced = int(req["traced_rays"])      # waits for the wave
            exhausted = int(req["exhausted_rays"])
            t3 = time.perf_counter()
            pulled, uploads, t4 = None, 0, t3
            if self.manager is not None:
                # The per-frame CPU half of streaming (main.cpp:144 ->
                # Scene::process_load_queue): the next wave traces the new
                # residency.
                pulled = pull_requests(req, self.manager.queue_size)
                t4 = time.perf_counter()
                if pulled:
                    uploads = self.manager.process_requests(pulled)
            t5 = time.perf_counter()
            image = None
            if present:
                with annotate("bm.live.present"):
                    image = self.image()
                    if self.server is not None:
                        dt = t3 - t1
                        self.server.update(
                            image, **stats, wave_ms=round(dt * 1000, 1),
                            mrays_s=round(traced / dt / 1e6, 2),
                            camera=[round(p, 1)
                                    for p in self.camera.position])
            t6 = time.perf_counter()
        return LiveFrame(traced, exhausted, uploads, pulled, image, {
            "input": t1 - t0, "wave": t2 - t1, "read": t3 - t2,
            "pull": t4 - t3, "service": t5 - t4, "present": t6 - t5})
