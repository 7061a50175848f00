# Frozen copy of brickmap_tpu_torch/render/camera.py, the
# benchmark's plain reference: it imports nothing of the port, and later
# changes to the port do not reach it.  Only its imports were changed.
"""Camera model and primary-ray generation on torch tensors.

The port of ``brickmap_tpu/render/camera.py``: the reference's fly camera
(``camera.h:3-24``, ``camera.cpp:48-54``) and primary-ray kernel
(``kernel.cu:154-222``): pinhole + thin-lens DoF with stratified 4x4 in-pixel
jitter, and the launcher's 1.5*aspect-scaled basis (``kernel.cu:384-385``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .sampling import concentric_disk, stratified_2d

__all__ = ["Camera", "camera_basis", "camera_arrays_for", "primary_rays",
           "primary_rays_from_arrays"]


@dataclass(frozen=True)
class Camera:
    position: tuple = (512.0, 512.0, 300.0)   # camera.h:4
    direction: tuple = (1.0, 0.0, 0.0)
    up: tuple = (0.0, 0.0, 1.0)
    focal_distance: float = 1.0
    lens_radius: float = 0.0

    @classmethod
    def from_angles(cls, position, horizontal: float, vertical: float,
                    **kw) -> "Camera":
        """Direction from yaw/pitch (camera.cpp:49-53)."""
        d = np.array([
            math.cos(vertical) * math.sin(horizontal),
            math.cos(vertical) * math.cos(horizontal),
            math.sin(vertical),
        ])
        d /= np.linalg.norm(d)
        return cls(position=tuple(float(p) for p in position),
                   direction=tuple(d), **kw)

    def replace(self, **kw) -> "Camera":
        return replace(self, **kw)

    @property
    def brick_position(self) -> tuple:
        """Truncated camera position in brick units — the traversal's LoD
        origin (kernel.cu:418 passes camera.position / 8 as ivec3)."""
        return tuple(int(p / 8.0) for p in self.position)


def camera_basis(camera: Camera, width: int, height: int):
    """(right, up) screen basis scaled by 1.5*aspect / 1.5 (kernel.cu:384-385)."""
    d = np.asarray(camera.direction, np.float32)
    up = np.asarray(camera.up, np.float32)
    right = np.cross(d, up)
    right = right / np.linalg.norm(right) * 1.5 * (width / height)
    up2 = np.cross(right, d)
    up2 = up2 / np.linalg.norm(up2) * 1.5
    return right.astype(np.float32), up2.astype(np.float32)


def camera_arrays_for(camera: Camera, sun_direction, width: int, height: int,
                      device="cuda") -> dict:
    """The camera and sun inputs of the render functions as tensors."""
    right, up2 = camera_basis(camera, width, height)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    d = f32(camera.direction)
    return {
        "position": f32(camera.position),
        "direction": d / torch.sqrt((d * d).sum()),
        "right": f32(right),
        "up": f32(up2),
        "focal_distance": f32(camera.focal_distance),
        "lens_radius": f32(camera.lens_radius),
        "sun_direction": torch.as_tensor(sun_direction, device=device).to(
            torch.float32),
    }


def primary_rays_from_arrays(stratum, jitter, lens_uv, camera_arrays, idx,
                             width: int, height: int,
                             focal_slider_scale: float = 3.0):
    """Camera rays for explicit pixel indices ``idx`` -> (origins, dirs).

    Stratified 4x4 in-pixel jitter + thin-lens DoF per kernel.cu:170-198
    (including the ``ImGui_slider_hack`` 3x focal scale).  ``stratum``
    [n] int, ``jitter`` [n, 2] and ``lens_uv`` [n, 2] are the lanes' uniforms
    (:func:`brickmap_tpu_torch.render.sampling.draw_wave_uniforms`).
    """
    x = (idx % width).to(torch.float32)
    y = (idx // width).to(torch.float32)

    j = stratified_2d(stratum, jitter)
    px = x - j[:, 0]
    py = y - j[:, 1]
    ni = px / width - 0.5
    nj = (height - py) / height - 0.5

    origin = camera_arrays["position"]
    to_focal = (camera_arrays["direction"][None, :]
                + ni[:, None] * camera_arrays["right"]
                + nj[:, None] * camera_arrays["up"])
    to_focal = to_focal / torch.sqrt((to_focal * to_focal).sum(1, keepdim=True))
    converge = origin + (camera_arrays["focal_distance"]
                         * focal_slider_scale) * to_focal

    p_lens = camera_arrays["lens_radius"] * concentric_disk(lens_uv)
    origins = (origin[None, :]
               + camera_arrays["right"][None, :] * p_lens[:, 0:1]
               + camera_arrays["up"][None, :] * p_lens[:, 1:2])
    dirs = converge - origins
    dirs = dirs / torch.sqrt((dirs * dirs).sum(1, keepdim=True))
    return origins, dirs


def primary_rays(stratum, jitter, lens_uv, camera: Camera, width: int,
                 height: int, device="cuda", focal_slider_scale: float = 3.0):
    """Camera rays for every pixel in row-major order: ([N,3] origins,
    [N,3] dirs, [N] pixel ids)."""
    idx = torch.arange(width * height, dtype=torch.int32, device=device)
    arrays = camera_arrays_for(camera, torch.zeros(3), width, height, device)
    origins, dirs = primary_rays_from_arrays(
        stratum, jitter, lens_uv, arrays, idx, width, height,
        focal_slider_scale)
    return origins, dirs, idx
