"""The live viewer as the reference renderer defines it, written out plainly.

Written from the reference's semantics (stijnherfst/BrickMap), not from the
port's ``app/live.py``: a frame takes the fly camera's input
(``main.cpp:119-127``, ``camera.cpp:3-46``), restarts accumulation when the
camera moved (``kernel.cu:387-403``), traces a wave, services its brick
requests (``stream.py`` here) and shows the film as 8 bits a channel
(``blit_onto_framebuffer``, ``kernel.cu:357-362``).

* :func:`fly`: the fly-camera step in float64 NumPy: yaw and pitch read
  from the camera's direction (``camera.cpp:49-53``), the input's rotation
  added with the pitch held within +-1.55, then the position moved along
  the new forward and right vectors and world up;
* :func:`present`: the film count-normalised, clamped at 0, raised to
  1/2.2, clamped to [0, 1], then x 255 + 0.5 and truncated to 8 bits,
  each step in float32 torch on the film's device;
* :func:`present_bytes`: the least bytes the presentation moves, for the
  yardstick.

Plain Python, NumPy and torch; nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .camera import Camera

__all__ = ["fly", "present", "present_bytes", "pose", "pose_differ",
           "frames_differ"]

PITCH_LIMIT = 1.55


def fly(cam: Camera, deltas: dict, move_scale: float,
        dtype=np.float64) -> Camera:
    """The camera after one frame's input ``deltas`` (``{"move": [forward,
    right, up], "rot": [dyaw, dpitch]}``), a unit of move being
    ``move_scale`` voxels.  ``dtype`` is the precision of the vectors (the
    reference's float64; a control passes float32)."""
    f = dtype
    d = np.asarray(cam.direction, f)
    yaw = math.atan2(d[0], d[1])
    pitch = math.asin(max(-1.0, min(1.0, d[2])))
    yaw += deltas["rot"][0]
    pitch = max(-PITCH_LIMIT, min(PITCH_LIMIT, pitch + deltas["rot"][1]))
    forward = np.array([math.cos(pitch) * math.sin(yaw),
                        math.cos(pitch) * math.cos(yaw), math.sin(pitch)], f)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0], f))
    right /= max(np.linalg.norm(right), f(1e-9))
    up = np.array([0.0, 0.0, 1.0], f)
    position = (np.asarray(cam.position, f)
                + f(move_scale) * (f(deltas["move"][0]) * forward
                                   + f(deltas["move"][1]) * right
                                   + f(deltas["move"][2]) * up))
    return Camera.from_angles(tuple(position), yaw, pitch,
                              focal_distance=cam.focal_distance,
                              lens_radius=cam.lens_radius)


def present(rgb, count, width: int, height: int,
            half: float = 0.5) -> torch.Tensor:
    """The 8-bit frame of a film's sums ``rgb`` [N, 3] and counts ``count``
    [N]: uint8 [height, width, 3] on their device.  ``half`` is the
    rounding's offset (a control passes 0)."""
    c = torch.clamp(count[:, None], min=1e-8)
    img = torch.clamp(rgb / c, min=0.0) ** (1.0 / 2.2)
    img = torch.clamp(img, 0.0, 1.0)
    return (img * 255.0 + half).to(torch.uint8).reshape(height, width, 3)


def present_bytes(pixels: int) -> int:
    """The least bytes the presentation of ``pixels`` pixels moves: each
    pixel's sums and count read (16 B) and its three channels written
    (3 B)."""
    return 19 * pixels


def pose(cam: Camera) -> tuple:
    """The camera's position and direction as six floats."""
    return (*cam.position, *cam.direction)


def pose_differ(got, want) -> int:
    """The components of two poses that differ at all."""
    return int(sum(a != b for a, b in zip(pose(got), pose(want))))


def frames_differ(got, want) -> int:
    """The bytes that differ between two 8-bit frames (every byte of the
    larger where their shapes differ)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return max(got.size, want.size)
    return int((got != want).sum())
