"""Config 1 end-to-end: render a single 8x8x8 brick through kernel B1.

The port of ``brickmap_tpu/pallas/single_brick.py`` (BASELINE config 1,
``config.py:216``): camera rays are clipped to the brick's box with torch ops,
kernel B1 (:func:`brickmap_tpu_torch.kernels.brick.trace_single_brick`)
traverses, and shading is a face-normal lambert against the sun.
"""

from __future__ import annotations

import torch

from .kernels.brick import trace_single_brick
from .ops import sunsky as sunsky_mod
from .render.camera import Camera, primary_rays
from .render.sampling import draw_wave_uniforms

__all__ = ["render_single_brick"]


def render_single_brick(words, camera: Camera, width: int, height: int,
                        sun_direction, uniforms=None, generator=None,
                        device="cuda"):
    """Primary-ray render of one brick occupying [0,8)^3 world units.

    ``uniforms``: the primary rays' ``stratum``/``jitter``/``lens`` draws
    (:func:`~brickmap_tpu_torch.render.sampling.draw_wave_uniforms`), drawn
    from ``generator`` when None.  Returns (rgb [H, W, 3] float32 in [0,1],
    hit mask [H, W]).
    """
    if uniforms is None:
        uniforms = draw_wave_uniforms(width * height, 0, generator, device)
    origins, dirs, _ = primary_rays(uniforms["stratum"], uniforms["jitter"],
                                    uniforms["lens"], camera, width, height,
                                    device)

    # AABB clip to the brick (slab test; voxel.cuh:13-24 semantics).
    rd = torch.where(dirs == 0.0, 0.0, 1.0 / dirs)
    t1 = (0.0 - origins) * rd
    t2 = (8.0 - origins) * rd
    lo = torch.where(dirs == 0.0, -torch.inf, torch.minimum(t1, t2))
    hi = torch.where(dirs == 0.0, torch.inf, torch.maximum(t1, t2))
    tenter = torch.clamp(lo.amax(dim=1), min=0.0)
    texit = hi.amin(dim=1)
    valid = texit > tenter
    clipped = origins + dirs * (tenter + 1e-3)[:, None]

    res = trace_single_brick(clipped, dirs, words)
    hit = res["hit"] & valid
    axis = res["axis"]

    # Face normal from the hit axis + direction sign (voxel.cuh:114-117).
    sign = torch.gather(torch.sign(dirs), 1,
                        torch.clamp(axis, min=0).long()[:, None])[:, 0]
    axes = torch.arange(3, device=dirs.device)
    normal = torch.where((axis[:, None] == axes[None, :])
                         & (axis >= 0)[:, None], -sign[:, None], 0.0)

    sun = torch.as_tensor(sun_direction, device=dirs.device).to(torch.float32)
    lambert = torch.clamp((normal * sun[None, :]).sum(1), 0.0, 1.0)
    albedo = torch.tensor([0.8, 0.6, 0.4], dtype=torch.float32,
                          device=dirs.device)
    lit = albedo[None, :] * (0.25 + 0.75 * lambert)[:, None]

    sky = sunsky_mod.sunsky(dirs, sun)
    rgb = torch.where(hit[:, None], lit, torch.clamp(sky, 0.0, 1.0))
    return rgb.reshape(height, width, 3), hit.reshape(height, width)
