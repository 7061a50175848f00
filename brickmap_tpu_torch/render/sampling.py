"""Sampling primitives as pure transforms of uniforms the caller draws.

The port of ``brickmap_tpu/render/sampling.py``.  JAX draws inside each
sampler from a threefry key; torch cannot reproduce those bits, so every
sampler here takes its uniforms as arguments.  :func:`draw_wave_uniforms`
draws a whole wave's worth from a ``torch.Generator``; the tests inject the
JAX wave's own draws instead, and the transforms then agree to float rounding.

* stratified 4x4 pixel jitter      — kernel.cu:40-61
* concentric disk (thin-lens DoF)  — kernel.cu:85-103
* naive orthonormal basis          — kernel.cu:76-84
* cosine-weighted hemisphere       — kernel.cu:287-296
* solar cone sample                — sunsky.cu:163-184
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "draw_wave_uniforms",
    "empty_wave_uniforms",
    "stratified_2d",
    "concentric_disk",
    "orthonormal_basis",
    "cosine_hemisphere",
    "cone_sample",
    "ortho_vector",
]


def draw_wave_uniforms(n: int, max_bounces: int, generator=None,
                       device="cuda", out: dict | None = None) -> dict:
    """Every uniform one sample wave of ``n`` lanes consumes, in lane order:

    * ``stratum`` int64 [n] in [0, 16) and ``jitter`` [n, 2]: pixel jitter;
    * ``lens`` [n, 2]: thin-lens sample;
    * ``cone`` [bounces+1, 2, n]: sun-cone (azimuth, cos) uniforms per bounce;
    * ``hemi`` [bounces+1, 2, n]: bounce-direction uniforms per bounce.

    New tensors on ``device``, or, with ``out`` (a dict of those tensors,
    e.g. a captured wave's inputs), drawn in place into it: the same bits.
    """
    if out is None:
        def u(*shape):
            return torch.rand(shape, generator=generator, device=device)

        return {"stratum": torch.randint(0, 16, (n,), generator=generator,
                                         device=device),
                "jitter": u(n, 2), "lens": u(n, 2),
                "cone": u(max_bounces + 1, 2, n),
                "hemi": u(max_bounces + 1, 2, n)}
    out["stratum"].random_(0, 16, generator=generator)
    for k in ("jitter", "lens", "cone", "hemi"):
        out[k].uniform_(generator=generator)
    return out


def empty_wave_uniforms(n: int, max_bounces: int, device="cuda") -> dict:
    """:func:`draw_wave_uniforms`' tensors, allocated and not drawn."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    return {"stratum": empty(n, dtype=torch.int64), "jitter": empty(n, 2),
            "lens": empty(n, 2), "cone": empty(max_bounces + 1, 2, n),
            "hemi": empty(max_bounces + 1, 2, n)}


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def stratified_2d(stratum: torch.Tensor, jitter: torch.Tensor,
                  width: int = 4, height: int = 4) -> torch.Tensor:
    """[n, 2] stratified samples on [0,1]^2 from a stratum index and an
    in-stratum jitter (Random2DStratifiedSample, kernel.cu:40-61)."""
    sx = (stratum % width).to(torch.float32)
    sy = ((stratum // width) % height).to(torch.float32)
    return torch.stack([(sx + jitter[:, 0]) / width,
                        (sy + jitter[:, 1]) / height], dim=1)


def concentric_disk(u: torch.Tensor) -> torch.Tensor:
    """Map [n, 2] uniforms to the unit disk, area-preserving
    (ConcentricSampleDisk, kernel.cu:85-103)."""
    off = 2.0 * u - 1.0
    x, y = off[..., 0], off[..., 1]
    zero = (x == 0) & (y == 0)
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    safe_x = torch.where(x == 0, 1.0, x)
    safe_y = torch.where(y == 0, 1.0, y)
    theta = torch.where(use_x, (math.pi / 4) * (y / safe_x),
                        (math.pi / 2) - (math.pi / 4) * (x / safe_y))
    pt = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero[..., None], 0.0, pt)


def orthonormal_basis(w: torch.Tensor):
    """(u, v) completing unit [..., 3] w to an orthonormal frame
    (computeOrthonormalBasisNaive, kernel.cu:76-84)."""
    near_x = torch.abs(w[..., 0]) > 0.9
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    pick = torch.where(near_x[..., None], e_y, e_x)
    u = torch.linalg.cross(pick, w)
    u = u / _norm(u)
    v = torch.linalg.cross(w, u)
    return u, v


def cosine_hemisphere(u1: torch.Tensor, u2: torch.Tensor,
                      normal: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted bounce directions about [..., 3] normals from two
    uniforms per lane (shade kernel, kernel.cu:287-296)."""
    r1 = 2.0 * math.pi * u1
    r2s = torch.sqrt(u2)
    u, v = orthonormal_basis(normal)
    d = (u * (torch.cos(r1) * r2s)[..., None]
         + v * (torch.sin(r1) * r2s)[..., None]
         + normal * torch.sqrt(1.0 - u2)[..., None])
    return d / _norm(d)


def ortho_vector(v: torch.Tensor) -> torch.Tensor:
    """Any vector orthogonal to v (ortho, sunsky.cu:163-166)."""
    zero = torch.zeros_like(v[..., 0])
    use_x = torch.abs(v[..., 0]) > torch.abs(v[..., 2])
    a = torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)
    b = torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1)
    return torch.where(use_x[..., None], a, b)


def cone_sample(u1: torch.Tensor, u2: torch.Tensor, direction: torch.Tensor,
                extent: float) -> torch.Tensor:
    """Uniform directions in a cone of ``extent`` about ``direction`` ([3],
    broadcast to the uniforms' shape) from two uniforms per lane
    (getConeSample, sunsky.cu:170-184)."""
    direction = direction.to(torch.float32)
    direction = direction / _norm(direction)
    direction = direction.expand(*u1.shape, 3)
    o1 = ortho_vector(direction)
    o1 = o1 / _norm(o1)
    o2 = torch.linalg.cross(direction, o1)
    o2 = o2 / _norm(o2)
    rx = u1 * 2.0 * math.pi
    # ry is within ~1e-3 of 1, so 1 - ry^2 cancels and one rounding more or
    # less moves the sample by ~1e-5.  Both 1 - u2*extent and 1 - ry^2 are
    # formed in float64 (the products of float32 values are exact there) and
    # rounded once, as the fused multiply-adds of the reference's CUDA and of
    # XLA round them.
    ext32 = torch.tensor(extent, dtype=torch.float32).to(torch.float64)
    ry = (1.0 - u2.to(torch.float64) * ext32).to(torch.float32)
    rd = ry.to(torch.float64)
    oneminus = torch.sqrt((1.0 - rd * rd).to(torch.float32))
    return (torch.cos(rx)[..., None] * oneminus[..., None] * o1
            + torch.sin(rx)[..., None] * oneminus[..., None] * o2
            + ry[..., None] * direction)
