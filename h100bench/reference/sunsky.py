# Frozen copy of brickmap_tpu_torch/ops/sunsky.py, the
# benchmark's plain reference: it imports nothing of the port, and later
# changes to the port do not reach it.  Only its imports were changed.
"""Preetham-style analytic sun/sky radiance on torch tensors.

The port of ``brickmap_tpu/ops/sunsky.py`` (the reference's adapted GLSL
scattering model, ``sunsky.cu:10-161``; constants ``sunsky.cuh:24-42``).  The
operations run in float32 in the JAX module's order, so the two agree to a few
ulp.

* :func:`sun`     — NEE radiance along a sampled sun-cone direction (sunsky.cu:32-74)
* :func:`sky`     — sky radiance for bounce-miss rays (sunsky.cu:76-114)
* :func:`sunsky`  — sky + solar disc for primary-miss rays (sunsky.cu:116-161)

All take view directions [..., 3] and a sun direction [3] on one device.
"""

from __future__ import annotations

import math

import torch

from .config import SunSkyConfig

__all__ = ["sun", "sky", "sunsky", "sun_direction_from_position", "cone_extent"]

_F32 = torch.float32
# Rayleigh total scattering coefficients at the primary wavelengths.
RAYLEIGH = (5.176821e-6, 1.2785348e-5, 2.8530756e-5)


def sun_direction_from_position(sun_position, device="cuda") -> torch.Tensor:
    """Spherical-coordinate sun direction from the UI's 2-D sun position
    (kernel.cu:393: ``fromSpherical((pos - (0, 0.5)) * (6.28, 3.14))``)."""
    p = ((torch.as_tensor(sun_position, dtype=_F32, device=device)
          - torch.tensor([0.0, 0.5], dtype=_F32, device=device))
         * torch.tensor([6.28, 3.14], dtype=_F32, device=device))
    d = torch.stack([torch.cos(p[0]) * torch.sin(p[1]),
                     torch.sin(p[0]) * torch.sin(p[1]),
                     torch.cos(p[1])])
    return d / torch.sqrt((d * d).sum())


def cone_extent(cfg: SunSkyConfig) -> float:
    """Solar-cone extent used for NEE sampling: 1 - cos(angular diameter)."""
    return 1.0 - cfg.sun_angular_diameter_cos


def _rayleigh_phase(cos_vs):
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_vs ** 2)


def _hg_phase(cos_vs, g):
    return (1.0 / (4.0 * math.pi)) * (
        (1.0 - g ** 2) / (1.0 - 2.0 * g * cos_vs + g ** 2) ** 1.5)


def _total_mie(cfg: SunSkyConfig, device):
    wavelengths = torch.tensor(cfg.primary_wavelengths, dtype=_F32,
                               device=device)
    k = torch.tensor(cfg.k, dtype=_F32, device=device)
    c = (0.2 * cfg.turbidity) * 10e-18
    return 0.434 * c * math.pi * (2.0 * math.pi / wavelengths) ** (
        cfg.v - 2.0) * k


def _sun_intensity(cos_zenith, cfg: SunSkyConfig):
    return cfg.sun_intensity * torch.clamp(
        1.0 - torch.exp(-((cfg.cutoff_angle - torch.arccos(cos_zenith))
                          / cfg.steepness)), min=0.0)


def _common(view_dir, sun_dir, cfg: SunSkyConfig):
    """Shared scattering core (sunsky.cu:33-67 et al.): returns
    (sun_e, fex [..., 3], sky_term [..., 3], cos_view_sun)."""
    view_dir = view_dir.to(_F32)
    sun_dir = sun_dir.to(_F32)
    dev = view_dir.device

    cos_view_sun = (view_dir * sun_dir).sum(-1)
    cos_sun_up = sun_dir[..., 2]
    cos_up_view = view_dir[..., 2]

    sun_e = _sun_intensity(cos_sun_up, cfg)

    rayleigh = torch.tensor(RAYLEIGH, dtype=_F32, device=dev)
    mie = _total_mie(cfg, dev) * cfg.mie_coefficient

    zenith = torch.clamp(cos_up_view, min=0.0)
    # 1/0 -> inf -> exp(-inf) = 0 below the horizon, as in the reference.
    rayleigh_len = cfg.rayleigh_zenith_length / zenith
    mie_len = cfg.mie_zenith_length / zenith

    fex = torch.exp(-(rayleigh * rayleigh_len[..., None]
                      + mie * mie_len[..., None]))

    rayleigh_to_eye = rayleigh * _rayleigh_phase(cos_view_sun)[..., None]
    mie_to_eye = mie * _hg_phase(cos_view_sun, cfg.mie_directional_g)[..., None]

    some = sun_e[..., None] * ((rayleigh_to_eye + mie_to_eye)
                               / (rayleigh + mie))
    sky_term = some * (1.0 - fex)
    horizon_mix = torch.clamp((1.0 - cos_sun_up) ** 5, 0.0, 1.0)
    sky_term = sky_term * ((1.0 - horizon_mix)
                           + torch.sqrt(some * fex) * horizon_mix)
    return sun_e, fex, sky_term, cos_view_sun


def sun(view_dir, sun_dir, cfg: SunSkyConfig = SunSkyConfig()):
    """Solar radiance along a sampled cone direction (sunsky.cu:32-74)."""
    sun_e, fex, _, cos_vs = _common(view_dir, sun_dir, cfg)
    # Reference quirk (sunsky.cu:70): the disc test degenerates to
    # "cos_sadc < (cos_vs != 0 ? 1 : 0)", i.e. 1 whenever the angle is nonzero.
    disc = torch.where(cos_vs != 0.0,
                       float(cfg.sun_angular_diameter_cos < 1.0),
                       float(cfg.sun_angular_diameter_cos < 0.0)).to(_F32)
    return 0.01 * (sun_e[..., None] * 19000.0 * fex) * disc[..., None]


def sky(view_dir, sun_dir, cfg: SunSkyConfig = SunSkyConfig()):
    """Sky radiance for bounce-miss rays (sunsky.cu:76-114)."""
    _, _, sky_term, _ = _common(view_dir, sun_dir, cfg)
    return cfg.sky_factor * 0.01 * sky_term


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sunsky(view_dir, sun_dir, cfg: SunSkyConfig = SunSkyConfig()):
    """Sky + smoothstep solar disc for primary-miss rays (sunsky.cu:116-161)."""
    sun_e, fex, sky_term, cos_vs = _common(view_dir, sun_dir, cfg)
    sadc = cfg.sun_angular_diameter_cos
    disc = _smoothstep(sadc, sadc + 0.00002, cos_vs)
    sun_term = (sun_e[..., None] * 19000.0 * fex) * disc[..., None] * 1e-5
    return 0.01 * (sun_term + sky_term)
