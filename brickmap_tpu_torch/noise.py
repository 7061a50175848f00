"""Perm-table simplex noise + fBm, vectorized in NumPy.

The reference generates its terrain from 2-D simplex-noise fBm
(reference ``src/Scene.cpp:53-55``) using the classic Ken Perlin /
Stefan Gustavson public-domain permutation table and gradient scheme
(``SimplexNoise.cpp``).  Terrain is a pure function of (x, y), so porting the
*algorithm* (not the code) with the same table makes worlds bit-comparable with
the reference — the procedural-content oracle of SURVEY.md §4.

The port's copy of ``brickmap_tpu/noise.py`` with the JAX dispatch removed: it
is the NumPy fallback of the native heightfield (:mod:`brickmap_tpu_torch.native`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["PERM", "simplex2", "fbm2", "terrain_height"]

# Ken Perlin's reference permutation table (public domain; identical to the one
# in SimplexNoise.cpp:75-92 and countless other implementations).
PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], dtype=np.int32)

_F2 = 0.366025403  # (sqrt(3) - 1) / 2, skew factor
_G2 = 0.211324865  # (3 - sqrt(3)) / 6, unskew factor


def _hash(perm, i):
    """perm[uint8(i)] — table lookup with wraparound (SimplexNoise hash())."""
    return perm[i & 255]


def _grad2(h, x, y):
    """Gradient-dot-residual for 2-D: 8 directions from the low hash bits."""
    h = h & 0x3F
    low = h < 4
    u = np.where(low, x, y)
    v = np.where(low, y, x)
    su = np.where((h & 1) != 0, -u, u)
    sv = np.where((h & 2) != 0, -2.0 * v, 2.0 * v)
    return su + sv


def simplex2(x, y, perm=None):
    """2-D simplex noise in [-1, 1], vectorized over x/y of any shape.

    Numerically equivalent to SimplexNoise::noise(float, float)
    (SimplexNoise.cpp:215-293): same skew/unskew constants, same permutation
    hashing ``perm[i + perm[j]]``, same 0.5-radius falloff and 45.23065 scale.
    """
    if perm is None:
        perm = PERM
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)

    s = (x + y) * np.float32(_F2)
    i = np.floor(x + s).astype(np.int32)
    j = np.floor(y + s).astype(np.int32)

    t = (i + j).astype(np.float32) * np.float32(_G2)
    x0 = x - (i.astype(np.float32) - t)
    y0 = y - (j.astype(np.float32) - t)

    lower = x0 > y0  # which simplex triangle
    i1 = np.where(lower, 1, 0)
    j1 = 1 - i1

    x1 = x0 - i1.astype(np.float32) + np.float32(_G2)
    y1 = y0 - j1.astype(np.float32) + np.float32(_G2)
    x2 = x0 - np.float32(1.0) + np.float32(2.0 * _G2)
    y2 = y0 - np.float32(1.0) + np.float32(2.0 * _G2)

    gi0 = _hash(perm, i + _hash(perm, j))
    gi1 = _hash(perm, i + i1 + _hash(perm, j + j1))
    gi2 = _hash(perm, i + 1 + _hash(perm, j + 1))

    def corner(gi, cx, cy):
        tt = np.float32(0.5) - cx * cx - cy * cy
        tt2 = tt * tt
        n = tt2 * tt2 * _grad2(gi, cx, cy)
        return np.where(tt < 0, np.float32(0.0), n)

    n = corner(gi0, x0, y0) + corner(gi1, x1, y1) + corner(gi2, x2, y2)
    return np.float32(45.23065) * n


def fbm2(x, y, octaves: int = 8, frequency: float = 1.0, amplitude: float = 1.0,
         lacunarity: float = 2.0, persistence: float = 0.5, perm=None):
    """Fractal Brownian motion over :func:`simplex2`.

    Matches SimplexNoise::fractal(octaves, x, y) (SimplexNoise.cpp:455-470):
    amplitude-weighted octave sum normalized by total amplitude.
    """
    out = None
    denom = 0.0
    freq, amp = frequency, amplitude
    for _ in range(octaves):
        term = amp * simplex2(
            np.asarray(x, np.float32) * np.float32(freq),
            np.asarray(y, np.float32) * np.float32(freq),
            perm=perm,
        )
        out = term if out is None else out + term
        denom += amp
        freq *= lacunarity
        amp *= persistence
    return out / np.float32(denom)


def terrain_height(wx, wy, grid_height: int, octaves: int = 8,
                   feature_scale: float = 2048.0, perm=None):
    """Terrain height field, a pure function of world (x, y).

    Mirrors the reference's heightmap evaluation (Scene.cpp:53-55):
    ``fbm(8, x/2048, y/2048) * H/2 + H/2``.
    """
    h = fbm2(
        np.asarray(wx, np.float32) / np.float32(feature_scale),
        np.asarray(wy, np.float32) / np.float32(feature_scale),
        octaves=octaves,
        perm=perm,
    )
    half = np.float32(grid_height / 2.0)
    return h * half + half
