# Frozen copy of brickmap_tpu_torch/config.py, the
# benchmark's plain reference: it imports nothing of the port, and later
# changes to the port do not reach it.  Only its imports were changed.
"""Static configuration for the brickmap renderer (the port's copy).

Frozen dataclasses, bit constants and the five presets of
``brickmap_tpu/config.py``, without the TPU traversal knobs (``paged_*``,
``rays_per_chunk``, ``rescue_*``): the port's traversal is one CUDA thread
per ray and has no page rounds to tune.

Geometry conventions (identical to the reference):

* world voxels: ``x, y in [0, grid_size)``, ``z in [0, grid_height)``; voxel edge = 1
  world unit.
* brick: ``brick_size**3`` voxels (8x8x8 = 512 occupancy bits = 16 words).
* brick grid ("cells"): ``cells x cells x cells_height`` bricks.
* superchunk: ``supergrid_cell_size**3`` bricks; superchunk grid is
  ``supergrid_xy x supergrid_xy x supergrid_z``.

Index-word bit layout (reference ``variables.h:29-33``)::

    [31: loaded | 30: unloaded | 29: requested | 28:20 ESS distance
     | 19:12 lod 2x2x2 byte | 11:0 slot]

The masks below are Python ints of the uint32 layout.  Tensors hold the words
as int32 bit patterns, so bit 31 is the sign bit: use :func:`i32` to turn a
mask into the int32 value that ``&`` against an int32 tensor accepts.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

BRICK_INDEX_BITS = 0xFFF          # 12-bit slot within superchunk pool segment
BRICK_LOD_BITS = 0xFF000          # 8-bit 2x2x2 coarse-occupancy byte, bits 12-19
BRICK_LOD_SHIFT = 12
BRICK_LOADED_BIT = 0x8000_0000    # brick payload resident in pool
BRICK_UNLOADED_BIT = 0x4000_0000  # brick exists but payload not resident
BRICK_REQUESTED_BIT = 0x2000_0000  # residency request outstanding
BRICK_FLAG_BITS = 0xE000_0000     # any of the three state flags above

# Empty cells carry the Chebyshev distance to the nearest non-empty cell in
# bits 28:20 (empty-space skipping); occupied cells always have a flag set.
BRICK_DIST_SHIFT = 20
BRICK_DIST_MASK = 0x1FF0_0000     # 9 bits -> skip radius up to 511 cells

PI = math.pi


def i32(mask: int) -> int:
    """The int32 value with the same 32 bits as the uint32 ``mask``."""
    mask &= 0xFFFF_FFFF
    return mask - (1 << 32) if mask >= 1 << 31 else mask


@dataclass(frozen=True)
class GridConfig:
    """World geometry. Reference: variables.h:7-20."""

    grid_size: int = 4096          # world extent in voxels along x and y
    grid_height: int = 512         # world extent in voxels along z
    brick_size: int = 8            # voxels per brick edge
    supergrid_cell_size: int = 16  # bricks per superchunk edge

    # LoD squared distances in brick units. Reference: variables.h:25-27.
    lod_distance_8: int = 600_000
    lod_distance_2: int = 100_000

    epsilon: float = 0.001         # self-intersection offset (variables.h:22)

    def __post_init__(self) -> None:
        if self.grid_size % (self.brick_size * self.supergrid_cell_size):
            raise ValueError("grid_size must be a multiple of brick*supergrid size")
        if self.grid_height % (self.brick_size * self.supergrid_cell_size):
            raise ValueError("grid_height must be a multiple of brick*supergrid size")

    @property
    def cells(self) -> int:
        return self.grid_size // self.brick_size

    @property
    def cells_height(self) -> int:
        return self.grid_height // self.brick_size

    @property
    def cell_members(self) -> int:
        """32-bit words of occupancy bits per brick (512/32 = 16)."""
        return self.brick_size ** 3 // 32

    @property
    def supergrid_xy(self) -> int:
        return self.cells // self.supergrid_cell_size

    @property
    def supergrid_z(self) -> int:
        return self.cells_height // self.supergrid_cell_size

    @property
    def num_superchunks(self) -> int:
        return self.supergrid_xy * self.supergrid_xy * self.supergrid_z

    @property
    def bricks_per_superchunk(self) -> int:
        return self.supergrid_cell_size ** 3

    @property
    def world_max(self) -> tuple[float, float, float]:
        return (float(self.grid_size), float(self.grid_size), float(self.grid_height))


@dataclass(frozen=True)
class SunSkyConfig:
    """Preetham-style sky model constants. Reference: sunsky.cuh:24-42."""

    sun_size_deg: float = 1.5        # angular sun diameter (physical sun: 0.53)
    cutoff_angle: float = PI / 1.95
    steepness: float = 1.5
    sky_factor: float = 1.0
    turbidity: float = 1.0
    mie_coefficient: float = 0.005
    mie_directional_g: float = 0.80
    v: float = 4.0
    rayleigh_zenith_length: float = 8.4e3
    mie_zenith_length: float = 1.25e3
    sun_intensity: float = 1000.0
    primary_wavelengths: tuple[float, float, float] = (680e-9, 550e-9, 450e-9)
    k: tuple[float, float, float] = (0.686, 0.678, 0.666)

    @property
    def sun_angular_diameter_cos(self) -> float:
        return math.cos(self.sun_size_deg * PI / 180.0)


@dataclass(frozen=True)
class RenderConfig:
    """Per-run rendering parameters.

    The traversal budget of one trace call is
    ``max_top_steps + 32 * (max_brick_steps + max_byte_steps)`` DDA steps per
    ray, shared across the three levels (``brickmap_tpu`` pathtrace.py:178-186).
    """

    width: int = 1920
    height: int = 1080
    max_bounces: int = 3
    max_top_steps: int = 2048        # top-level DDA steps across the brick grid
    max_brick_steps: int = 22        # 8x8x8 DDA worst case = 3*8 - 2
    max_byte_steps: int = 4          # 2x2x2 DDA worst case = 3*2 - 2

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def trace_budget(self) -> int:
        return self.max_top_steps + 32 * (self.max_brick_steps
                                          + self.max_byte_steps)


@dataclass(frozen=True)
class MeshConfig:
    """Layout of ray-sharded rendering: rays split over ``num_devices``
    ranks, the scene replicated (``parallel.render.make_mesh(cfg.mesh)``)."""

    num_devices: int = 1


@dataclass(frozen=True)
class BrickmapConfig:
    """Top-level bundle of the world, sky, render and mesh settings, and
    the run's random seed (the CLI's ``--seed``)."""

    grid: GridConfig = GridConfig()
    sky: SunSkyConfig = SunSkyConfig()
    render: RenderConfig = RenderConfig()
    mesh: MeshConfig = MeshConfig()
    seed: int = 0

    def replace(self, **kw) -> "BrickmapConfig":
        return dataclasses.replace(self, **kw)


def preset_single_brick() -> BrickmapConfig:
    """Config 1: single 8x8x8 brick, primary rays only, 256x256."""
    return BrickmapConfig(
        grid=GridConfig(grid_size=128, grid_height=128),
        render=RenderConfig(width=256, height=256, max_bounces=0,
                            max_top_steps=64),
    )


def preset_one_superchunk() -> BrickmapConfig:
    """Config 2: one superchunk (16^3 bricks), 3-level LoD, sun/sky shading."""
    return BrickmapConfig(
        grid=GridConfig(grid_size=128, grid_height=128),
        render=RenderConfig(width=512, height=512, max_bounces=1,
                            max_top_steps=64),
    )


def preset_terrain() -> BrickmapConfig:
    """Config 3: simplex terrain world, multi-superchunk, pool residency."""
    return BrickmapConfig(
        grid=GridConfig(grid_size=1024, grid_height=256),
        render=RenderConfig(width=960, height=540, max_bounces=3,
                            max_top_steps=512),
    )


def preset_full() -> BrickmapConfig:
    """Config 4: full path tracing at 1920x1080 on the 4096^2x512 world."""
    return BrickmapConfig(grid=GridConfig(), render=RenderConfig())


def preset_inverse(num_devices: int = 1) -> BrickmapConfig:
    """Config 5: inverse rendering, rays sharded across devices."""
    return BrickmapConfig(
        grid=GridConfig(grid_size=64, grid_height=64),
        render=RenderConfig(width=128, height=128, max_bounces=0,
                            max_top_steps=48),
        mesh=MeshConfig(num_devices=num_devices),
    )


PRESETS = {
    "single_brick": preset_single_brick,
    "one_superchunk": preset_one_superchunk,
    "terrain": preset_terrain,
    "full": preset_full,
    "inverse": preset_inverse,
}
