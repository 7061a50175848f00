# Frozen copy of brickmap_tpu_torch/bits.py, the
# benchmark's plain reference: it imports nothing of the port, and later
# changes to the port do not reach it.  Only its imports were changed.
"""Brick occupancy bit format and index-word packing, on torch tensors.

The port's counterpart of ``brickmap_tpu/bits.py``.  Words are int32 tensors
holding the uint32 bit patterns of the JAX package (torch's uint32 support is
thin; ``brickmap_tpu/pallas/paged.py:90-92`` made the same choice for Mosaic).
Arithmetic that reaches bit 31 runs in int64 and is wrapped back to int32 with
:func:`wrap_i32`, never by a narrowing cast.

* **Brick** = 512 occupancy bits packed into 16 words; bit index of voxel
  ``(x, y, z)`` inside its brick is ``x + 8*y + 64*z`` (reference
  ``Scene.cpp:91-93``, ``voxel.cuh:110-113``).
* **Index word** = ``[31 loaded | 30 unloaded | 29 requested | 19:12 lod | 11:0 slot]``
  (reference ``variables.h:29-33``).
* **LoD byte** = 8-bit 2x2x2 coarse occupancy; bit for half ``(hx, hy, hz)`` is
  ``hx + 2*hy + 4*hz`` (reference ``Scene.cpp:95``, ``voxel.cuh:57``).
"""

from __future__ import annotations

import torch

from .config import (
    BRICK_INDEX_BITS,
    BRICK_LOADED_BIT,
    BRICK_LOD_BITS,
    BRICK_LOD_SHIFT,
    BRICK_REQUESTED_BIT,
    BRICK_UNLOADED_BIT,
    i32,
)

__all__ = [
    "wrap_i32",
    "pack_index_word",
    "index_slot",
    "index_lod_byte",
    "index_is_loaded",
    "index_is_unloaded",
    "index_is_requested",
    "voxel_bit_position",
    "brick_words_from_dense",
    "dense_from_brick_words",
    "lod_byte_from_dense",
    "test_voxel_bit",
]


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor as an int32 bit pattern."""
    x = x.to(torch.int64)
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def pack_index_word(slot, lod_byte, loaded=True, unloaded=False,
                    requested=False) -> torch.Tensor:
    """Pack int32 index words. Mirrors Scene.cpp:104 / Scene.cpp:160.

    ``loaded``/``unloaded``/``requested`` are bools or bool tensors that
    broadcast against ``slot``."""
    slot = torch.as_tensor(slot).to(torch.int64)
    word = ((slot & BRICK_INDEX_BITS)
            | ((torch.as_tensor(lod_byte, device=slot.device).to(torch.int64)
                << BRICK_LOD_SHIFT) & BRICK_LOD_BITS))

    def flag(f, bit):
        if isinstance(f, bool):
            return bit if f else 0
        return torch.as_tensor(f, device=slot.device).to(torch.int64) * bit

    word = (word | flag(loaded, BRICK_LOADED_BIT)
            | flag(unloaded, BRICK_UNLOADED_BIT)
            | flag(requested, BRICK_REQUESTED_BIT))
    return wrap_i32(word)


def index_slot(word: torch.Tensor) -> torch.Tensor:
    """12-bit pool slot within the superchunk segment (voxel.cuh:224)."""
    return word & BRICK_INDEX_BITS


def index_lod_byte(word: torch.Tensor) -> torch.Tensor:
    """8-bit 2x2x2 LoD mask (voxel.cuh:217)."""
    return (word >> BRICK_LOD_SHIFT) & 0xFF


def index_is_loaded(word: torch.Tensor) -> torch.Tensor:
    return (word & i32(BRICK_LOADED_BIT)) != 0


def index_is_unloaded(word: torch.Tensor) -> torch.Tensor:
    return (word & BRICK_UNLOADED_BIT) != 0


def index_is_requested(word: torch.Tensor) -> torch.Tensor:
    return (word & BRICK_REQUESTED_BIT) != 0


def voxel_bit_position(x, y, z, brick_size: int = 8):
    """(word, bit) of local voxel (x, y, z) within its brick (Scene.cpp:91-92)."""
    linear = x + y * brick_size + z * brick_size * brick_size
    return linear // 32, linear % 32


def test_voxel_bit(words: torch.Tensor, x, y, z,
                   brick_size: int = 8) -> torch.Tensor:
    """Occupancy of local voxel (x, y, z) given the brick's [..., 16] words
    (voxel.cuh:110-113); x/y/z broadcast over the leading dims."""
    dev = words.device
    word_i, bit_i = voxel_bit_position(torch.as_tensor(x, device=dev),
                                       torch.as_tensor(y, device=dev),
                                       torch.as_tensor(z, device=dev),
                                       brick_size)
    w = torch.gather(words, -1, word_i.to(torch.int64)[..., None])[..., 0]
    return ((w >> bit_i.to(torch.int32)) & 1) != 0


def brick_words_from_dense(dense: torch.Tensor) -> torch.Tensor:
    """Pack dense bool occupancy [..., bz, by, bx] (z-major, the reference's
    ``z*64 + y*8 + x`` linearization) into [..., cell_members] int32 words."""
    b = dense.shape[-1]
    flat = dense.reshape(*dense.shape[:-3], b * b * b // 32, 32)
    shifts = torch.arange(32, device=dense.device, dtype=torch.int64)
    return wrap_i32((flat.to(torch.int64) << shifts).sum(-1))


def dense_from_brick_words(words: torch.Tensor,
                           brick_size: int = 8) -> torch.Tensor:
    """Inverse of :func:`brick_words_from_dense`: [..., 16] -> [..., 8, 8, 8]
    bool (z, y, x order)."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1
    return (bits != 0).reshape(*words.shape[:-1], brick_size, brick_size,
                               brick_size)


def lod_byte_from_dense(dense: torch.Tensor) -> torch.Tensor:
    """8-bit 2x2x2 coarse mask from dense [..., 8, 8, 8] (z, y, x) occupancy.

    Bit for half-cell (hx, hy, hz) is ``hx + 2*hy + 4*hz`` (Scene.cpp:95).
    """
    b = dense.shape[-1]
    h = b // 2
    r = dense.reshape(*dense.shape[:-3], 2, h, 2, h, 2, h).to(torch.uint8)
    occ = r.amax(dim=(-5, -3, -1)) != 0                  # [..., hz, hy, hx]
    out = torch.zeros(dense.shape[:-3], dtype=torch.int32, device=dense.device)
    for z in range(2):
        for y in range(2):
            for x in range(2):
                out |= occ[..., z, y, x].to(torch.int32) << (x + 2 * y + 4 * z)
    return out
