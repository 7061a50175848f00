"""ctypes bindings for the port's native heightfield (``csrc/worldgen.cpp``).

The port's own copy of ``brickmap_tpu/native.py``: the library is built on
first use with g++ into ``brickmap_tpu_torch/build/`` (gitignored), with the
same flags as the JAX package's build, so both packages evaluate the identical
heightfield.  Without a toolchain the entry points return None and the scene
builder falls back to the NumPy noise of :mod:`brickmap_tpu_torch.noise`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "worldgen.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
_LIB_PATH = os.path.join(BUILD_DIR, "libbrickmap_worldgen.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build beside the target and rename: processes that build at once (test
    # workers) never load a half-written library.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        print(f"[brickmap_tpu_torch.native] build failed: {e}", file=sys.stderr)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = (not os.path.exists(_LIB_PATH)
                 or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC))
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            print(f"[brickmap_tpu_torch.native] load failed: {e}",
                  file=sys.stderr)
            return None
        lib.terrain_heights.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.terrain_heights.restype = None
        lib.simplex2_at.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.simplex2_at.restype = ctypes.c_float
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def terrain_heights(grid_size: int, grid_height: int, octaves: int = 8,
                    feature_scale: float = 2048.0) -> np.ndarray | None:
    """[grid_size, grid_size] float32 heights (heights[y, x]), or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((grid_size, grid_size), np.float32)
    lib.terrain_heights(
        grid_size, grid_height, octaves, ctypes.c_float(feature_scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def simplex2_at(x: float, y: float) -> float | None:
    lib = _load()
    if lib is None:
        return None
    return float(lib.simplex2_at(ctypes.c_float(x), ctypes.c_float(y)))
