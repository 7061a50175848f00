"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher (pointers and the stream
as ``void*``, returning ``cudaGetLastError()``) and is compiled on first use
into ``brickmap_tpu_torch/build/lib<name>.so`` (gitignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -Xptxas -v

Without fast math and with FMA contraction off, every float operation rounds
as the plain torch versions' do on the CPU, so DDA boundary decisions agree
with them.  A stale library (older than its sources) is rebuilt; all stale
sources build in parallel, one nvcc process each.  The ptxas summary
(registers, spills) of each build is printed once and kept in
:data:`ptxas_summary`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
KERNELS = ("brick", "traverse", "record", "extract", "wave", "replay",
           "adam")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

MAX_RAYS = 1 << 28  # 3 * ray index stays within int32

ptxas_summary: dict[str, list[str]] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _sources(name: str) -> list[str]:
    """The source and every file it may include (``csrc/*.cuh``,
    ``csrc/*.inc``)."""
    return [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))
        if f.endswith((".cuh", ".inc"))]


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(s) > built for s in _sources(name))


def _summary(text: str) -> list[str]:
    keep = ("Compiling entry", "Used ", "spill")
    return [line.strip() for line in text.splitlines()
            if any(k in line for k in keep)]


def build(names=KERNELS, force: bool = False) -> float:
    """Build every stale library among ``names`` (every one with ``force``),
    all nvcc processes started together.  Returns the seconds spent (0 when
    nothing was built)."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if force or _stale(n)]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        for name in todo:
            tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for name, tmp, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{err}")
                continue
            os.replace(tmp, lib_path(name))
            ptxas_summary[name] = _summary(out + err)
            print(f"[brickmap_tpu_torch.build] {name}.cu: "
                  + " | ".join(ptxas_summary[name]), file=sys.stderr)
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, bind) -> ctypes.CDLL:
    """The kernel library ``lib<name>.so``, built first if stale; ``bind``
    declares its launcher's ctypes signature once, at the first load."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(lib_path(name))
        bind(lib)
        _libs[name] = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launcher."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {status}")

