"""A CUDA source of the port built with g++ through ``csrc/host_shim.h``:
the kernel's logic on the CPU, every float operation rounded once (no FMA
contraction), driven by the host tests before the card runs it."""

import os
import re
import shutil
import subprocess

from brickmap_tpu_torch.kernels.build import CSRC


def host_source(name: str, source=None) -> str:
    """``csrc/<name>.cu`` (or the file ``source``) as plain C++ for
    ``host_shim.h``: without the CUDA runtime header, each ``<<<...>>>``
    launch a ``launch_`` call, each ``extern __shared__`` array a pointer to
    the launch's dynamic shared memory."""
    with open(source or os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", "")
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 lambda m: f"{m.group(1)}* const {m.group(2)} = "
                           f"reinterpret_cast<{m.group(1)}*>(dynamic_shared_);",
                 src)
    return re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"launch_({m.group(2)}, [&] {{ "
                            f"{m.group(1)}({m.group(3)}); }});",
                  src, flags=re.S)


def host_build(name: str, out_dir: str, defines=(), source=None) -> str:
    """Build ``csrc/<name>.cu`` (or the file ``source``, whose includes
    resolve in its directory and ``csrc/``) into ``out_dir`` (with ``-D``
    of each of ``defines``) and return the library's path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    tag = "".join(f"_{d}" for d in defines).replace("=", "")
    cpp = os.path.join(out_dir, f"{name}{tag}_host.cpp")
    with open(cpp, "w") as f:
        f.write(host_source(name, source))
    lib = os.path.join(out_dir, f"lib{name}{tag}_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", *(f"-D{d}" for d in defines), "-include",
                    os.path.join(CSRC, "host_shim.h"), "-I", CSRC,
                    *(("-I", os.path.dirname(source)) if source else ()),
                    "-o", lib, cpp, "-pthread"],
                   check=True, capture_output=True, text=True)
    return lib
