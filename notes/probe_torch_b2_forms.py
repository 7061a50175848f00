#!/usr/bin/env python3
"""Probe: what ptxas makes of kernel B2 in the forms its shared walk could
take, each built from ``csrc/traverse.cu`` as it stands.

    python3 notes/probe_torch_b2_forms.py [--sass-dir DIR]   # nvcc needed

* ``fragment``: the shipped source (the walk, ``csrc/traverse_walk.inc``,
  included in the kernel's body; the count read as ``*count``);
* ``function``: the kernel's body after the count check moved into a
  ``__device__ __forceinline__`` function of the ray's index and the
  kernel's pointers, which the kernel calls;
* ``nullable``: the count read as ``count != nullptr ? *count : n``;
* ``function+nullable``: both.

Each is built with the port's nvcc flags; the script prints its ptxas
lines (registers, stack, spills) and the length of each of the kernel's
loops in the SASS (``cuobjdump``; the brick sub-DDA loop is the short one
with the most float compares).  Needs no card, only the toolkit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

CHECK = "  if (i >= *count) return;"
NULLABLE = "  if (i >= (count != nullptr ? *count : n)) return;"
KERNEL_PARAMS = (
    "const float* __restrict__ clipped, const float* __restrict__ dirs, "
    "const float* __restrict__ entry_normal, "
    "const float* __restrict__ tminn, const unsigned char* __restrict__ ok, "
    "const int* __restrict__ iv, const int* __restrict__ pool, "
    "const int* __restrict__ pool_base, unsigned char* __restrict__ hit_out, "
    "float* __restrict__ t_out, float* __restrict__ normal_out, "
    "unsigned char* __restrict__ request_out, int* __restrict__ request_pos, "
    "unsigned char* __restrict__ exhausted_out, "
    "float* __restrict__ resume_out, int* __restrict__ iters_out")
KERNEL_ARGS = ("clipped, dirs, entry_normal, tminn, ok, iv, pool, pool_base, "
               "hit_out, t_out, normal_out, request_out, request_pos, "
               "exhausted_out, resume_out, iters_out")


def as_function(src: str) -> str:
    """The kernel's body after the count check as a device function."""
    start = src.index(CHECK) + len(CHECK) + 1
    end = src.index("\n}\n\n}  // namespace") + 1
    body = src[start:end]
    fn = ("__device__ __forceinline__ void walk_and_store(\n"
          "    const bm::TraverseParams& P, int i, " + KERNEL_PARAMS +
          ") {\n" + body + "}\n\n")
    kernel_at = src.index("__global__ void __launch_bounds__(kThreads)")
    call = f"  walk_and_store(P, i, {KERNEL_ARGS});\n"
    return (src[:kernel_at] + fn + src[kernel_at:start] + call
            + src[end:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass-dir", default=None)
    args = ap.parse_args()

    import probe_torch_b1
    from brickmap_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC, "traverse.cu")) as f:
        shipped = f.read()
    if CHECK not in shipped:
        raise SystemExit("csrc/traverse.cu: the count check is not "
                         f"{CHECK.strip()!r}")
    forms = {"fragment": shipped, "function": as_function(shipped),
             "nullable": shipped.replace(CHECK, NULLABLE)}
    forms["function+nullable"] = forms["function"].replace(CHECK, NULLABLE)
    out_dir = os.path.join(build.BUILD_DIR, "b2_forms")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for tag, src in forms.items():
        cu = os.path.join(out_dir, f"{tag.replace('+', '_')}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = cu[:-3] + ".so"
        procs.append((tag, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for tag, so, proc in procs:
        o, e = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {tag}:\n{e[-3000:]}")
        for line in build._summary(o + e):
            if "Used" in line or "spill" in line:
                print(f"  {tag}: {line.split(':')[-1].strip()}")
        loops = probe_torch_b1.sass_loops(build, so, f"b2_{tag}",
                                          args.sass_dir)
        for name, found in loops.items():
            if "traverse_kernel" in name:
                print(f"  {tag}: loops (length, FSETP, LDS) "
                      f"{sorted(found, reverse=True)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
