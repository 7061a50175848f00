#!/usr/bin/env python3
"""The sparse training step of a checkout of the port, on one CUDA card.

    python3 notes/bench_torch_sparse_step.py [--root DIR] [--tag NAME]

Imports ``brickmap_tpu_torch`` from ``DIR`` (default: this checkout), builds
the 4096^2 x 512 world on the card and runs
``app/benchmark.py::run_sparse_inverse_benchmark`` there (2,073,600 rays,
K = 8: an uncached step after a warm-up, a cached step, 3 Adam steps), as
``chip_smoke.py`` phase 7 does.  Prints the card's name and power limit and
one JSON line: the tag, the root, the step seconds, the losses, the peak
device bytes and each stage's kernel ms and launches.  To compare two
commits on one card, unpack the other into a gitignored directory
(``git archive``) and run this script on both in turns (A, B, B, A).
Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import brickmap_tpu_torch
    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import preset_full

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    grid = preset_full().grid
    world = scene_mod.generate_terrain_scene(grid, device=dev)
    out = benchmark.run_sparse_inverse_benchmark(world, grid)
    out.pop("frame")
    keep = ("uncached_step_s", "cached_step_s", "adam_step_s", "losses",
            "peak_bytes", "live_rays", "exhausted", "kernels")
    print(json.dumps({"tag": args.tag, "root": os.path.dirname(
        brickmap_tpu_torch.__file__), **{k: out[k] for k in keep}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
