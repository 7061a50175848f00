#!/usr/bin/env python3
"""Probe: the sparse replay's time against its slice size.

    python3 notes/probe_torch_replay_slice.py        # one CUDA card, ~1 min

Builds the 4096^2 x 512 world on the card, records the sparse inverse
benchmark's frame (2,073,600 rays, K = 8, the fields on its active bricks,
as ``chip_smoke.py`` phase 7) and fills a ``seg_cache``, then runs the
replay alone (``diff/sparse.py::_row_scan_grads``: R1 -> B4f -> R2 -> B4b a
slice) over the count-sorted live rays at slices of 16,384 (the step's),
32,768, 65,536 and 131,072 rays, in turns (each size twice, the order
reversed the second time).  Each run: host ms of the replay (3 calls, each
ended by a synchronise), the kernels' summed ms and launches by CUDA events
around each launch, the peak device memory above the inputs, and the loss
and gradients against the 16,384-ray slices' (the loss must be equal bit
for bit: a larger slice only adds masked steps, which add exact zeros;
gradients within 1e-6 of their largest value, B4b's atomics).  Prints one
line per run and the card's name and power limit.  Imports torch and the
port only.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLICES = (16384, 32768, 65536, 131072)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import preset_full
    from brickmap_tpu_torch.diff import sparse as dsparse
    from brickmap_tpu_torch.kernels import extract as kext, record as krec
    from brickmap_tpu_torch.kernels import replay as krep

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    grid = preset_full().grid
    world = scene_mod.generate_terrain_scene(grid, device=dev)
    K = benchmark.SPARSE_K
    o, d, bg, tgt = benchmark.sparse_inverse_rays(1920 * 1080, grid, dev)
    segs = krec.record_segments(o, d, world, grid, k_segments=K)
    cellmap, occ, alb = benchmark.active_fields(world, grid, segs["cells"])
    del segs
    cache: dict = {}
    dsparse.l2_loss_and_grads_sparse(o, d, world, cellmap, occ, alb, bg,
                                     tgt, grid, k_segments=K,
                                     seg_cache=cache)
    geo, n_live = cache["geo"], cache["n_live"]
    live = tuple(a[:n_live] for a in geo)
    field = dsparse._pack_field(occ, alb)
    print(f"{n_live} live rays of {o.shape[0]}, {occ.shape[0]} active "
          f"bricks", flush=True)

    def replay(chunk):
        return dsparse._row_scan_grads(*live[:6], cellmap, field, live[6],
                                       live[7], grid, K, chunk=chunk)

    ref_loss, ref_grad = replay(SLICES[0])
    ref_scale = float(ref_grad.abs().max())
    timers = benchmark.KernelTimes(R1=krep.segment_geom,
                                   B4f=kext.extract_fwd,
                                   R2=krep.composite_sse,
                                   B4b=kext.extract_bwd)
    for chunk in (*SLICES, *reversed(SLICES)):
        replay(chunk)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            loss, grad = replay(chunk)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 3
        peak = torch.cuda.max_memory_allocated() - base
        with timers:
            replay(chunk)
            kern = timers.take()
        err = float((grad - ref_grad).abs().max())
        if float(loss) != float(ref_loss) or err > 1e-6 * ref_scale:
            raise SystemExit(f"slice {chunk}: loss {float(loss)!r} vs "
                             f"{float(ref_loss)!r}, gradient off by {err}")
        print(f"slice {chunk:6d}: replay {host_ms:.3f} ms host; " + ", ".join(
            f"{k} {ms:.3f} ms / {c}" for k, (ms, c) in kern.items())
            + f"; peak +{peak} B; loss {float(loss)!r} equal, gradient "
            f"within {err:.3g} of {ref_scale:.6g}", flush=True)
        del loss, grad
    return 0


if __name__ == "__main__":
    sys.exit(main())
