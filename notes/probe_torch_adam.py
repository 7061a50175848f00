#!/usr/bin/env python3
"""Probe: kernel A1 (``csrc/adam.cu``, Adam + clip to [0, 1] in one pass)
on one card, against its plain version and the update it replaced.

    python3 notes/probe_torch_adam.py [--bricks 738688] [--reps 10]
    # one card, ~1 min; --bricks: the fields' pool rows (the inverse
    # benchmark's active bricks by default)

1. builds ``csrc/adam.cu`` with the port's nvcc flags and prints its ptxas
   lines; fails on a stack frame or spills;
2. holds A1 against ``ops/adam.py::adam_update_plain`` on the card, bit for
   bit (a NaN as a NaN), over steps 1 to 3: leaves of 1, 3, 4, 5, 1023 and
   4097 elements (occupancy-like, with an albedo-like field of 3n, one
   launch each), then 2^26 + 3 and 3 * 2^26 + 1; gradients at 0, NaN and
   large enough to cross 0 or 1, parameters at 0 and 1;
3. times, at the fields' sizes (occupancy ``bricks * 512`` elements,
   albedo three times that), by CUDA events around each call (a call is
   ~15-45 ms of device work, so the host's launch time hides behind it),
   in turns: A1 (one launch a field), and one
   ``torch.optim.Adam`` (foreach) step + ``clamp_`` of both leaves, the
   update A1 replaced; each beside A1's bound (28 bytes an element over
   3.35 TB/s); and the kernels one ``adam_step`` runs, under the profiler
   (A1 alone);
4. the plain version's host ms at the 2^26 fields.

Prints the card's name and power limit first, and a JSON line with every
number last.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

HBM_BYTES_PER_S = 3.35e12
LR, BETAS, EPS = 0.05, (0.9, 0.999), 1e-8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bricks", type=int, default=738_688)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    from brickmap_tpu_torch.diff import optim
    from brickmap_tpu_torch.kernels import adam as kadam, build
    from brickmap_tpu_torch.ops.adam import adam_update_plain, step_scalars

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")
    out = {"card": smi}

    build.build(("adam",), force=True)
    lines = build.ptxas_summary["adam"]
    for line in lines:
        print(f"  ptxas adam: {line}")
    spill = [ln for ln in lines if "spill" in ln]
    if not spill or any(not ln.startswith(
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
            for ln in spill):
        print("FAILED: A1 has a stack frame or spills")
        return 1
    out["ptxas"] = lines

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)

    def grad(n):
        g = torch.randn(n, generator=gen, device=dev) * 0.1
        pick = torch.randint(0, 8, (n,), generator=gen, device=dev)
        g[pick == 2] = 0.0
        g[pick == 3] = 50.0
        g[pick == 4] = -50.0
        g[::97] = float("nan")
        return g

    def leaf(n):
        p = torch.rand(n, generator=gen, device=dev)
        pick = torch.randint(0, 8, (n,), generator=gen, device=dev)
        p[pick == 0] = 0.0
        p[pick == 1] = 1.0
        return [p, grad(n),
                torch.randn(n, generator=gen, device=dev) * 0.01,
                torch.rand(n, generator=gen, device=dev) * 1e-3]

    def bits_equal(a, b):
        nan = torch.isnan(b)
        return torch.equal(torch.isnan(a), nan) and torch.equal(
            torch.where(nan, 0.0, a).view(torch.int32),
            torch.where(nan, 0.0, b).view(torch.int32))

    plain_ms = None
    for sizes in [(n, 3 * n) for n in (1, 3, 4, 5, 1023, 4097)] + [
            ((1 << 26) + 3, 3 * (1 << 26) + 1)]:
        mine = [leaf(k) for k in sizes]
        ref = [[t.clone() for t in lf] for lf in mine]
        for step in (1, 2, 3):
            for a, b in zip(mine, ref):
                a[1] = b[1] = grad(a[0].shape[0])
            for lf in mine:
                kadam.adam_update(*lf, step, LR, BETAS, EPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p, g, m, v in ref:
                adam_update_plain(p, g, m, v, *BETAS, EPS,
                                  *step_scalars(LR, *BETAS, step))
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for i, (a, b) in enumerate(zip(mine, ref)):
                for name, x, y in zip("pmv", a[:1] + a[2:], b[:1] + b[2:]):
                    if not bits_equal(x, y):
                        print(f"FAILED: A1 at {sizes}, step {step}, leaf "
                              f"{i}: {name} differs from the plain version")
                        return 1
        print(f"  A1 at {list(sizes)} elements, steps 1-3: equal bit for "
              f"bit", flush=True)
    out["plain_ms_at_2e26"] = plain_ms
    print(f"  plain version at the 2^26 leaves: {plain_ms:.3f} ms a step")
    del mine, ref

    n_occ = args.bricks * 512
    elems = 4 * n_occ
    params = (torch.rand(n_occ, generator=gen, device=dev),
              torch.rand(3 * n_occ, generator=gen, device=dev))
    grads = tuple(torch.randn(p.shape, generator=gen, device=dev) * 1e-3
                  for p in params)
    bound_ms = 28 * elems / HBM_BYTES_PER_S * 1e3
    opt = optim.make_adam(params, LR)
    optim.adam_step(opt, params, grads)
    leaves = [(p, g, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])
              for p, g in zip(params, grads)]

    def a1():
        for lf in leaves:
            kadam.adam_update(*lf, 1, LR, BETAS, EPS)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        optim.adam_step(opt, params, grads)
        torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = sorted({e.name for e in acts})
    prof_ms = sum(e.time_range.end - e.time_range.start for e in acts) / 1e3
    print(f"  one adam_step under the profiler: {names}, {prof_ms:.4f} ms")
    out["adam_step_kernels"], out["adam_step_profiled_ms"] = names, prof_ms

    lib = torch.optim.Adam(list(params), lr=LR, betas=BETAS, eps=EPS)

    def library():
        for p, g in zip(params, grads):
            p.grad = g
        lib.step()
        for p in params:
            p.clamp_(0.0, 1.0)

    def events_ms(fn, reps):
        fn()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda.synchronize()
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    runs = {"A1": a1, "library": library}
    times = {name: [] for name in runs}
    for _ in range(2):
        for name, fn in runs.items():
            times[name].append(events_ms(fn, args.reps))
    for name, ms in times.items():
        print(f"  {name} at {n_occ} + {3 * n_occ} elements: "
              + ", ".join(f"{x:.4f}" for x in ms)
              + f" ms (bound {bound_ms:.4f} ms by bytes, "
              f"{100 * bound_ms / min(ms):.1f}% of it)", flush=True)
    out.update({"elements": elems, "bound_ms": bound_ms, "ms": times})
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
