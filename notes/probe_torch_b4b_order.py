#!/usr/bin/env python3
"""Probe: what sets the time of kernel B4b (the replay's atomic scatter-add
of voxel cotangents into the field gradient, ``csrc/extract.cu``), and what
``index_add_`` of the same work gets.

    python3 notes/probe_torch_b4b_order.py        # one CUDA card, ~2 min

Builds the 4096^2 x 512 world on the card, runs the sparse inverse
benchmark for its frame and seg_cache, takes the first 16,384-ray slice of
the replay at K = 8 (131,072 rows x 22 voxel steps, as ``chip_smoke.py``
phase 7), and times, with CUDA events around each call and the L2 flushed
before each (10 calls each, three rounds, interleaved):

* ``b4b``: B4b on the slice in replay order;
* ``index_add``: ``dfield4.index_add_`` of the valid entries, compacted
  beforehand, in replay order;
* ``b4b slot-sorted``: B4b on the slice's rows stably sorted by pool slot
  (the sort not timed): what a brick-major slice order would give;
* ``b4b compacted``: B4b on the compacted valid entries alone (one voxel
  step per row), in replay order, and ``b4b compacted sorted`` /
  ``index_add sorted`` with the entries sorted by field row (the sort not
  timed): what ordering the atomics by address would give;
* the sorts themselves (``argsort`` of the slots, ``sort`` of the rows);
* ``b4b`` and ``index_add`` with the L2 warm (no flush), and with the
  context's L2 fetch granularity set to 32 bytes (``cuCtxSetLimit``; the
  old value restored after);
* the variants of ``notes/probe_torch_b4b_variants.cu`` (more entries in
  flight per thread), each first held against B4b on a zero gradient;
* segment-major order (the rows as 16,384 rays of K segments, walked
  segment by segment): B4b and B4f with that walk in the kernel (held
  against B4b/B4f first), B4b on inputs permuted to it, ``index_add_`` of
  the valid entries in that order; beside them B4f in replay order and on
  slot-sorted rows, and ``index_select`` of the valid rows.

It prints the slice's counts (valid entries, distinct voxels, 32-byte
sectors, 128-byte lines, slots), one line per timing in ms per call, and
the global atomic instructions of the built B4b (``cuobjdump -sass``: one
``REDG`` per thread is the vector add, four would be scalar ones).
Imports torch and the port only.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

sys.path.insert(0, os.path.dirname(HERE))

L2_FLUSH_BYTES = 256 << 20
CU_LIMIT_MAX_L2_FETCH_GRANULARITY = 0x05


def main() -> int:
    import torch

    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import preset_full
    from brickmap_tpu_torch.diff import sparse as dsparse
    from brickmap_tpu_torch.kernels import build, extract as kext
    from brickmap_tpu_torch.ops.extract import field_index

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build()
    dump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(dump):
        sass = subprocess.run([dump, "-sass", build.lib_path("extract")],
                              capture_output=True, text=True).stdout
        ops = {}
        for op in re.findall(r"\b((?:RED|ATOM)G?\.[\w.]+)", sass):
            ops[op] = ops.get(op, 0) + 1
        print(f"global atomics in the built extract kernels: {ops}")
    cfg = preset_full()
    world = scene_mod.generate_terrain_scene(cfg.grid, device=dev)
    frame = benchmark.run_sparse_inverse_benchmark(world, cfg.grid)["frame"]
    K, nvox, c7 = benchmark.SPARSE_K, 3 * cfg.grid.brick_size - 2, 16384
    sl_in = tuple(a[:c7] for a in frame["seg_cache"]["geo"])
    field4 = dsparse._pack_field(frame["occupancy"], frame["albedo"])
    slots, lin, mask = dsparse._segment_geom(*sl_in[:6], frame["cellmap"],
                                             cfg.grid, K)
    del frame, world
    slots = slots.reshape(-1).contiguous()
    lin2 = torch.where(mask, lin, -1).reshape(c7 * K, nvox)
    cs = lin2.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dv = torch.randn((cs, 4 * nvox), generator=gen, device=dev)
    dfield = torch.zeros_like(field4)

    gidx, valid = field_index(slots, lin2, field4.shape[0])
    gv = gidx[valid]
    dvv = dv.reshape(cs, 4, nvox).permute(0, 2, 1)[valid].contiguous()
    n = gv.shape[0]
    print(f"slice: {cs} rows x {nvox} steps, {n} valid entries on "
          f"{torch.unique(gv).shape[0]} voxels, "
          f"{torch.unique(gv // 2).shape[0]} 32-byte sectors, "
          f"{torch.unique(gv // 8).shape[0]} 128-byte lines, "
          f"{torch.unique(slots[slots >= 0]).shape[0]} slots of "
          f"{field4.shape[0] // 512}", flush=True)

    # Row order by slot (stable), and the compacted entries as one-step rows.
    by_slot = torch.argsort(slots, stable=True)
    s_sorted, l_sorted, d_sorted = slots[by_slot], lin2[by_slot], dv[by_slot]
    order = torch.argsort(gv)
    gs, ds = gv[order], dvv[order]

    def one_step(g, d):
        return ((g // 512).to(torch.int32).contiguous(),
                (g % 512).to(torch.int32).reshape(-1, 1).contiguous(),
                d.reshape(-1, 4).contiguous())

    cmp_u, cmp_s = one_step(gv, dvv), one_step(gs, ds)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def timed(fn, cold=True, reps=10):
        fn()
        evs = []
        for _ in range(reps):
            if cold:
                flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in evs) / reps

    cases = {
        "b4b": lambda: kext.extract_bwd(dfield, slots, lin2, dv),
        "index_add": lambda: dfield.index_add_(0, gv, dvv),
        "b4b slot-sorted": lambda: kext.extract_bwd(dfield, s_sorted,
                                                    l_sorted, d_sorted),
        "b4b compacted": lambda: kext.extract_bwd(dfield, *cmp_u),
        "b4b compacted sorted": lambda: kext.extract_bwd(dfield, *cmp_s),
        "index_add sorted": lambda: dfield.index_add_(0, gs, ds),
    }
    for rnd in range(3):
        print(f"round {rnd}, L2 cold: " + ", ".join(
            f"{k} {timed(f):.4f}" for k, f in cases.items()), flush=True)
    print("the sorts: argsort of the slots "
          f"{timed(lambda: torch.argsort(slots, stable=True)):.4f}, sort of "
          f"the valid rows {timed(lambda: torch.sort(gv)):.4f}")
    for rnd in range(2):
        print(f"round {rnd}, L2 warm: " + ", ".join(
            f"{k} {timed(cases[k], cold=False):.4f}"
            for k in ("b4b", "index_add")), flush=True)

    cuda = ctypes.CDLL("libcuda.so.1")
    old = ctypes.c_size_t()
    if cuda.cuCtxGetLimit(ctypes.byref(old),
                          CU_LIMIT_MAX_L2_FETCH_GRANULARITY) == 0 \
            and cuda.cuCtxSetLimit(CU_LIMIT_MAX_L2_FETCH_GRANULARITY,
                                   ctypes.c_size_t(32)) == 0:
        for rnd in range(2):
            print(f"round {rnd}, L2 cold, fetch granularity 32 B (was "
                  f"{old.value}): " + ", ".join(
                      f"{k} {timed(cases[k]):.4f}"
                      for k in ("b4b", "index_add")), flush=True)
        cuda.cuCtxSetLimit(CU_LIMIT_MAX_L2_FETCH_GRANULARITY, old)
    else:
        print("L2 fetch granularity: cuCtxGetLimit/cuCtxSetLimit refused")

    lib_file = os.path.join(build.BUILD_DIR, "libprobe_b4b_variants.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_file,
                    os.path.join(HERE, "probe_torch_b4b_variants.cu")],
                   check=True)
    lib = ctypes.CDLL(lib_file)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.b4b_variant_launch.argtypes = [i, i, i, i, p, p, p, p, p]
    pool = field4.shape[0] // 512
    stream = torch.cuda.current_stream().cuda_stream

    def variant(v, out):
        status = lib.b4b_variant_launch(
            v, cs, nvox, pool, out.data_ptr(), slots.data_ptr(),
            lin2.data_ptr(), dv.data_ptr(), stream)
        if status != 0:
            raise RuntimeError(f"variant {v}: status {status}")

    # Segment-major order: the rows as c7 rays of K segments, walked segment
    # by segment, in the kernel (free) or by permuting the inputs (the
    # permutation not timed); index_add_ of the valid entries in that order.
    lib.b4_segment_major_launch.argtypes = [i, i, i, i, i, p, p, p, p, p]

    def seg_major(forward, field, vals):
        status = lib.b4_segment_major_launch(
            int(forward), K, cs, nvox, pool, field.data_ptr(),
            slots.data_ptr(), lin2.data_ptr(), vals.data_ptr(), stream)
        if status != 0:
            raise RuntimeError(f"segment-major: status {status}")
        return vals if forward else field

    fwd_want = kext.extract_fwd(field4, slots, lin2)
    fwd_got = seg_major(True, field4, torch.empty_like(fwd_want))
    bwd_want = kext.extract_bwd(torch.zeros_like(field4), slots, lin2, dv)
    bwd_got = seg_major(False, torch.zeros_like(field4), dv)
    print(f"segment-major: values equal {bool(torch.equal(fwd_got, fwd_want))}"
          f", gradient max |err| {float((bwd_got - bwd_want).abs().max()):.3g}"
          f" of max {float(bwd_want.abs().max()):.4g}", flush=True)
    del fwd_got, bwd_got, bwd_want
    perm_k = torch.arange(cs, device=dev).reshape(c7, K).t().reshape(-1)
    s_k, l_k, d_k = slots[perm_k], lin2[perm_k], dv[perm_k]
    gidx_k, valid_k = field_index(s_k, l_k, field4.shape[0])
    gvk = gidx_k[valid_k]
    dvvk = d_k.reshape(cs, 4, nvox).permute(0, 2, 1)[valid_k].contiguous()
    vals = torch.empty_like(fwd_want)
    del fwd_want
    order_cases = {
        "b4b": cases["b4b"],
        "b4b segment-major": lambda: seg_major(False, dfield, dv),
        "b4b k-major inputs": lambda: kext.extract_bwd(dfield, s_k, l_k, d_k),
        "index_add": cases["index_add"],
        "index_add k-major": lambda: dfield.index_add_(0, gvk, dvvk),
        "b4f": lambda: kext.extract_fwd(field4, slots, lin2),
        "b4f segment-major": lambda: seg_major(True, field4, vals),
        "b4f slot-sorted": lambda: kext.extract_fwd(field4, s_sorted,
                                                    l_sorted),
        "index_select": lambda: field4.index_select(0, gv),
    }
    for rnd in range(3):
        print(f"round {rnd}, L2 cold, orders: " + ", ".join(
            f"{k} {timed(f):.4f}" for k, f in order_cases.items()),
            flush=True)

    want = kext.extract_bwd(torch.zeros_like(field4), slots, lin2, dv)
    variants = {"batch2": 2, "batch4": 4, "lin4": 40}
    for name, v in variants.items():
        got = torch.zeros_like(field4)
        variant(v, got)
        err = float((got - want).abs().max())
        print(f"variant {name}: max |err| {err:.3g} of max "
              f"{float(want.abs().max()):.4g}", flush=True)
        del got
    del want
    for rnd in range(3):
        print(f"round {rnd}, L2 cold, variants: " + ", ".join(
            [f"b4b {timed(cases['b4b']):.4f}"]
            + [f"{k} {timed(lambda: variant(v, dfield)):.4f}"
               for k, v in variants.items()]
            + [f"index_add {timed(cases['index_add']):.4f}"]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
