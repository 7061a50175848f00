#!/usr/bin/env python3
"""Probe: kernels R1 and R2 alone, their first design against the present
``brickmap_tpu_torch/csrc/replay.cu``, in turns, with the L2 cold.

    python3 notes/probe_torch_replay.py [--variants R1M1,R1B1,R2S1,R2S3]
        [--reps 20] [--sass-dir DIR]            # one CUDA card, ~1 min

Builds, with the port's nvcc flags, each printing its ptxas lines
(registers, stack frame, spills, static shared memory):

* ``pr11``: ``notes/probe_torch_replay_pr11.cu``, the first R1/R2 verbatim;
* ``new``: ``brickmap_tpu_torch/csrc/replay.cu``;
* each of ``--variants``, with a ``-D``: ``R1M<m>`` (``csrc/replay.cu``
  with ``BM_R1_MERGE=m``: 1 the binary search on every axis, the first
  design's merge), ``R1B<n>`` and ``R2S<n>``
  (``notes/probe_torch_replay_variants.cu``, the shipped design with
  ``BM_R1_MIN_BLOCKS=n`` and ``BM_R2_STAGES=n``).

The data is ``chip_smoke.py`` phase 7's: the 4096^2 x 512 world built on
the card, the sparse benchmark's frame (2,073,600 rays, K = 8), one step's
``seg_cache`` (the count-sorted live rays) and the fields on the active
bricks.  Shapes: the step's first slice (16,384 rays, K = 8), its K = 2 and
4 column cuts (row stride 8), and the step's last, partial slice (the live
rays past 126 x 16,384, K = 8).  At each shape every build's R1 and R2 must
equal their plain versions bit for bit (R2 on R1's visited voxels' values
from B4f); then each build's kernels are timed alone, a 256 MiB buffer
zeroed before every launch and CUDA events around the launch (``--reps``
launches, mean), the builds in order and then in reverse order.  Each time
is printed beside its bound (``chip_smoke.py``'s bytes and operations of
these inputs) and its share of it; R2 also with its dynamic shared memory
and blocks resident an SM.  With ``--sass-dir`` each build's ``cuobjdump
-sass`` listing is written there, with counts of the opcodes that tell
R1's divisions (``MUFU.RCP``), table probes (``LDS``) and R2's copies
(``LDGSTS``) apart.  The card's name and power limit come first, a JSON line
with every number last.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (its bounds, flush size and smi line)

SLICE = 16384
# Each variant's macro, and its source: csrc/replay.cu, or (None) the copy
# with the knobs that were not shipped.
VARIANTS = {"R1M": ("BM_R1_MERGE", "replay.cu"),
            "R1B": ("BM_R1_MIN_BLOCKS", None),
            "R2S": ("BM_R2_STAGES", None)}
OPCODES = ("MUFU.RCP", "LDS", "STS", "LDG", "STG", "LDGSTS", "BAR",
           "WARPSYNC", "CALL", "POPC")


def nvcc_all(build, jobs) -> dict:
    """Build each (tag, source, defines) in parallel, print its ptxas lines;
    returns {tag: (CDLL, path, ptxas lines)}."""
    from brickmap_tpu_torch.kernels import replay as krep

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = {}
    for tag, src, defines in jobs:
        out = os.path.join(build.BUILD_DIR, f"libprobe_replay_{tag}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS,
               *(f"-D{d}" for d in defines), "-o", out, src]
        procs[tag] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for tag, (out, proc) in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {tag}:\n{se}")
        lines = build._summary(so + se)
        for line in lines:
            print(f"  ptxas {tag}: {line}", flush=True)
        lib = ctypes.CDLL(out)
        if tag == "pr11":
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.replay_geom_launch.argtypes = (
                [i, i, p, p, p, p, i, p, i, p, i, p, i, i, i, f, p, p, p])
            lib.replay_composite_launch.argtypes = [i, i, i] + [p] * 7
            lib.replay_geom_launch.restype = i
            lib.replay_composite_launch.restype = i
        else:
            krep._bind(lib)
        libs[tag] = (lib, out, lines)
    return libs


def sass_counts(build, path: str, tag: str, sass_dir) -> dict:
    """Per kernel, the count of each of OPCODES in the build's SASS."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True)
    if res.returncode != 0:
        print(f"  sass {tag}: cuobjdump failed: {res.stderr.strip()[:200]}")
        return {}
    os.makedirs(sass_dir, exist_ok=True)
    with open(os.path.join(sass_dir, f"replay_{tag}.sass"), "w") as f:
        f.write(res.stdout)
    counts, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = "R1" if "segment_geom" in m.group(1) else (
                "R2" if "composite" in m.group(1) else m.group(1))
            counts[name] = dict.fromkeys(OPCODES, 0)
            counts[name]["instructions"] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if m and name:
            op = m.group(1)
            counts[name]["instructions"] += 1
            for o in OPCODES:
                if op == o or op.startswith(o + "."):
                    counts[name][o] += 1
    for k, c in counts.items():
        print(f"  sass {tag} {k}: " + ", ".join(
            f"{o} {n}" for o, n in c.items()), flush=True)
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="R1M1,R1B1,R2S1,R2S3")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass-dir", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app import benchmark
    from brickmap_tpu_torch.config import preset_full
    from brickmap_tpu_torch.diff import sparse as dsparse
    from brickmap_tpu_torch.kernels import build, extract as kext
    from brickmap_tpu_torch.kernels import record as krec, replay as krep
    from brickmap_tpu_torch.ops.replay import composite_sse_plain, \
        segment_geom_plain

    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda")
    jobs = [("pr11", os.path.join(HERE, "probe_torch_replay_pr11.cu"), ()),
            ("new", os.path.join(build.CSRC, "replay.cu"), ())]
    for v in filter(None, args.variants.split(",")):
        macro, src = VARIANTS[v[:3]]
        src = (os.path.join(build.CSRC, src) if src else
               os.path.join(HERE, "probe_torch_replay_variants.cu"))
        jobs.append((v, src, (f"{macro}={int(v[3:])}",)))
    libs = nvcc_all(build, jobs)
    tags = list(libs)
    sass = ({t: sass_counts(build, libs[t][1], t, args.sass_dir)
             for t in tags} if args.sass_dir else {})

    def launch_shape(t, keff):
        """R1's and R2's (threads, dynamic smem B, blocks an SM) in build
        ``t`` (the first design launches 128 threads and no dynamic smem for
        both)."""
        lib = libs[t][0]
        if not hasattr(lib, "replay_launch_shape"):
            return None
        out = (ctypes.c_int * 6)()
        build.check(lib.replay_launch_shape(keff, ctypes.addressof(out)),
                    f"{t} replay_launch_shape")
        return {"R1": tuple(out[:3]), "R2": tuple(out[3:])}

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
    field4 = dsparse._pack_field(occ, alb)
    del world, occ, alb, o, d, bg, tgt
    last = (n_live - 1) // SLICE * SLICE
    shapes = [("first slice", 0, SLICE, K), ("first slice", 0, SLICE, 2),
              ("first slice", 0, SLICE, 4),
              ("last slice", last, n_live, K)]
    print(f"{n_live} live rays; the last slice holds {n_live - last}",
          flush=True)
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    nvox = krep.NVOX
    results = []
    for tag_shape, a, b, kc in shapes:
        sl = [g[a:b] for g in geo]
        c = b - a
        geom_in = (sl[0], sl[1], sl[2][:, :kc], sl[3][:, :kc],
                   sl[4][:, :kc], sl[5], cellmap)
        want_geom = segment_geom_plain(*geom_in, grid)
        slots, lin2 = want_geom
        vals = kext.extract_fwd(field4, slots, lin2)
        bgs, tgts = sl[6], sl[7]
        want_comp = composite_sse_plain(vals, lin2, bgs, tgts)
        cs = c * kc
        geo_out = (torch.empty(cs, dtype=torch.int32, device=dev),
                   torch.empty((cs, nvox), dtype=torch.int32, device=dev))
        comp_out = (torch.empty(c, device=dev),
                    torch.empty((cs, 4 * nvox), device=dev))
        gargs, gkeep = krep.segment_geom_args(*geom_in, grid, geo_out,
                                              stream)
        cargs, ckeep = krep.composite_sse_args(vals, lin2, bgs, tgts,
                                               comp_out, stream)
        launch = {t: {"R1": (lambda lib=libs[t][0]:
                             lib.replay_geom_launch(*gargs)),
                      "R2": (lambda lib=libs[t][0]:
                             lib.replay_composite_launch(*cargs))}
                  for t in tags}
        for t in tags:
            for kern, out, want in (("R1", geo_out, want_geom),
                                    ("R2", comp_out, want_comp)):
                for x in out:
                    x.fill_(7)
                build.check(launch[t][kern](), f"{t} {kern}")
                torch.cuda.synchronize()
                for g, w in zip(out, want):
                    if not torch.equal(g, w):
                        raise SystemExit(f"{t} {kern} at {tag_shape} K = "
                                         f"{kc}: differs from the plain "
                                         f"version on {int((g != w).sum())} "
                                         f"values")
        # Bounds: chip_smoke.py phase 7's counts of these inputs.
        cells = geom_in[2]
        seg_ok = cells >= 0
        cmap_words = int(torch.unique(cells[seg_ok]).shape[0])
        moving = int((seg_ok * (sl[1] != 0).sum(1, keepdim=True)).sum())
        entries = cs * nvox
        r1_bound, r1_by = chip_smoke.bound(
            36 * c + 12 * cs + 4 * cmap_words + (4 + 4 * nvox) * cs,
            chip_smoke.R1_OPS * int(seg_ok.sum())
            + chip_smoke.R1_RANK_OPS * (nvox - 1) * moving)
        r2_bound, r2_by = chip_smoke.bound(
            36 * entries + 28 * c,
            chip_smoke.R2_STEP_OPS * int((lin2 >= 0).sum()))
        times = {t: {"R1": [], "R2": []} for t in tags}
        for order in (tags, tags[::-1]):
            for t in order:
                for kern in ("R1", "R2"):
                    times[t][kern].append(chip_smoke.cuda_ms(
                        launch[t][kern], args.reps, flush))
        shapes_k = {t: launch_shape(t, kc) for t in tags}
        print(f"{tag_shape}, {c} rays x K = {kc}: every build equal to the "
              f"plain versions; launches (threads, dynamic smem B, blocks "
              f"an SM): {shapes_k}", flush=True)
        for kern, bnd, by in (("R1", r1_bound, r1_by),
                              ("R2", r2_bound, r2_by)):
            print(f"  {kern}: bound {bnd:.4f} ms by {by}; " + "; ".join(
                f"{t} " + " / ".join(f"{ms:.4f}" for ms in times[t][kern])
                + f" ms ({100 * bnd / min(times[t][kern]):.1f}%)"
                for t in tags), flush=True)
        results.append({"shape": tag_shape, "rays": c, "k": kc,
                        "r1_bound_ms": r1_bound, "r2_bound_ms": r2_bound,
                        "launch": shapes_k, "ms": times})
        del gkeep, ckeep, vals, want_geom, want_comp, geo_out, comp_out
    print(json.dumps({"card": smi, "builds": tags, "results": results,
                      "ptxas": {t: libs[t][2] for t in tags},
                      "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
