"""The readings that a cell's limits are set from, in one process.

    python3 h100bench/calibrate.py --workload <cell> --seeds <s1,s2,...> \\
        [--seconds 2] [--control <s1,...>] [--half <s1,...>]

For each seed of ``--seeds``: the cell's set-up and a short window of the
program, then the comparison with the reference, as a run makes them.  For
each seed of ``--control``: the control, the reference computed in
bfloat16 put in the program's place, compared the same way.  For each seed
of ``--half`` (training cells): the reference over half of the batch put in
the program's place (the fault "half of the batch left out, the mean taken
over the rest").  For each seed of ``--witness``: the reference over the
program's own world beside the usual comparison (a diagnosis only).  One
JSON line each on standard output.  The benchmark's own runs do not run
the control.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from h100bench import harness  # noqa: E402
from h100bench.loops import train as ltrain  # noqa: E402
from h100bench.reference import compare, config as rconfig, \
    sparse as rsparse, world as rworld  # noqa: E402


def bf16(t):
    """Round to bfloat16, the precision below the configuration's float32."""
    return t.to(torch.bfloat16).to(t.dtype)


def view_control(loop, seed: int) -> dict:
    """The view numbers with the control's wave in the program's place."""
    grid = loop.rcfg.grid
    world = rworld.build_world(grid, loop.device)
    low = rworld.build_world(grid, loop.device, quant=bf16)
    hold, k = divmod(loop.compared, loop.hold)
    i, s = hold % len(loop.views), loop._hold_seed(hold)
    rgb, count, traced, exh, _ = loop._ref_wave(world, i, s, k + 1)
    rgb_c, count_c, traced_c, exh_c, _ = loop._ref_wave(low, i, s, k + 1,
                                                        quant=bf16)
    return {"world_cells_differ": compare.world_cells_differ(low, world,
                                                            grid),
            "px_differ": compare.pixels_differ(rgb_c, count_c, rgb, count),
            "traced_gap": compare.relative_gap(traced_c, traced),
            "exhausted": exh_c}


def train_reference(cell, seed: int, quant=None, half=False) -> dict:
    """The training numbers with the reference in the program's place:
    computed in bfloat16 (``quant``) or over the first half of the batch."""
    c = cell["config_data"]
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    grid = rconfig.GridConfig(**c["grid"])
    world = rworld.build_world(grid, dev)
    rays = ltrain.make_rays(c, seed, dev)
    k, lr = int(c["k_segments"]), float(c["learning_rate"])
    steps = int(cell["traffic_data"]["steps_before_window"])
    args = (k, lr, c["occupancy_scale"], c["albedo"])
    ref = rsparse.follow(world, grid, *rays, *args, steps=steps)
    part = rays
    if half:
        m = rays[0].shape[0] // 2
        part = tuple(a[:m] for a in rays)
    low_world = world if quant is None else rworld.build_world(
        grid, dev, quant=quant)
    got = rsparse.follow(low_world, grid, *part, *args, steps=steps,
                         quant=quant)
    return {"world_cells_differ": compare.world_cells_differ(
                low_world, world, grid),
            "active_gap": compare.relative_gap(got["active"], ref["active"]),
            "loss_gap": max(compare.relative_gap(a, b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad_gap": compare.leaf_gap(got["grad_norms"],
                                         ref["grad_norms"],
                                         ref["grad_norms"]),
            "change_gap": compare.leaf_gap(got["change_norms"],
                                           ref["change_norms"],
                                           ref["grad_norms"]),
            "losses": got["losses"], "ref_losses": ref["losses"],
            "grad_norms": got["grad_norms"],
            "ref_grad_norms": ref["grad_norms"],
            "change_norms": got["change_norms"],
            "ref_change_norms": ref["change_norms"]}


def witness(cell, loop_mod, seed: int, dev, seconds: float) -> dict:
    """A second witness for a diagnosis, never for ``correct``: the
    program's run and the reference's computed over the program's own
    world (which the reference otherwise builds itself), beside the usual
    comparison.  Where the gaps vanish over the program's world, the
    world's rounding is their cause."""
    loop = loop_mod.Loop(cell["config_data"], cell["traffic_data"], seed,
                         dev)
    loop.setup()
    loop.run(seconds)
    own = rworld.World(loop.scene.index_volume, loop.scene.pool_words,
                       loop.scene.pool_base)
    if loop.name == "view":
        kept = loop.kept
        rgb, count, traced, _, _ = loop._ref_wave(
            own, kept["view"], loop._hold_seed(kept["hold"]),
            kept["wave"] + 1)
        out = {"px_differ": compare.pixels_differ(kept["rgb"], kept["count"],
                                                  rgb, count),
               "traced_gap": compare.relative_gap(kept["traced"], traced)}
        checks, _ = loop.check(False)
        return {"over_program_world": out, "usual": checks}
    c = cell["config_data"]
    prog = {"losses": loop.losses, "grad_norms": loop.grad_norms,
            "change_norms": loop.change_norms}
    del loop.params, loop.opt, loop.cache
    torch.cuda.empty_cache()
    ref = rsparse.follow(own, rconfig.GridConfig(**c["grid"]), *loop.rays,
                         loop.k, loop.lr,
                         c["occupancy_scale"], c["albedo"],
                         steps=loop.first)
    out = {"loss_gap": max(compare.relative_gap(a, b) for a, b in
                           zip(prog["losses"], ref["losses"])),
           "grad_gap": compare.leaf_gap(prog["grad_norms"],
                                        ref["grad_norms"], ref["grad_norms"]),
           "change_gap": compare.leaf_gap(prog["change_norms"],
                                          ref["change_norms"],
                                          ref["grad_norms"])}
    return {"over_program_world": out}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", default="")
    p.add_argument("--half", default="")
    p.add_argument("--witness", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell_spec(args.workload, harness.benchmark(),
                             limits=False)
    dev = torch.device("cuda", 0)
    loop_mod = harness.load_loop(cell["traffic_data"]["loop"])

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        loop = loop_mod.Loop(cell["config_data"], cell["traffic_data"], seed,
                             dev)
        loop.setup()
        window = loop.run(args.seconds)
        checks, _ = loop.check(False)
        extra = {}
        if loop.name == "train":
            extra = {"losses": loop.losses, "grad_norms": loop.grad_norms,
                     "change_norms": loop.change_norms}
        print(json.dumps({"kind": "program", "seed": seed, **checks,
                          **extra, "units": window["units"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del loop
        torch.cuda.empty_cache()
    for seed in seeds(args.control):
        t0 = time.perf_counter()
        if cell["traffic_data"]["loop"] == "view":
            out = view_control(loop_mod.Loop(cell["config_data"],
                                             cell["traffic_data"], seed, dev),
                               seed)
        else:
            out = train_reference(cell, seed, quant=bf16)
        print(json.dumps({"kind": "control", "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    for seed in seeds(args.witness):
        t0 = time.perf_counter()
        out = witness(cell, loop_mod, seed, dev, args.seconds)
        print(json.dumps({"kind": "witness", "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    for seed in seeds(args.half):
        t0 = time.perf_counter()
        out = train_reference(cell, seed, half=True)
        print(json.dumps({"kind": "half", "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
