"""The readings that ``stream.cold_start``'s limits are set from, in one
process (``calibrate.py`` takes the view and training cells).

    python3 h100bench/calibrate_stream.py --seeds <s1,s2,...> \\
        [--control <s1,...>] [--seconds 2]

For each seed of ``--seeds``: the cell's set-up, a short window of the
program and the comparison with the reference, as a run makes them.  For
each seed of ``--control``: the same set-up and window, then three controls
put in the program's place and compared as a run compares the program:

* ``bf16``: the reference computed in bfloat16, the precision below the
  configuration's float32: its world built from rounded heights, its
  manager over that truth, its wave rounded after every stage;
* ``last``: a manager that dedupes a frame's requests by their last
  occurrence;
* ``all``: a manager that skips the unloaded filter.

Each control's manager is fed the program's own request lists up to the
compared frame (a faulty program would pull other lists after its first
faulty frame; the same lists isolate the manager), then traces the compared
frame over its state.  One JSON line each on standard output.  The
benchmark's own runs do not run the controls.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from h100bench import harness  # noqa: E402
from h100bench.calibrate import bf16  # noqa: E402
from h100bench.reference import compare, stream as rstream, \
    world as rworld  # noqa: E402


class LastOccurrence(rstream.Manager):
    """The fault: each distinct request kept at its last occurrence."""

    def _distinct(self, requests) -> list:
        last = {r: i for i, r in enumerate(requests)}
        return sorted(last, key=last.get)


class NoUnloadedFilter(rstream.Manager):
    """The fault: resident bricks are not filtered out of a batch."""

    def _unloaded(self, bricks) -> list:
        return list(bricks)


def _numbers(got: dict, want: dict) -> dict:
    return {"state_differ": rstream.state_differ(got["state"], want["state"]),
            "px_differ": compare.pixels_differ(got["rgb"], got["count"],
                                               want["rgb"], want["count"]),
            "traced_gap": compare.relative_gap(got["traced"], want["traced"]),
            "requests_differ": rstream.requests_differ(got["pulled"],
                                                       want["pulled"]),
            "exhausted": got["exhausted"]}


def stream_controls(loop) -> dict:
    """The three controls' numbers against the sound reference, after
    ``loop.run``."""
    dev = loop.device
    grid = loop.rcfg.grid
    sound = loop.replay()
    world = rworld.build_world(grid, dev)
    low = rworld.build_world(grid, dev, quant=bf16)
    cells = compare.world_cells_differ(low, world, grid)
    low_truth = (low.index_volume.cpu().numpy().view(np.uint32),
                 low.pool_words.cpu().numpy().view(np.uint32),
                 low.pool_base.cpu().numpy().astype(np.int64))
    del world, low
    out = {"bf16": dict(_numbers(loop.replay(truth=low_truth, quant=bf16),
                                 sound), world_cells_differ=cells)}
    out["last"] = _numbers(loop.replay(LastOccurrence), sound)
    out["all"] = _numbers(loop.replay(NoUnloadedFilter), sound)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate_stream: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell_spec("stream.cold_start", harness.benchmark(),
                             limits=False)
    dev = torch.device("cuda", 0)
    loop_mod = harness.load_loop(cell["traffic_data"]["loop"])

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    for kind, seed in ([("program", s) for s in seeds(args.seeds)]
                       + [("control", s) for s in seeds(args.control)]):
        t0 = time.perf_counter()
        loop = loop_mod.Loop(cell["config_data"], cell["traffic_data"], seed,
                             dev)
        loop.setup()
        window = loop.run(args.seconds)
        out = loop.check(False)[0] if kind == "program" \
            else stream_controls(loop)
        print(json.dumps({"kind": kind, "seed": seed, "k": loop.kept["k"],
                          **out, "units": window["units"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
