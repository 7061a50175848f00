"""The readings that ``view.preview_540p``'s limits are set from, in one
process (``calibrate_stream.py`` takes the stream cell's).

    python3 h100bench/calibrate_live.py --seeds <s1,s2,...> \\
        [--control <s1,...>] [--seconds 2]

For each seed of ``--seeds``: the cell's set-up, a short window of the
program and the comparison with the reference, as a run makes them.  For
each seed of ``--control``: the same set-up and window, then three controls
put in the program's place and compared as a run compares the program:

* ``half``: the presentation without the rounding's + 0.5, of the
  program's own films of the shown frames;
* ``f32``: the fly-camera step in float32, flown through the cycle's
  inputs, and the compared frame traced through the camera it reaches;
* ``bf16``: the reference computed in bfloat16, the precision below the
  configuration's float32: its world built from rounded heights, its
  manager over that truth, its wave rounded after every stage.

Each control's manager is fed the program's own request lists up to the
compared frame (as ``calibrate_stream.py``'s).  One JSON line each on
standard output.  The benchmark's own runs do not run the controls.
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
from h100bench.reference import compare, live as rlive, stream as rstream, \
    world as rworld  # noqa: E402

CELL = "view.preview_540p"


def _numbers(got: dict, want: dict) -> dict:
    return {"pose_differ": rlive.pose_differ(got["camera"], want["camera"]),
            "state_differ": rstream.state_differ(got["state"], want["state"]),
            "px_differ": compare.pixels_differ(got["rgb"], got["count"],
                                               want["rgb"], want["count"]),
            "traced_gap": compare.relative_gap(got["traced"], want["traced"]),
            "requests_differ": rstream.requests_differ(got["pulled"],
                                                       want["pulled"]),
            "exhausted": got["exhausted"]}


def live_controls(loop) -> dict:
    """The three controls' numbers against the sound reference, after
    ``loop.run``."""
    dev, kept = loop.device, loop.kept
    w, h = loop.width, loop.height
    sound = loop.replay()
    want = rlive.present(kept["rgb"], kept["count"], w, h).cpu()
    out = {"half": {"frame8_differ": loop.frames_differ(half=0.0)}}
    out["f32"] = _numbers(loop.replay(dtype=np.float32), sound)
    grid = loop.rcfg.grid
    world = rworld.build_world(grid, dev)
    low = rworld.build_world(grid, dev, quant=bf16)
    cells = compare.world_cells_differ(low, world, grid)
    low_truth = (low.index_volume.cpu().numpy().view(np.uint32),
                 low.pool_words.cpu().numpy().view(np.uint32),
                 low.pool_base.cpu().numpy().astype(np.int64))
    del world, low
    low_ref = loop.replay(truth=low_truth, quant=bf16)
    out["bf16"] = dict(_numbers(low_ref, sound), world_cells_differ=cells,
                       frame8_differ=rlive.frames_differ(rlive.present(
                           low_ref["rgb"], low_ref["count"], w, h).cpu(),
                           want))
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate_live: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell_spec(CELL, harness.benchmark(), limits=False)
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
        if kind == "program":
            out = loop.check(False)[0]          # closes the loop's server
        else:
            out = live_controls(loop)
            loop.server.close()
        print(json.dumps({"kind": kind, "seed": seed, "k": loop.kept["k"],
                          **out, "units": window["units"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
