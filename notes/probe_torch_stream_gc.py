"""Where the streaming cell's frames lose time to the garbage collector.

    python3 notes/probe_torch_stream_gc.py [--seed N] [--cycles 10]

Runs the benchmark's stream loop (``h100bench/loops/stream.py``: view 0 at
960x540, a reset every 48 frames) on the card, first as the benchmark runs
it, then after ``gc.freeze()`` (the objects alive after set-up moved out of
the collector's reach), and times every collection with ``gc.callbacks``.
Prints, for each variant, the host ms a frame by phase (the wave's call,
the read, the pull, the servicing), the collections of each generation
(count, total and largest ms), how many of them began inside the pull, and
the objects the collector tracks.  A diagnosis for the servicing's next
change; the benchmark itself leaves the collector alone.
"""

import argparse
import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from h100bench import harness  # noqa: E402


def frames(loop, cycles: int, seed: int):
    """``cycles`` cycles of the loop's frames; per frame its phases' host
    seconds, and the collections (generation, seconds, in the pull)."""
    dev = loop.device
    gen = torch.Generator(device=dev)
    where = {"pull": False}
    colls, t0 = [], [0.0]

    def timer(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            colls.append((info["generation"], time.perf_counter() - t0[0],
                          where["pull"]))

    real_pull = loop.pull_requests

    def pull(req, queue):
        where["pull"] = True
        try:
            return real_pull(req, queue)
        finally:
            where["pull"] = False

    loop.pull_requests = pull
    gc.callbacks.append(timer)
    rows = []
    try:
        for c in range(cycles):
            loop.mgr.reset()
            gen.manual_seed(seed + c)
            film = loop.pathtrace.film_init(loop.width, loop.height, dev)
            for _ in range(loop.cycle):
                t = time.perf_counter()
                film, *_, parts = loop._frame(film, gen)
                rows.append((time.perf_counter() - t, *parts))
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(timer)
        loop.pull_requests = real_pull
    return rows, colls


def report(name: str, rows, colls) -> None:
    n = len(rows)
    cols = list(zip(*rows))
    print(f"{name}: {n} frames, host ms a frame (mean): " + ", ".join(
        f"{k} {sum(v) / n * 1e3:.3f}" for k, v in zip(
            ("frame", "wave", "read", "pull", "service"), cols)))
    for g in (0, 1, 2):
        ts = [s for gg, s, _ in colls if gg == g]
        pulled = sum(1 for gg, _, p in colls if gg == g and p)
        if ts:
            print(f"  generation {g}: {len(ts)} collections ({pulled} in the "
                  f"pull), {sum(ts) * 1e3:.1f} ms in all "
                  f"({sum(ts) / n * 1e3:.3f} a frame), largest "
                  f"{max(ts) * 1e3:.2f} ms")
    print(f"  tracked objects {len(gc.get_objects())}, frozen "
          f"{gc.get_freeze_count()}, thresholds {gc.get_threshold()}",
          flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=3210000901)
    p.add_argument("--cycles", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_stream_gc: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell_spec("stream.cold_start", harness.benchmark(),
                             limits=False)
    loop = harness.load_loop("stream").Loop(
        cell["config_data"], cell["traffic_data"], args.seed,
        torch.device("cuda", 0))
    loop.setup()
    print(f"card {torch.cuda.get_device_name(0)}", flush=True)
    report("as the benchmark runs", *frames(loop, args.cycles, args.seed))
    gc.collect()
    gc.freeze()
    report("after gc.freeze()", *frames(loop, args.cycles, args.seed))
    gc.unfreeze()
    return 0


if __name__ == "__main__":
    sys.exit(main())
