"""One run of one cell: set-up, the measured window, an optional traced
sub-window, the comparison with the plain reference, and the result line.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
its traffic mix (``traffic/<traffic>.json``); the mix names the general
loop that drives it (``loops/<loop>.py``); the limits of its comparison are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  Adding a cell or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

from . import yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that must not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "brickmap_tpu")

__all__ = ["load_json", "cell_spec", "metrics_for", "load_metric", "Run",
           "main"]


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(name: str, bench: dict | None = None,
              limits: bool = True) -> dict:
    """The cell's entry with its configuration, traffic and (with
    ``limits``) the limits of its comparison."""
    bench = bench if bench is not None else benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"h100bench: no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    cell["config_data"] = load_json("configs", f"{cell['config']}.json")
    cell["traffic_data"] = load_json("traffic", f"{cell['traffic']}.json")
    if limits:
        cell["limits"] = load_json("limits", f"{name}.json")
    return cell


def metrics_for(cell: str, kind: str, bench: dict | None = None) -> list:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those that list
    it, and those without a list whose moved metric the cell reports."""
    bench = bench if bench is not None else benchmark()
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])
            and ("workloads" in m or m["moves"] in names)]


def load_metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(ctx)``, which returns a number or None (nothing to read)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_loop(name: str):
    return importlib.import_module(f"h100bench.loops.{name}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _card_line(fields="name,power.limit,clocks.sm") -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Run:
    """One run of a cell on ``device``: the loop's set-up, window, traced
    sub-window and check, and the result line."""

    def __init__(self, cell: dict, seed: int, device, t_start: float):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.t_start = t_start
        traffic = cell["traffic_data"]
        self.loop = load_loop(traffic["loop"]).Loop(
            cell["config_data"], traffic, self.seed, device)

    def execute(self, seconds: float, trace: bool,
                bench: dict | None = None) -> dict:
        import torch

        cuda = self.device.type == "cuda"
        loop = self.loop
        loop.setup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - self.t_start
        window = loop.run(seconds)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"h100bench: loaded after the window: {found}")
        times = window["spans"].get("frame") or window["spans"]["step"]
        card = _card_line("clocks.sm,power.draw,temperature.gpu") if cuda \
            else "none"
        print(f"h100bench: set-up parts (s) {json.dumps(loop.setup_parts)}; "
              f"{loop.unit} ms p5 / p50 / p95 / max "
              + " / ".join(f"{yardstick.percentile(times, q) * 1e3:.3f}"
                           for q in (5, 50, 95, 100))
              + f"; card after the window {card}", file=sys.stderr,
              flush=True)
        ctx = {"cell": self.cell["name"], "loop": loop.name,
               "spans": window["spans"]}
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": 1}
        if trace:
            ctx.update(loop.profile())
            device["busy_s"] = ctx["busy_s"]
            device["window_s"] = ctx["window_s"]
        device["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                       if cuda else 0)
        print(f"h100bench: {self.cell['name']} seed {self.seed}: "
              f"{window['units']} {loop.unit}s in {window['seconds']:.3f} s, "
              f"memory_peak_bytes {device['memory_peak_bytes']}",
              file=sys.stderr, flush=True)
        t_check = time.perf_counter()
        checks, counts = loop.check(trace)
        print(f"h100bench: set-up {setup_s:.3f} s, the reference's check "
              f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr,
              flush=True)
        ctx.update(counts)
        if trace:
            values = {}
            for m in metrics_for(self.cell["name"], "per_layer", bench):
                v = load_metric(m["name"])(ctx)
                if v is not None:
                    values[m["name"]] = {"value": v, "unit": m["unit"]}
            over = {k: v["value"] for k, v in values.items()
                    if k.endswith("roofline_pct") and v["value"] > 100.0}
            if over:
                # A share of a roofline over 100% counts the work too high
                # or leaves part of its time out: a fault of the yardstick.
                raise SystemExit(f"h100bench: roofline share over 100%: "
                                 f"{over}")
        else:
            values = {"setup_s": {"value": setup_s, "unit": "s"}}
            for m in metrics_for(self.cell["name"], "end_to_end", bench):
                if m["name"] in window["metrics"]:
                    values[m["name"]] = {"value": window["metrics"][m["name"]],
                                         "unit": m["unit"]}
        limits = self.cell["limits"]
        out_checks = {k: {"value": v, "limit": limits[k]}
                      for k, v in checks.items()}
        correct = all(math.isfinite(v) and v <= limits[k]
                      for k, v in checks.items())
        result = {"correct": correct, "attempted": window["units"],
                  "failed": window["failed"], "metrics": values,
                  "device": device}
        if trace and "breakdown" in ctx:
            result["breakdown"] = ctx["breakdown"]
        result["checks"] = out_checks
        return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="h100bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = benchmark()
    cell = cell_spec(args.workload, bench)
    import torch

    need = int(cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"h100bench: {args.workload} needs {need} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    print(f"h100bench: card {_card_line()}", file=sys.stderr, flush=True)
    run = Run(cell, args.seed, torch.device("cuda", 0), t_start)
    result = run.execute(args.seconds, bool(args.trace), bench)
    found = forbidden_modules()
    if found:
        print(f"h100bench: loaded in this process: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
