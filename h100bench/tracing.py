"""The benchmark's own spans and the traced sub-window.

Spans are ``record_function`` ranges named ``h100bench.<layer>`` around the
benchmark's calls into each layer of the program; outside a profile they
cost a few microseconds and record nothing.  :func:`profiled` runs a short
sub-window under ``torch.profiler`` and hands its device activity to the
metric readers.
"""

from __future__ import annotations

import contextlib
import os
import time

from . import yardstick

__all__ = ["span", "profiled", "derive_seed"]

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def derive_seed(*parts: int) -> int:
    """A generator seed from the run's seed and a few small integers (view,
    hold, step), below 2**63."""
    s = 0
    for p in parts:
        s = (s * 1_000_003 + int(p)) % (1 << 63)
    return s


@contextlib.contextmanager
def span(name: str):
    import torch

    with torch.profiler.record_function(yardstick.SPAN_PREFIX + name):
        yield


def profiled(fn, device, cell: str) -> dict:
    """Run ``fn()`` (the sub-window: it returns how many frames or steps it
    made) twice under ``torch.profiler`` with the host's and the card's
    activity, and keep the second: the first pays the profiler's own
    start.  Returns the readers' context: ``prof``, ``acts`` (device
    activities), ``units``, ``busy_s``, ``window_s`` (the host's seconds
    from the kept sub-window's start to its end, which waits for the
    device) and ``breakdown``.  The Chrome trace is written to
    ``h100bench/out/``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with profile(activities=acts, acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        sync()
        prof.step()
        t0 = time.perf_counter()
        units = fn()
        sync()
        window_s = time.perf_counter() - t0
        prof.step()
    dev_acts = yardstick.device_activity(prof)
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"{cell}.trace.json"))
    return {"prof": prof, "acts": dev_acts, "units": units,
            "busy_s": yardstick.busy_s(dev_acts), "window_s": window_s,
            "breakdown": yardstick.breakdown(prof, dev_acts)}
