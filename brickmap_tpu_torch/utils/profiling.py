"""Profiling hooks: torch.profiler traces + named annotations.

The port of ``brickmap_tpu/utils/profiling.py``.  The reference's profiling
is an ImGui frame-time panel plus coarse ``std::cout`` phase timing; here a
:func:`trace` records host ops and, on the card, every kernel launch (the
hand-written ones by their ``__global__`` names, e.g. ``traverse_kernel``)
into a Chrome-trace JSON file that TensorBoard's profiler plugin and
Perfetto (ui.perfetto.dev) open.  :func:`annotate` names a host region in
that trace.  The JSONL metrics (``utils/metrics.py``) keep the wall clock.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(logdir: str | None, device="cuda"):
    """Record a ``torch.profiler`` trace into ``logdir`` (no-op when None).

    CPU activity always, CUDA activity when ``device`` is a CUDA device.  On
    exit one ``<host>_<pid>.<ms>.pt.trace.json`` file is written into
    ``logdir`` (``torch.profiler.tensorboard_trace_handler``); view it with
    ``tensorboard --logdir <dir>`` or open it in Perfetto.  Yields the
    profiler (``None`` when disabled), whose ``key_averages()`` sum the
    recorded ops by name.
    """
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named host-side region (a ``record_function`` span in the trace)."""
    import torch

    with torch.profiler.record_function(name):
        yield
