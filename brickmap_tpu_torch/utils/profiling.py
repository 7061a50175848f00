"""Profiling hooks: torch.profiler traces + named annotations.

The port of ``brickmap_tpu/utils/profiling.py``.  The reference's profiling
is an ImGui frame-time panel plus coarse ``std::cout`` phase timing; here a
:func:`trace` records host ops and, on the card, every kernel launch (the
hand-written ones by their ``__global__`` names, e.g. ``traverse_kernel``)
into a Chrome-trace JSON file that TensorBoard's profiler plugin and
Perfetto (ui.perfetto.dev) open.  :func:`annotate` names a host region in
that trace and :func:`count` keeps a number beside it; both record only while
a torch profiler records (a :func:`trace`, or any ``torch.profiler.profile``
in its active steps) and otherwise cost one check of the profiler's state.
The JSONL metrics (``utils/metrics.py``) keep the wall clock.

The program's spans are named ``bm.<layer>[.<phase>]`` and nest as the calls
do: ``bm.wave`` (``.uniforms``, ``.primary``, a ``.trace`` and a ``.shade`` a
bounce and one more of each for the final shadow trace), ``bm.sparse.step``
(``.pack_field``, ``.zero_grad``, ``.slices``, ``.finalize``),
``bm.optim.adam_step`` (the update with its clip, one kernel on the
card), and streaming's ``bm.stream.pull`` (the whole of ``pull_requests``),
``bm.stream.plan``, ``bm.stream.install`` (``.rebase`` inside it when a
segment grows) and ``bm.stream.reset`` (residency back to cold), and the
live viewer's ``bm.live.frame`` (``app/live.py``), which holds a frame's
``bm.live.input`` (the fly camera's step), its wave and streaming spans
and ``bm.live.present`` (the 8-bit frame to the host and the server);
``bm.sync.<site>`` marks a host read of a device value
(``bm.sync.tier_read``, the cached step's one read, and
``bm.sync.pull_requests`` inside ``bm.stream.pull``), so that a device-idle
gap under it is the host waiting.  The ranges sit on the profiler's clock, the one its device
activities carry.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["trace", "annotate", "count", "recording", "take_counts"]

_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
# name -> values kept by count() while a profiler recorded, until take_counts.
_counts: dict[str, list] = {}


@contextlib.contextmanager
def trace(logdir: str | None, device="cuda"):
    """Record a ``torch.profiler`` trace into ``logdir`` (no-op when None).

    CPU activity always, CUDA activity when ``device`` is a CUDA device.  On
    exit one ``<host>_<pid>.<ms>.pt.trace.json`` file is written into
    ``logdir`` (``torch.profiler.tensorboard_trace_handler``); view it with
    ``tensorboard --logdir <dir>`` or open it in Perfetto.  Yields the
    profiler (``None`` when disabled), whose ``key_averages()`` sum the
    recorded ops by name.  What :func:`count` kept during it and no
    :func:`take_counts` took is dropped when it ends.
    """
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
            yield prof
    finally:
        _counts.clear()


def annotate(name: str):
    """Named host-side region: a ``record_function`` range in the trace while
    a torch profiler records, else one shared null context (no range, no new
    object)."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """Keep ``value`` (a host int, or an int tensor the caller already holds,
    possibly on the device) under ``name`` while a torch profiler records;
    else do nothing.  Never copies, synchronises or launches: a device value
    is read by :func:`take_counts`."""
    if _recording():
        _counts.setdefault(name, []).append(value)


def recording() -> bool:
    """Whether a torch profiler records, so that :func:`count` keeps what
    it is given (for a caller that would make a value only to keep it)."""
    return _recording()


def take_counts() -> dict:
    """``{name: [int, ...]}`` of the values :func:`count` kept, in the order
    kept, and forget them.  Reads each kept device value (a synchronising
    copy): call it after the profiled work."""
    out = {k: [int(v) for v in vs] for k, vs in _counts.items()}
    _counts.clear()
    return out
