"""The interval arithmetic of ``h100bench/spans.py`` on hand-made intervals,
the pairing of kernels with the span their launch call was in on
hand-made events, and the program-span readers on a CPU profile (nothing
to read: None)."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from h100bench import harness, spans, yardstick

NEW = ("wave.launches_per_frame", "wave.host_us_per_launch",
       "wave.idle_ms_per_frame", "b2.ns_per_ray", "step.sync_wait_ms",
       "replay.idle_ms_per_step", "pack_field.ms_per_step")


def test_union_counts_nested_and_overlapping_spans_once():
    assert spans.union([(5, 9), (0, 10), (2, 3), (12, 14), (13, 15),
                        (20, 20)]) == [(0, 10), (12, 15)]
    assert spans.length([(0, 10), (2, 3), (5, 12)]) == 12
    assert spans.union([]) == [] and spans.length([]) == 0


def test_overlap_of_two_sets():
    assert spans.overlap([(0, 10)], [(2, 4), (6, 8)]) == 4
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap([(0, 4), (1, 3)], [(0, 4), (2, 6)]) == 4


def test_idle_inside_a_span():
    # The device runs 0-2 and 6-10; the span is open 1-9: idle 2-6.
    busy = [(0, 2), (6, 8), (7, 10)]
    assert spans.idle_within([(1, 9)], busy) == 4


def test_an_idle_gap_straddling_a_span_edge_counts_only_inside():
    # Idle 4-12; the span opens at 8: only 8-12 is the span's.
    busy = [(0, 4), (12, 20)]
    assert spans.idle_within([(8, 16)], busy) == 4
    # and closes at 6: 4-6.
    assert spans.idle_within([(2, 6)], busy) == 2


def test_nested_spans_take_their_idle_once():
    busy = [(0, 1), (9, 10)]
    assert spans.idle_within([(0, 10), (2, 5), (3, 4)], busy) == 8
    assert spans.idle_within([(0, 10)], []) == 10


def _ev(name, start, end, device=DeviceType.CPU, cid=0):
    return SimpleNamespace(name=name, device_type=device, id=cid,
                           time_range=SimpleNamespace(start=start, end=end))


def _kernel(name, start, end, cid):
    return _ev(name, start, end, DeviceType.CUDA, cid)


def test_kernels_are_tied_to_the_span_their_launch_call_was_in():
    prof = SimpleNamespace(events=lambda: [
        _ev("bm.wave", 0, 10), _ev("bm.wave.trace", 1, 8),
        _ev("bm.wave", 40, 50),
        _ev("cudaLaunchKernel", 0.5, 0.7, cid=1),       # in bm.wave
        _ev("cudaLaunchKernel", 2, 3, cid=2),           # in the nested span
        _ev("cudaLaunchKernel", 4, 5, cid=3),           # a fill
        _ev("cudaGraphLaunch", 41, 42, cid=4),          # two kernels
        _ev("cudaLaunchKernel", 12, 13, cid=5),         # between the waves
        _ev("cudaLaunchKernel", 10, 11, cid=6),         # at the span's end
        _ev("bm.sparse.pack_field", 20, 30),
        _ev("cudaLaunchKernel", 21, 22, cid=7),
        _kernel("compact_kernel", 3, 5, 1),
        _kernel("traverse_kernel", 30, 35, 2),          # runs after the span
        _kernel("Memset (Device)", 6, 7, 3),
        _kernel("bm.wave", 0, 12, 8),                   # a range's image
        _kernel("shade_kernel", 43, 44, 4),
        _kernel("shade_kernel", 44, 46, 4),
        _kernel("primary_kernel", 14, 15, 5),
        _kernel("primary_kernel", 16, 17, 6),
        _kernel("CatArrayBatchedCopy", 22, 33, 7),
        _kernel("orphan_kernel", 1, 2, 99),             # no launch call
    ])
    got = sorted(spans.attributed_kernels(prof, "bm.wave"))
    assert got == [("compact_kernel", 2), ("shade_kernel", 1),
                   ("shade_kernel", 2), ("traverse_kernel", 5)]
    assert spans.attributed_kernels(prof, "bm.wave.trace") == [
        ("traverse_kernel", 5)]
    assert spans.attributed_kernels(prof, "bm.sparse.pack_field") == [
        ("CatArrayBatchedCopy", 11)]
    assert spans.attributed_kernels(prof, "bm.none") == []
    assert spans.host_intervals(prof, prefix="bm.wave") == [
        (0, 10), (1, 8), (40, 50)]


def test_device_clock_offset_is_measured():
    # Kernel 2 starts 30 before its launch call: the device's times run
    # early by at least 30; kernel 1 (5 after its call) bounds nothing.
    prof = SimpleNamespace(events=lambda: [
        _ev("bm.wave", 0, 100),
        _ev("cudaLaunchKernel", 10, 11, cid=1),
        _ev("cudaLaunchKernel", 60, 61, cid=2),
        _kernel("compact_kernel", 15, 20, 1),
        _kernel("traverse_kernel", 30, 50, 2),
        _kernel("orphan_kernel", 0, 1, 99),
    ])
    assert spans.device_offset_us(prof) == 30
    # Clocks that agree: no offset.
    prof = SimpleNamespace(events=lambda: [
        _ev("cudaLaunchKernel", 10, 11, cid=1),
        _kernel("compact_kernel", 15, 20, 1)])
    assert spans.device_offset_us(prof) == 0.0


def _two_waves(second=2, early=0.0):
    """Two traced frames: a ``bm.wave`` at 0-100 with 2 kernels (busy 20-40
    and 60-70) and one at 200-300 with ``second`` kernels, the last of
    which starts ``early`` us before its launch call."""
    events = [_ev("bm.wave", 0, 100), _ev("bm.wave", 200, 300),
              _ev("cudaLaunchKernel", 10, 11, cid=1),
              _ev("cudaLaunchKernel", 50, 51, cid=2),
              _kernel("compact_kernel", 20, 40, 1),
              _kernel("traverse_kernel", 60, 70, 2)]
    for j in range(second):
        t = 210 + 40 * j
        events += [_ev("cudaLaunchKernel", t, t + 1, cid=3 + j),
                   _kernel("shade_kernel", t + 10 - early * (j == second - 1),
                           t + 30, 3 + j)]
    prof = SimpleNamespace(events=lambda: events)
    acts = sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == DeviceType.CUDA),
                  key=lambda a: a[1])
    return {"prof": prof, "acts": acts, "units": 2}


def test_readers_refuse_a_profile_that_lost_kernels_or_clocks():
    read = {m: harness.load_metric(m) for m in (
        "wave.launches_per_frame", "wave.host_us_per_launch",
        "wave.idle_ms_per_frame")}
    ctx = _two_waves()
    assert spans.kernels_per_span(ctx["prof"], "bm.wave") == [2, 2]
    assert read["wave.launches_per_frame"](ctx) == 2
    assert read["wave.host_us_per_launch"](ctx) == 200 / 4
    # Idle inside the waves: 0-20, 40-60, 70-100; 200-220, 240-260,
    # 280-300: 130 us over 2 frames.
    assert read["wave.idle_ms_per_frame"](ctx) == pytest.approx(0.065)
    # The second frame lost a kernel: nothing is read.
    short = _two_waves(second=1)
    assert spans.kernels_per_span(short["prof"], "bm.wave") == [2, 1]
    assert spans.whole_kernels(short["prof"], "bm.wave") == []
    assert all(r(short) is None for r in read.values())
    # Device times ahead of their calls by more than the limit: the idle
    # reader, which sets them against host times, reads nothing.
    early = _two_waves(early=spans.OFFSET_LIMIT_US + 20)
    assert spans.device_offset_us(early["prof"]) > spans.OFFSET_LIMIT_US
    assert read["wave.idle_ms_per_frame"](early) is None
    assert read["wave.launches_per_frame"](early) == 2
    ok = _two_waves(early=spans.OFFSET_LIMIT_US - 20)
    assert read["wave.idle_ms_per_frame"](ok) is not None


@pytest.fixture(scope="module")
def cpu_ctx():
    """A CPU profile of the program's spans and counts: its ranges and a
    count are there, device activity is not."""
    from brickmap_tpu_torch.utils import profiling

    profiling.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("bm.wave"):
            with profiling.annotate("bm.wave.trace"):
                profiling.count("wave.trace_rays", torch.tensor([7]))
                torch.ones(8).add_(1.0)
        with profiling.annotate("bm.sparse.slices"), \
                profiling.annotate("bm.sync.tier_read"):
            torch.ones(8).tolist()
        with profiling.annotate("bm.sparse.pack_field"):
            torch.cat([torch.ones(4), torch.zeros(4)])
    acts = yardstick.device_activity(prof)
    yield {"prof": prof, "acts": acts, "units": 1, "busy_s": 0.0,
           "window_s": 1.0}
    profiling.take_counts()


def test_cpu_profile_holds_the_spans(cpu_ctx):
    prof = cpu_ctx["prof"]
    assert cpu_ctx["acts"] == []
    assert len(spans.host_intervals(prof, "bm.wave")) == 1
    assert len(spans.host_intervals(prof, prefix="bm.sync.")) == 1
    assert spans.attributed_kernels(prof, "bm.wave") == []


@pytest.mark.parametrize("metric", NEW)
def test_new_readers_find_nothing_on_a_cpu_profile(cpu_ctx, metric):
    assert harness.load_metric(metric)(dict(cpu_ctx)) is None


def test_port_counts_are_read_once():
    from brickmap_tpu_torch.utils import profiling

    profiling.take_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("wave.trace_rays", torch.tensor([3]))
        profiling.count("wave.trace_rays", 4)
    ctx = {}
    assert spans.port_counts(ctx) == {"wave.trace_rays": [3, 4]}
    assert spans.port_counts(ctx) == {"wave.trace_rays": [3, 4]}
    assert spans.port_counts({}) == {}
