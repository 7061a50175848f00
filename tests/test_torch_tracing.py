"""The port's own spans and counter (``utils/profiling.py``): nothing is
recorded or kept without a profiler; under one, the wave, the sparse step,
Adam and the streaming manager record their ``bm.*`` spans, nested as the
calls are, and W0's counts, which a ``trace`` drops when it ends; outputs
are the same with and without it."""

import functools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.app.benchmark import active_fields
from brickmap_tpu_torch.config import BrickmapConfig, GridConfig, \
    RenderConfig
from brickmap_tpu_torch.diff import optim, sparse
from brickmap_tpu_torch.kernels.record import record_segments
from brickmap_tpu_torch.ops import sunsky as ss
from brickmap_tpu_torch.render import pathtrace as pt
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for
from brickmap_tpu_torch.stream import StreamingScene, pull_requests
from brickmap_tpu_torch.utils import profiling

torch.set_num_threads(2)

W, H = 64, 48
GRID = GridConfig(grid_size=128, grid_height=128)
CFG = BrickmapConfig(grid=GRID, render=RenderConfig(width=W, height=H,
                                                    max_top_steps=256))
CPU = [ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def world():
    return tscene.generate_terrain_scene(GRID, device="cpu")


def view(pos=(20.0, 20.0, 100.0)):
    d = [64.0 - pos[0], 64.0 - pos[1], 40.0 - pos[2]]
    cam = Camera(position=pos, direction=tuple(
        x / sum(y * y for y in d) ** 0.5 for x in d))
    sun = ss.sun_direction_from_position((0.6, 0.3), "cpu")
    return camera_arrays_for(cam, sun, W, H, "cpu"), cam.brick_position


def wave(scene, seed=5, pos=(20.0, 20.0, 100.0)):
    arrays, brick = view(pos)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return pt.render_wave(scene, arrays, brick, CFG, W, H, generator=gen)


@functools.lru_cache(maxsize=4)
def _ranges(prof) -> tuple:
    """(name, start ns, end ns, parent name) of each ``bm.`` range, the
    parent being the innermost ``bm.`` range around it.  Read from the
    profiler's raw events: its FunctionEvent tree takes minutes to build
    over the ~500k ops of a wave's plain versions."""
    got = sorted(((e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("bm.")),
                 key=lambda r: (r[1], -r[2]))
    out = []
    for i, (n, a, b) in enumerate(got):
        inner = [r for r in got[:i] if r[1] <= a and b <= r[2]]
        parent = min(inner, key=lambda r: r[2] - r[1])[0] if inner else None
        out.append((n, a, b, parent))
    return tuple(out)


def spans(prof, prefix="bm."):
    return [r for r in _ranges(prof) if r[0].startswith(prefix)]


def names(prof, prefix="bm."):
    out = {}
    for n, *_ in spans(prof, prefix):
        out[n] = out.get(n, 0) + 1
    return out


def test_off_records_and_keeps_nothing():
    profiling.take_counts()
    a, b = profiling.annotate("bm.a"), profiling.annotate("bm.b")
    assert a is b
    with a, b:
        profiling.count("x", 3)
        profiling.count("y", torch.ones(1, dtype=torch.int32))
    assert profiling.take_counts() == {}


@pytest.fixture(scope="module")
def profiled_wave(world):
    """A wave under the profiler's warm-up pass, then another under its
    active pass, as ``h100bench/tracing.py::profiled`` runs them; the
    active pass's counts; the same wave again with no profiler."""
    profiling.take_counts()
    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=CPU, schedule=sched) as prof:
        wave(world, seed=1)
        prof.step()
        out = wave(world, seed=2)
        prof.step()
    return prof, out, profiling.take_counts(), wave(world, seed=2)


def test_wave_spans_nest(profiled_wave):
    prof = profiled_wave[0]
    n = CFG.render.max_bounces + 2
    assert names(prof) == {"bm.wave": 1, "bm.wave.uniforms": 1,
                           "bm.wave.primary": 1, "bm.wave.trace": n,
                           "bm.wave.shade": n}
    top = spans(prof, "bm.wave")[0]
    assert top[3] is None
    for name, a, b, parent in spans(prof, "bm.wave."):
        assert parent == "bm.wave", name
    traces = [s for s in spans(prof) if s[0] in ("bm.wave.trace",
                                                 "bm.wave.shade")]
    assert [s[0] for s in traces] == ["bm.wave.trace",
                                      "bm.wave.shade"] * n


def test_only_the_active_pass_keeps_counts(profiled_wave):
    _, (_, _, req), counts, _ = profiled_wave
    assert sorted(counts) == ["wave.graph_replays", "wave.trace_rays"]
    assert counts["wave.graph_replays"] == [0]     # the CPU's wave is eager
    assert len(counts["wave.trace_rays"]) == CFG.render.max_bounces + 2
    assert sum(counts["wave.trace_rays"]) == int(req["traced_rays"]) > 0
    assert profiling.take_counts() == {}


def test_wave_outputs_equal_with_and_without_a_profiler(profiled_wave):
    _, (rgb1, count1, req1), _, (rgb0, count0, req0) = profiled_wave
    assert torch.equal(rgb0, rgb1) and torch.equal(count0, count1)
    for k in ("mask", "pos", "traced_rays", "exhausted_rays"):
        assert torch.equal(req0[k], req1[k]), k


def test_trace_drops_the_counts_left_when_it_ends(tmp_path):
    profiling.take_counts()
    with profiling.trace(str(tmp_path), "cpu"):
        profiling.count("x", 3)
        profiling.count("y", torch.ones(1, dtype=torch.int32))
        assert profiling.take_counts() == {"x": [3], "y": [1]}
        profiling.count("x", 4)
    assert profiling.take_counts() == {}
    assert list(tmp_path.glob("*.pt.trace.json"))


@pytest.fixture(scope="module")
def problem(world):
    """A fixed batch of rays from above and fields over the bricks they
    reach (the benchmark's training frame at 128^3)."""
    gen = torch.Generator()
    gen.manual_seed(11)
    n = 2048
    xy = 32.0 + 64.0 * torch.rand((n, 2), generator=gen)
    o = torch.cat([xy, torch.full((n, 1), 125.0)], dim=1)
    d = torch.randn((n, 3), generator=gen)
    d[:, 2] = -d[:, 2].abs() - 1.0
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    segs = record_segments(o, d, world, GRID, k_segments=8)
    cellmap, occ, alb = active_fields(world, GRID, segs["cells"])
    bg = torch.full((n, 3), 0.2)
    tgt = torch.full((n, 3), 0.4)
    return o, d, cellmap, occ, alb, bg, tgt


def step(world, problem, cache):
    o, d, cellmap, occ, alb, bg, tgt = problem
    return sparse.l2_loss_and_grads_sparse(
        o, d, world, cellmap, occ, alb, bg, tgt, GRID, k_segments=8,
        seg_cache=cache)


def test_sparse_step_spans(world, problem):
    cache = {}
    once = dict.fromkeys(("bm.sparse.step", "bm.sparse.pack_field",
                          "bm.sparse.zero_grad", "bm.sparse.slices",
                          "bm.sparse.finalize", "bm.sync.tier_read"), 1)
    with profile(activities=CPU) as prof:
        step(world, problem, cache)            # records the segments
    assert names(prof) == once
    with profile(activities=CPU) as prof:
        step(world, problem, cache)            # the cached step
    assert names(prof) == once
    for name, _, _, parent in spans(prof):
        assert parent == (None if name == "bm.sparse.step"
                          else "bm.sparse.step"), name
    read = spans(prof, "bm.sync.tier_read")[0]
    slices = spans(prof, "bm.sparse.slices")[0]
    assert read[2] <= slices[1]


def test_sparse_step_and_adam_equal_with_and_without_a_profiler(world,
                                                                problem):
    cache = {}
    step(world, problem, cache)
    loss0, (go0, ga0) = step(world, problem, cache)
    with profile(activities=CPU):
        loss1, (go1, ga1) = step(world, problem, cache)
    assert torch.equal(loss0, loss1)
    assert torch.equal(go0, go1) and torch.equal(ga0, ga1)
    outs = []
    for on in (False, True):
        params = tuple(p.clone() for p in problem[3:5])
        opt = optim.make_adam(params, 0.05)
        if on:
            with profile(activities=CPU) as prof:
                optim.adam_step(opt, params, (go0, ga0))
            assert [(n, p) for n, _, _, p in spans(prof)] == [
                ("bm.optim.adam_step", None)]
        else:
            optim.adam_step(opt, params, (go0, ga0))
        outs.append(params)
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_streaming_spans(world):
    mgr = StreamingScene(world, GRID, queue_size=64, device="cpu")
    _, _, req = wave(mgr.device_scene())
    with profile(activities=CPU) as prof:
        got = pull_requests(req, mgr.queue_size)
        uploads = mgr.process_requests(got)
    assert got and uploads > 0
    want = {"bm.stream.pull": 1, "bm.sync.pull_requests": 1,
            "bm.stream.plan": 1, "bm.stream.install": 1}
    if mgr.total_rebases:
        want["bm.stream.rebase"] = 1
    assert names(prof) == want
    with profile(activities=CPU) as prof:
        mgr.reset()
    assert names(prof) == {"bm.stream.reset": 1}
