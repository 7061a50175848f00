"""The live cell on the CPU at a tiny size: a sound run is correct, a faulty
presentation, fly camera or manager is not, the calibration's controls fail
the cell's limits, the readers of its five metrics on hand-made profiles,
and what its files load."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from h100bench import harness
from h100bench.calibrate_live import live_controls
from h100bench.loops import live as llive
from h100bench.reference import live as rlive

from conftest import SEED, tiny_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRICS = ("live.input_ms_per_frame", "live.present_ms_per_frame",
           "blit.roofline_pct", "live.rebased_rows_per_frame",
           "device.idle_pct.live")


def live_cell():
    """The cell over a 128^3 world at 64 x 48, a tour of views 4-6 (outside
    the box: views 0-3 scaled in sit in the terrain), 2 frames a leg."""
    cell = tiny_cell("view.preview_540p")
    cell["traffic_data"] = dict(cell["traffic_data"], views=[4, 5, 6],
                                frames_per_leg=2)
    return cell


def run(cpu, seed=SEED, trace=False):
    return harness.Run(live_cell(), seed, cpu, time.perf_counter()).execute(
        0.3, trace)


def test_the_cell_and_its_metrics_resolve():
    spec = harness.cell_spec("view.preview_540p")
    assert spec["traffic_data"] == {"loop": "live", "views": [0, 1, 2, 3],
                                    "frames_per_leg": 240}
    assert spec["chips"] == 1 and spec["config_data"]["reduced"] == []
    stream = harness.cell_spec("stream.cold_start")["config_data"]
    for k in ("grid", "render", "sun_position", "viewpoints", "streaming",
              "precision"):
        assert spec["config_data"][k] == stream[k], k
    assert {m["name"] for m in harness.metrics_for(
        "view.preview_540p", "end_to_end")} == {"setup_s", "frame_ms",
                                                "frame_p95_ms"}
    assert sorted(m["name"] for m in harness.metrics_for(
        "view.preview_540p", "per_layer")) == sorted(METRICS)
    assert spec["limits"] == {
        "world_cells_differ": 50000, "state_differ": 0, "pose_differ": 0,
        "frame8_differ": 0, "px_differ": 0.01, "traced_gap": 1e-3,
        "requests_differ": 0.01, "exhausted": 0, "uploads_over_queue": 0}


def test_sound_run_is_correct(cpu):
    out = run(cpu)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}
    assert all(c["value"] == 0 for k, c in out["checks"].items()
               if k != "world_cells_differ")


def test_traced_run_reads_the_counter(cpu):
    """On the CPU the profile holds no device activity, so only the
    program's counter reads."""
    out = run(cpu, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) <= {"live.rebased_rows_per_frame"}


def test_faulty_presentation_fails(cpu, monkeypatch):
    """A presentation that truncates without the + 0.5: the frame the
    server received differs from the reference's."""
    from brickmap_tpu_torch.render import pathtrace

    monkeypatch.setattr(pathtrace, "present", lambda film, w, h: (
        rlive.present(film["rgb"], film["count"], w, h, half=0.0)))
    out = run(cpu)
    assert not out["correct"]
    assert out["checks"]["frame8_differ"]["value"] > 0


def test_faulty_fly_camera_fails(cpu, monkeypatch):
    """A fly-camera step in float32: the camera after the inputs differs."""
    from brickmap_tpu_torch.app import live

    monkeypatch.setattr(live, "_apply_camera_input",
                        lambda cam, d, s: rlive.fly(cam, d, s, np.float32))
    out = run(cpu)
    assert not out["correct"]
    assert out["checks"]["pose_differ"]["value"] > 0


def test_faulty_manager_fails(cpu, monkeypatch):
    """The program's manager deduping by last occurrence: its residency
    differs from the reference's on the same lists."""
    from brickmap_tpu_torch.stream import StreamingScene

    real = StreamingScene.process_requests

    def last_first(self, requests):
        last = {r: i for i, r in enumerate(requests)}
        n = real(self, sorted(last, key=last.get))
        self.total_requests += len(requests) - len(last)
        return n

    monkeypatch.setattr(StreamingScene, "process_requests", last_first)
    cell = live_cell()
    seed = next(s for s in range(SEED, SEED + 50)
                if llive.Loop(cell["config_data"], cell["traffic_data"], s,
                              cpu).compared % 4)
    out = run(cpu, seed)
    assert not out["correct"]
    assert out["checks"]["state_differ"]["value"] > 0


def test_controls_fail_the_limits(cpu):
    """Each of the calibration's three controls fails at least one of the
    cell's limits."""
    cell = live_cell()
    loop = llive.Loop(cell["config_data"], cell["traffic_data"], SEED, cpu)
    loop.setup()
    loop.run(0.0)
    got = live_controls(loop)
    loop.server.close()
    limits = cell["limits"]
    for name in ("half", "f32", "bf16"):
        assert any(v > limits[k] for k, v in got[name].items()), name
    assert got["half"]["frame8_differ"] > 0
    assert got["f32"]["pose_differ"] > 0


def test_tour_inputs_reach_each_view_at_any_size():
    cell = live_cell()
    loop = llive.Loop(cell["config_data"], cell["traffic_data"], SEED, None)
    loop.inputs = llive.tour_inputs(loop.poses, loop.per_leg,
                                    loop.move_scale)
    assert len(loop.inputs) == loop.cycle == 4
    for k in (1, 3):
        cam = loop.ref_camera(k)
        want = rlive.Camera.from_angles(*loop.poses[(k + 1) // 2])
        np.testing.assert_allclose(cam.position, want.position, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(cam.direction, want.direction,
                                   atol=1e-12, rtol=0)


# ---- the readers on hand-made profiles ------------------------------------

def _ev(name, start, end, device=DeviceType.CPU, cid=0):
    return SimpleNamespace(name=name, device_type=device, id=cid,
                           time_range=SimpleNamespace(start=start, end=end))


def _kernel(name, start, end, cid):
    return _ev(name, start, end, DeviceType.CUDA, cid)


def _profile():
    """Two traced frames, each an input, a wave and a presentation; the
    second frame's W5 ran 8 us, the first's 12."""
    events = [
        _ev("bm.live.frame", 0, 1000), _ev("bm.live.input", 0, 100),
        _ev("bm.wave", 100, 600),
        _ev("cudaLaunchKernel", 150, 151, cid=1),
        _kernel("traverse_kernel", 200, 500, 1),
        _ev("bm.live.present", 700, 1000),
        _ev("cudaLaunchKernel", 710, 711, cid=2),
        _kernel("(anonymous namespace)::blit_kernel(int, float const*, "
                "float const*, unsigned char*)", 720, 732, 2),
        _ev("bm.live.frame", 1000, 2000), _ev("bm.live.input", 1000, 1200),
        _ev("bm.live.present", 1600, 1800),
        _ev("cudaLaunchKernel", 1610, 1611, cid=3),
        _kernel("blit_kernel", 1620, 1628, 3),
    ]
    prof = SimpleNamespace(events=lambda: events)
    acts = sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == DeviceType.CUDA),
                  key=lambda a: a[1])
    return {"prof": prof, "acts": acts, "units": 2, "loop": "live",
            "busy_s": 320e-6, "window_s": 2e-3, "live_pixels": 518_400,
            "live_totals": {"total_rebased_rows": 3000}}


def test_readers_on_a_hand_made_profile():
    ctx = _profile()
    read = {m: harness.load_metric(m) for m in METRICS}
    assert read["live.input_ms_per_frame"](ctx) == pytest.approx(0.15)
    assert read["live.present_ms_per_frame"](ctx) == pytest.approx(0.25)
    # 19 B x 518,400 pixels over 3.35 TB/s = 2.94 us a launch, two launches
    # in 20 us of W5.
    assert read["blit.roofline_pct"](ctx) == pytest.approx(
        100 * 2 * 19 * 518_400 / 3.35e12 / 20e-6)
    assert read["live.rebased_rows_per_frame"](ctx) == 1500
    assert read["device.idle_pct.live"](ctx) == pytest.approx(84.0)
    assert read["device.idle_pct.live"](dict(ctx, loop="stream")) is None


@pytest.mark.parametrize("metric", METRICS)
def test_readers_find_nothing_without_a_trace(metric):
    ctx = _profile()
    assert harness.load_metric(metric)({}) is None
    if metric == "live.rebased_rows_per_frame":
        # A program without the counter (the parent) reads None there.
        ctx["live_totals"] = {"total_rebased_rows": None}
    else:
        ctx["acts"] = []
    assert harness.load_metric(metric)(ctx) is None


LOAD = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench.loops import live
from h100bench import calibrate_live
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench.reference import live
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(code):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_loop_loads_no_jax_and_reference_nothing_of_the_program():
    assert not _loaded(LOAD) & {"jax", "jaxlib", "flax", "brickmap_tpu"}
    assert not _loaded(LOAD_REFERENCE) & {
        "jax", "jaxlib", "flax", "brickmap_tpu", "brickmap_tpu_torch"}
