"""The stream cell on the CPU at a tiny size: a sound run is correct, a
faulty manager and the bfloat16 control are not, the readers of its five
metrics on hand-made profiles, and what its files load."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from h100bench import harness
from h100bench.calibrate_stream import NoUnloadedFilter, stream_controls
from h100bench.loops import stream as lstream
from h100bench.reference import stream as rstream

from conftest import SEED, tiny_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRICS = ("stream.pull_ms_per_frame", "stream.plan_ms_per_frame",
           "stream.install_ms_per_frame", "stream.uploads_per_frame",
           "device.idle_pct.stream")


def stream_cell():
    """The cell over a 128^3 world at 64 x 48, cycles of 3 frames, from view
    4 (outside the box: view 0 scaled in sits inside the terrain)."""
    cell = tiny_cell("stream.cold_start")
    cell["traffic_data"] = dict(cell["traffic_data"], view=4, cycle=3)
    return cell


def run(cpu, seed=SEED):
    return harness.Run(stream_cell(), seed, cpu, time.perf_counter()).execute(
        0.3, False)


def test_the_cell_and_its_metrics_resolve():
    spec = harness.cell_spec("stream.cold_start")
    assert spec["traffic_data"]["loop"] == "stream" and spec["chips"] == 1
    assert spec["config_data"]["reduced"] == []
    assert {m["name"] for m in harness.metrics_for(
        "stream.cold_start", "end_to_end")} == {"setup_s", "frame_ms",
                                                "frame_p95_ms"}
    assert sorted(m["name"] for m in harness.metrics_for(
        "stream.cold_start", "per_layer")) == sorted(METRICS)
    assert set(spec["limits"]) == {
        "world_cells_differ", "state_differ", "px_differ", "traced_gap",
        "requests_differ", "exhausted", "uploads_over_queue"}


def test_sound_run_is_correct(cpu):
    out = run(cpu)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}


def test_faulty_manager_fails(cpu, monkeypatch):
    """The program's manager deduping by last occurrence: its slots differ
    from the reference's on the same lists (a seed whose compared frame is
    not its cycle's first)."""
    from brickmap_tpu_torch.stream import StreamingScene

    real = StreamingScene.process_requests

    def last_first(self, requests):
        last = {r: i for i, r in enumerate(requests)}
        n = real(self, sorted(last, key=last.get))
        self.total_requests += len(requests) - len(last)
        return n

    monkeypatch.setattr(StreamingScene, "process_requests", last_first)
    seed = next(s for s in range(SEED, SEED + 50)
                if lstream.Loop(stream_cell()["config_data"],
                                stream_cell()["traffic_data"], s,
                                cpu).compared % 3)
    out = run(cpu, seed)
    assert not out["correct"]
    assert out["checks"]["state_differ"]["value"] > 0


def test_controls(cpu):
    """The bfloat16 control fails by the cell's limits; a manager without
    the unloaded filter reads as the program does, since every request a
    frame pulls names a brick still unloaded when the frame is serviced."""
    cell = stream_cell()
    loop = lstream.Loop(cell["config_data"], cell["traffic_data"], SEED, cpu)
    loop.setup()
    loop.run(0.0)
    got = stream_controls(loop)
    limits = cell["limits"]
    assert any(got["bf16"][k] > v for k, v in limits.items()
               if k in got["bf16"])
    assert all(v == 0 for v in got["all"].values())


def test_without_the_filter_a_stale_list_installs_again(cpu):
    cell = stream_cell()
    loop = lstream.Loop(cell["config_data"], cell["traffic_data"], SEED, cpu)
    loop.setup()
    iv, _, _ = loop.mgr.truth_arrays()
    reqs = [(x, y, z) for z, y, x in zip(*(a[:40].tolist() for a in
                                           (iv != 0).nonzero()))
            if iv[z, y, x] & 0x8000_0000]
    sound, faulty = loop.ref_manager(), loop.ref_manager(NoUnloadedFilter)
    for m in (sound, faulty):
        m.process(reqs)
        m.process(reqs)
    assert sound.totals["total_uploaded"] == len(set(reqs)) > 0
    assert rstream.state_differ(faulty.state(), sound.state()) > 0


# ---- the readers on hand-made profiles ------------------------------------

def _ev(name, start, end, device=DeviceType.CPU, cid=0):
    return SimpleNamespace(name=name, device_type=device, id=cid,
                           time_range=SimpleNamespace(start=start, end=end))


def _kernel(name, start, end, cid):
    return _ev(name, start, end, DeviceType.CUDA, cid)


def _profile():
    """Two traced frames: a pull holding its copy, a plan and an install;
    the second install grows the pool, so it re-bases inside it."""
    events = [
        _ev("bm.stream.pull", 0, 100), _ev("bm.sync.pull_requests", 40, 90),
        _ev("cudaLaunchKernel", 10, 11, cid=1),
        _kernel("compact_requests", 12, 30, 1),
        _ev("bm.stream.plan", 100, 400),
        _ev("bm.stream.install", 400, 450),
        _ev("cudaLaunchKernel", 410, 411, cid=2),
        _kernel("index_copy_kernel", 460, 470, 2),
        _ev("cudaLaunchKernel", 420, 421, cid=3),
        _kernel("index_copy_kernel", 470, 475, 3),
        _ev("bm.stream.pull", 1000, 1150),
        _ev("bm.sync.pull_requests", 1050, 1140),
        _ev("bm.stream.plan", 1150, 1350),
        _ev("bm.stream.install", 1350, 1500),
        _ev("bm.stream.rebase", 1360, 1450),
        _ev("cudaLaunchKernel", 1370, 1371, cid=4),
        _kernel("fill_kernel", 1380, 1400, 4),
        _ev("cudaLaunchKernel", 1380, 1381, cid=5),
        _kernel("gather_kernel", 1400, 1440, 5),
        _ev("cudaMemcpyAsync", 1452, 1453, cid=6),
        _kernel("Memcpy HtoD (Pageable -> Device)", 1455, 1460, 6),
        _ev("cudaLaunchKernel", 1460, 1461, cid=7),
        _kernel("index_copy_kernel", 1470, 1480, 7),
    ]
    prof = SimpleNamespace(events=lambda: events)
    acts = sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == DeviceType.CUDA),
                  key=lambda a: a[1])
    return {"prof": prof, "acts": acts, "units": 2, "loop": "stream",
            "busy_s": 60e-6, "window_s": 1.5e-3,
            "stream_totals": {"total_uploaded": 1500}}


def test_readers_on_a_hand_made_profile():
    ctx = _profile()
    read = {m: harness.load_metric(m) for m in METRICS}
    # The pull spans, each holding its copy: (100 + 150) us over 2 frames.
    assert read["stream.pull_ms_per_frame"](ctx) == pytest.approx(0.125)
    assert read["stream.plan_ms_per_frame"](ctx) == pytest.approx(0.25)
    # Kernels launched inside the installs, the re-base's among them, the
    # copy left out: 10 + 5 + 20 + 40 + 10 us over 2 frames.
    assert read["stream.install_ms_per_frame"](ctx) == pytest.approx(0.0425)
    assert read["stream.uploads_per_frame"](ctx) == 750
    assert read["device.idle_pct.stream"](ctx) == pytest.approx(96.0)
    assert read["device.idle_pct.stream"](dict(ctx, loop="view")) is None


@pytest.mark.parametrize("metric", METRICS)
def test_readers_find_nothing_without_a_trace(metric):
    ctx = _profile()
    assert harness.load_metric(metric)({}) is None
    if metric != "stream.uploads_per_frame":
        assert harness.load_metric(metric)(dict(ctx, acts=[])) is None
    else:
        assert harness.load_metric(metric)(dict(ctx, stream_totals={
            "total_uploaded": None})) is None


LOAD = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench.loops import stream
from h100bench import calibrate_stream
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench.reference import stream
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
