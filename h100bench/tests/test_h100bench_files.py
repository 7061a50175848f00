"""The benchmark finds every cell's and metric's files by name, and
``BENCHMARK.json`` keeps to its contract's shape."""

import json
import os
import re
import shutil

import pytest

from h100bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    spec = harness.cell_spec(cell, BENCH)
    loop = harness.load_loop(spec["traffic_data"]["loop"])
    assert hasattr(loop, "Loop")
    assert set(spec["limits"]) and all(
        isinstance(v, (int, float)) for v in spec["limits"].values())
    e2e = {m["name"] for m in harness.metrics_for(cell, "end_to_end", BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metrics_for(cell, "per_layer", BENCH)
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    read = harness.load_metric(metric)
    assert read({}) is None           # nothing to read: no number


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
    """A metric, traffic mix and cell added as files and entries only."""
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "h100bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "view.one_view",
                               "config": "terrain_view_1080p",
                               "traffic": "one_view", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "test.frames", "unit": "1",
                               "better": "higher", "source": "program_span",
                               "layer": "wave", "moves": "frame_ms",
                               "workloads": ["view.one_view"]})
    h = root / "h100bench"
    (h / "traffic" / "one_view.json").write_text(
        '{"loop": "view", "views": [3], "hold": 8}')
    shutil.copy(h / "limits" / "view.over_world.json",
                h / "limits" / "view.one_view.json")
    (h / "metrics" / "test.frames.py").write_text(
        "def read(ctx):\n    return float(len(ctx['spans']['frame']))\n")
    monkeypatch.setattr(harness, "HERE", str(h))
    spec = harness.cell_spec("view.one_view", bench)
    assert spec["traffic_data"]["views"] == [3]
    names = [m["name"] for m in
             harness.metrics_for("view.one_view", "per_layer", bench)]
    assert names == ["test.frames"]
    assert harness.load_metric("test.frames")(
        {"spans": {"frame": [1, 2]}}) == 2.0


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(os.path.dirname(harness.HERE), p))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(os.path.dirname(harness.HERE),
                               c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("roofline_pct"):
            assert m["unit"] == "%"
