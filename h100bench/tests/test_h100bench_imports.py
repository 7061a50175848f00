"""What a run loads: nothing of JAX or the JAX package anywhere, nothing
of the port in the reference; and no result without a card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LOAD_HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench import harness, calibrate, tracing, yardstick
from h100bench.loops import view, train
bench = harness.benchmark()
for m in bench["per_layer"]:
    harness.load_metric(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench.reference import (bits, camera, compare, config, extract,
    record, replay, sampling, sparse, sunsky, traverse, view, wave, world)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str) -> set:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, env=env, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = loaded(LOAD_HARNESS)
    assert not tops & {"jax", "jaxlib", "flax", "brickmap_tpu"}


def test_reference_loads_nothing_of_the_program():
    tops = loaded(LOAD_REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", "brickmap_tpu",
                       "brickmap_tpu_torch"}


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", "view.over_world",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card():
    """One short run of each view cell on the card, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in ("view.over_world", "view.from_outside"):
        out = subprocess.run(
            [sys.executable, "h100bench/run.py", "--workload", cell,
             "--seed", str(2**31 + 9), "--seconds", "2", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
