"""Shared pieces of the benchmark's CPU tests: a tiny copy of each cell."""

import copy
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SEED = 2**31 + 77        # larger than 32 signed bits hold, as the driver's


def tiny_cell(name: str) -> dict:
    """The cell's spec over a 128^3 world: 64 x 48 frames held 2 waves a
    view, or 4,096 rays."""
    from h100bench import harness

    cell = harness.cell_spec(name, harness.benchmark())
    c = copy.deepcopy(cell["config_data"])
    c["grid"].update(grid_size=128, grid_height=128)
    if "render" in c:
        c["render"].update(width=64, height=48, max_top_steps=256)
    else:
        c.update(rays=4096, origin_span=[32.0, 96.0], origin_z=125.0)
    cell["config_data"] = c
    if "hold" in cell["traffic_data"]:
        cell["traffic_data"] = dict(cell["traffic_data"], hold=2)
    return cell


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
