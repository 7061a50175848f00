"""StreamingScene.reset(): residency back to cold without the truth, the
streaming spans and the manager's totals, on the CPU over a small terrain
world."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.stream import StreamingScene, pull_requests

GRID = GridConfig(grid_size=128, grid_height=128)
TOTALS = ("total_requests", "total_uploaded", "total_dropped",
          "total_rebases")


@pytest.fixture(scope="module")
def truth():
    return tscene.generate_terrain_scene(GRID, use_native=False,
                                         device="cpu")


def request_lists(truth, seed, n_lists=4, size=300):
    """Seeded lists of brick coordinates: mostly non-empty bricks, with
    repeats, a few empty cells, more distinct bricks than the queue."""
    rng = np.random.default_rng(seed)
    iv = truth.index_volume.numpy().view(np.uint32)
    zz, yy, xx = np.nonzero(iv & np.uint32(0xE000_0000))
    ez, ey, ex = np.nonzero((iv & np.uint32(0xE000_0000)) == 0)
    out = []
    for _ in range(n_lists):
        pick = rng.integers(0, zz.shape[0], size)
        reqs = [(int(xx[i]), int(yy[i]), int(zz[i])) for i in pick]
        reqs += reqs[:size // 4]
        for i in rng.integers(0, ez.shape[0], 8):
            reqs.insert(int(rng.integers(0, len(reqs))),
                        (int(ex[i]), int(ey[i]), int(ez[i])))
        out.append(reqs)
    return out


def manager(truth):
    return StreamingScene(truth, GRID, queue_size=64, starting_capacity=4,
                          device="cpu")


def assert_states_equal(a, b, skip=("total_resets",)):
    assert set(a) == set(b)
    for k in a:
        if k not in skip:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_reset_equals_a_fresh_manager(truth):
    mgr, fresh = manager(truth), manager(truth)
    for reqs in request_lists(truth, 1):
        mgr.process_requests(reqs)
    assert mgr.total_uploaded > 0 and mgr.total_dropped > 0
    assert mgr.total_rebases > 0 and mgr.pool_rows > fresh.pool_rows
    mgr.reset()
    assert_states_equal(mgr.state(), fresh.state())
    assert mgr.total_resets == 1 and fresh.total_resets == 0
    assert all(getattr(mgr, k) == 0 for k in TOTALS)
    assert mgr.pool_rows == fresh.pool_rows
    assert mgr.device_scene().pool_words.shape == \
        fresh.device_scene().pool_words.shape


def test_same_lists_after_a_reset_give_a_fresh_managers_states(truth):
    lists = request_lists(truth, 2)
    mgr = manager(truth)
    for reqs in request_lists(truth, 3):
        mgr.process_requests(reqs)
    mgr.reset()
    fresh = manager(truth)
    for reqs in lists + lists[:1]:        # the last list is stale
        assert mgr.process_requests(reqs) == fresh.process_requests(reqs)
        assert_states_equal(mgr.state(), fresh.state())
    mgr.reset()
    mgr.reset()
    assert mgr.total_resets == 3
    assert_states_equal(mgr.state(), manager(truth).state())


def test_reset_does_not_read_the_truth(truth):
    mgr = manager(truth)
    for reqs in request_lists(truth, 4):
        mgr.process_requests(reqs)
    mgr._truth_iv = mgr._truth_pool = mgr._truth_base = None
    mgr.reset()
    assert_states_equal(mgr.state(), manager(truth).state())


def test_state_is_a_snapshot(truth):
    mgr = manager(truth)
    before = mgr.state()
    mgr.process_requests(request_lists(truth, 5, n_lists=1)[0])
    assert_states_equal(before, manager(truth).state())


def _spans(prof):
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith(("bm.stream", "bm.sync")))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_spans_and_totals(truth):
    mgr = manager(truth)
    lanes = 700
    rng = np.random.default_rng(6)
    reqs = request_lists(truth, 6, n_lists=1, size=lanes)[0][:lanes]
    mask = torch.zeros(4 * lanes, dtype=torch.bool)
    mask[torch.from_numpy(rng.choice(4 * lanes, lanes, replace=False))] = True
    pos = torch.zeros((4 * lanes, 3), dtype=torch.int32)
    pos[mask] = torch.tensor(reqs, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = pull_requests({"mask": mask, "pos": pos}, mgr.queue_size)
        mgr.process_requests(got)
        mgr.reset()
    assert got == reqs[:4 * mgr.queue_size]
    spans = _spans(prof)
    by = {}
    for a, b, n in spans:
        by.setdefault(n, []).append((a, b))
    assert {n: len(v) for n, v in by.items()} == {
        "bm.stream.pull": 1, "bm.sync.pull_requests": 1,
        "bm.stream.plan": 1, "bm.stream.install": 1, "bm.stream.rebase": 1,
        "bm.stream.reset": 1}
    assert _inside(by["bm.sync.pull_requests"][0], by["bm.stream.pull"][0])
    assert _inside(by["bm.stream.rebase"][0], by["bm.stream.install"][0])
    # The totals: cleared by the reset, which counts itself.
    assert mgr.total_resets == 1
    assert all(getattr(mgr, k) == 0 for k in TOTALS)
    mgr.process_requests(got)
    mgr.process_requests(got[:10])           # stale: nothing to install
    st = mgr.state()
    assert st["total_requests"] == len(got) + 10
    assert st["total_uploaded"] == mgr.queue_size
    iv = truth.index_volume.numpy()
    bricks = {b for b in got if iv[b[2], b[1], b[0]] < 0}    # loaded bit
    assert st["total_dropped"] == len(bricks) - mgr.queue_size
    assert st["total_rebases"] == 1 and st["total_resets"] == 1
