"""The pull's rows (``RequestRows``) against the list of tuples they stand
for, ``StreamingScene.plan`` on the rows and on the same list, the
``total_listed`` counter, and the collector's count across a pull and its
servicing; on the CPU over the 128^3 terrain world of the stream tests."""

import gc

import numpy as np
import pytest
import torch

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.stream import RequestRows, StreamingScene, \
    pull_requests

GRID = GridConfig(grid_size=128, grid_height=128)


@pytest.fixture(scope="module")
def truth():
    return tscene.generate_terrain_scene(GRID, use_native=False,
                                         device="cpu")


def wave(truth, rng, lanes, requests):
    """A wave's request outputs (``mask`` bool [lanes], ``pos`` int32
    [lanes, 3]) with ``requests`` lanes set at random, asking for
    non-empty bricks with repeats and a few empty cells."""
    iv = truth.index_volume.numpy().view(np.uint32)
    full = np.argwhere(iv & np.uint32(0xE000_0000))[:, ::-1]
    empty = np.argwhere((iv & np.uint32(0xE000_0000)) == 0)[:, ::-1]
    pos = full[rng.integers(0, full.shape[0], lanes)].astype(np.int32)
    pos[rng.integers(0, lanes, lanes // 64)] = empty[
        rng.integers(0, empty.shape[0], lanes // 64)]
    pos[1::3] = pos[::3][:pos[1::3].shape[0]]             # repeats
    mask = np.zeros(lanes, bool)
    mask[rng.choice(lanes, requests, replace=False)] = True
    return {"mask": torch.from_numpy(mask), "pos": torch.from_numpy(pos)}


def as_list(req, queue_size):
    """The same pull as a list of tuples of Python ints: the contract
    the rows keep."""
    mask, pos = req["mask"].numpy(), req["pos"].numpy()
    return [tuple(int(v) for v in r) for r in pos[mask][:4 * queue_size]]


def manager(truth, queue_size=64):
    return StreamingScene(truth, GRID, queue_size=queue_size,
                          starting_capacity=4, device="cpu")


@pytest.mark.parametrize("queue_size, requests", [(64, 100), (16, 300)])
def test_rows_read_as_the_list(truth, rng, queue_size, requests):
    req = wave(truth, rng, 1024, requests)
    got = pull_requests(req, queue_size)
    want = as_list(req, queue_size)
    assert isinstance(got, RequestRows)
    assert len(got) == len(want) == min(requests, 4 * queue_size)
    assert got[0] == want[0] and got[-1] == want[-1]
    assert all(type(v) is int for v in got[5])
    assert got[3:17] == want[3:17] and isinstance(got[3:17], list)
    assert got[::-5] == want[::-5]
    assert list(got) == want and all(type(r) is tuple for r in got)
    assert got == want and want == got and not got != want
    assert got != [] and got != want[:-1]
    assert got == pull_requests(req, queue_size)
    with pytest.raises(IndexError):
        got[len(want)]
    rows = np.asarray(got)
    assert rows.dtype == np.int32 and rows.shape == (len(want), 3)
    assert np.shares_memory(rows, np.asarray(got, np.int32))
    np.testing.assert_array_equal(rows, np.array(want, np.int32))
    assert not rows.flags.writeable
    with pytest.raises(ValueError):
        rows[0, 0] = 1
    wide = np.asarray(got, np.int64)
    assert wide.dtype == np.int64 and not np.shares_memory(wide, rows)
    np.testing.assert_array_equal(wide, rows)
    with pytest.raises(ValueError):
        np.array(got, np.int64, copy=False)


def test_empty_rows(truth, rng):
    req = wave(truth, rng, 256, 0)
    got = pull_requests(req, 64)
    assert got == [] and [] == got and len(got) == 0 and not got
    assert list(got) == [] and got[:3] == []
    assert np.asarray(got).shape == (0, 3)
    assert manager(truth).process_requests(got) == 0


def test_rows_and_list_plan_alike(truth, rng):
    """Each wave's rows and the same list planned by two managers: equal
    batches (rows, growth, old bases, kept counts), then equal states."""
    by_rows, by_list = manager(truth), manager(truth)
    batches = 0
    for _ in range(6):
        req = wave(truth, rng, 1024, 400)
        got = pull_requests(req, by_rows.queue_size)
        a, b = by_rows.plan(got), by_list.plan(as_list(req,
                                                       by_list.queue_size))
        assert (a is None) == (b is None)
        if a is None:
            continue
        batches += 1
        np.testing.assert_array_equal(a.rows, b.rows)
        assert a.grew == b.grew
        np.testing.assert_array_equal(a.old_base, b.old_base)
        np.testing.assert_array_equal(a.kept, b.kept)
        by_rows.install(a)
        by_list.install(b)
    assert batches > 0 and by_rows.total_rebases > 0
    sa, sb = by_rows.state(), by_list.state()
    assert set(sa) == set(sb) and "total_listed" not in sa
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_total_listed(truth, rng):
    """0 over a cycle driven as the benchmark drives it (the pull's rows
    straight into ``process_requests``, then a reset); the lanes of a
    list, a generator or tuples otherwise."""
    mgr = manager(truth)
    for _ in range(4):
        got = pull_requests(wave(truth, rng, 1024, 300), mgr.queue_size)
        mgr.process_requests(got)
    assert mgr.total_listed == 0 and mgr.total_requests == 4 * 256
    assert mgr.total_uploaded > 0
    mgr.reset()
    assert mgr.total_listed == 0 and mgr.total_requests == 0
    got = pull_requests(wave(truth, rng, 1024, 300), mgr.queue_size)
    mgr.process_requests(np.asarray(got))
    assert mgr.total_listed == 0
    mgr.process_requests(list(got))
    assert mgr.total_listed == len(got)
    mgr.process_requests(r for r in got[:10])
    mgr.process_requests(tuple(got[:7]))
    assert mgr.total_listed == len(got) + 17
    assert mgr.total_requests == 2 * len(got) + 17
    mgr.reset()
    assert mgr.total_listed == 0


def test_pull_and_service_make_no_object_a_lane(truth, rng):
    """With the collector off, one pull of 4,096 lanes and its servicing
    leave fewer than 256 new objects in the collector's youngest
    generation (a list of tuples would leave one a lane)."""
    mgr = manager(truth, queue_size=1024)
    mgr.process_requests(pull_requests(wave(truth, rng, 16384, 5000),
                                       mgr.queue_size))   # warm-up
    req = wave(truth, rng, 16384, 5000)
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        before = gc.get_count()[0]
        got = pull_requests(req, mgr.queue_size)
        uploads = mgr.process_requests(got)
        rise = gc.get_count()[0] - before
    finally:
        if was_enabled:
            gc.enable()
    assert len(got) == 4096 and uploads > 0
    assert rise < 256, rise
