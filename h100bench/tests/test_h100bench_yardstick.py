"""The frozen counts equal values worked by hand at tiny shapes."""

import pytest
import torch

from h100bench import yardstick as ys

BW, F = 3.35e12, 67e12


def test_bound_takes_the_larger():
    assert ys.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert ys.bound_s(0, 67e12) == pytest.approx(1.0)
    assert ys.bound_s(3.35e9, 134e12) == pytest.approx(2.0)


def test_b2_bound_by_hand():
    # 10 rays: 800 B; 3 index words: 12 B; 2 brick rows: 128 B.
    t = {"rays": 10, "b2_words": 3, "b2_rows": 2, "b2_steps": 50}
    assert ys.b2_bound_s(t) == pytest.approx(max(940 / BW, 600 / F))
    # Enough steps that the operations bind: 10^9 steps x 12.
    t["b2_steps"] = 10 ** 9
    assert ys.b2_bound_s(t) == pytest.approx(12e9 / F)


def test_wave_bounds_by_hand():
    lanes = 4
    traces = [{"rows": 8, "rays": 4, "exhausted": 1, "w4_words": 2,
               "w4_rows": 1, "w4_steps": 10},
              {"rows": 8, "rays": 2, "exhausted": 0, "w4_words": 0,
               "w4_rows": 0, "w4_steps": 0}]
    b = ys.wave_bounds_s(lanes, traces)
    assert b["W1"] == pytest.approx(max(4 * 127 / BW, 4 * 70 / F))
    # W0: (8 + 16 + 4) + (4 + 4 + 4), then (8 + 8 + 4) + (2 + 0 + 4).
    assert b["W0"] == pytest.approx((28 + 12 + 20 + 6) / BW)
    assert b["W2"] == pytest.approx(max(4 * 73 / BW, 240 / F)
                                    + max(2 * 73 / BW, 120 / F))
    # W3: a bounce 4 x 174 + 4 x 35, the final pass 4 x 92 + 2 x 35.
    assert b["W3"] == pytest.approx(max(836 / BW, 1200 / F)
                                    + max(438 / BW, 1200 / F))
    # W4: 71 + 8 + 64 B over one rescued ray; the 4-byte count alone.
    assert b["W4"] == pytest.approx(143 / BW + 4 / BW)


def test_replay_bounds_by_hand():
    s = {"rays": 2, "segments": 4, "valid_segments": 3, "moving": 7,
         "cell_words": 3, "valid_steps": 10}
    b = ys.replay_bounds_s([s])
    entries = 4 * 22
    r1_bytes = 72 + 48 + 12 + 92 * 4
    r1_ops = 1654 * 3 + 22 * 21 * 7
    assert b["R1"] == pytest.approx(max(r1_bytes / BW, r1_ops / F))
    assert b["B4f"] == pytest.approx((16 + 4 * entries + 160
                                      + 16 * entries) / BW)
    assert b["R2"] == pytest.approx(max((36 * entries + 56) / BW, 310 / F))
    assert b["B4b"] == pytest.approx(max((16 + 20 * entries + 320) / BW,
                                         40 / F))


def test_slice_counts_by_hand():
    cells = torch.tensor([[5, 7, -1], [5, -1, -1]], dtype=torch.int32)
    direction = torch.tensor([[1.0, 0.0, -1.0], [0.5, 0.5, -0.7]])
    lin2 = torch.tensor([[0, 1, -1], [2, -1, -1], [-1, -1, -1],
                         [3, 4, 5], [-1, -1, -1], [-1, -1, -1]],
                        dtype=torch.int32)
    c = ys.slice_counts(cells, direction, lin2)
    assert c == {"rays": 2, "segments": 6, "valid_segments": 3,
                 "moving": 2 * 2 + 1 * 3, "cell_words": 2,
                 "valid_steps": 6}


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert ys.percentile(v, 95) == 95
    assert ys.percentile([3.0], 95) == 3.0
    assert ys.percentile([1, 2, 3, 4], 50) == 2


def test_busy_is_the_union():
    acts = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
            ("d", 21.0, 22.0)]
    assert ys.busy_s(acts) == pytest.approx(17e-6)
    assert ys.kernel_seconds([("void traverse_kernel(int)", 0.0, 4.0),
                              ("traverse_kernel_x", 0.0, 9.0)],
                             ys.B2_KERNELS) == pytest.approx(4e-6)
