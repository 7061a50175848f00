"""Kernel A1 (``csrc/adam.cu``) built with g++ through ``csrc/host_shim.h``
and run on the CPU, against its plain version
(:func:`brickmap_tpu_torch.ops.adam.adam_update_plain`).

The launcher is driven through the wrapper's own ctypes signature and
arguments (:func:`~brickmap_tpu_torch.kernels.adam.adam_args`) with CPU
tensors.  Every operation of the update is an IEEE multiply, add, divide,
square root or compare, which the g++ build (no FMA contraction) and the
plain version (its square root taken in double, then rounded) round alike,
so parameters and both moments are held bit for bit (a NaN only as a NaN):

* element counts 1, 3, 4, 5, 1023, 4097 and 20,000, an occupancy-like leaf
  of n elements and an albedo-like leaf of 3n, one launch each: the
  16-byte words, the scalar tail of n % 4 and more words than the shim's
  resident grid of 1,024 threads, so that the grid-stride loops turn;
* steps 1 to 3 in turn, so that the bias corrections change between
  launches;
* gradients of exactly 0, parameters at 0 and 1 and updates that cross
  them, and a NaN gradient, which leaves NaN in the parameter (as
  ``clamp_`` does);
* a leaf whose arrays start off a 16-byte boundary, which takes the scalar
  loop for every element.

The wrapper's checks refuse a gradient or moment of another shape (one of
the same size, too), dtype or device, moments that are not contiguous and
a step below 1.  Skipped only where there is no g++.
"""

import ctypes
import shutil

import pytest
import torch

from brickmap_tpu_torch.kernels import adam as kadam
from brickmap_tpu_torch.ops.adam import adam_update_plain, step_scalars
from _host_build import host_build

torch.set_num_threads(2)

LR, BETAS, EPS = 0.05, (0.9, 0.999), 1e-8


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    so = ctypes.CDLL(host_build("adam",
                                str(tmp_path_factory.mktemp("ahost"))))
    kadam._bind(so)
    return so


def leaf(n, gen, edges=True):
    """(p, g, m, v) of n float32 elements: parameters in [0, 1] with some at
    0 and 1 exactly, gradients of either sign, some exactly 0 and some
    large enough to push a parameter across 0 or 1, moments of a few steps
    before (v >= 0)."""
    p = torch.rand(n, generator=gen)
    g = torch.randn(n, generator=gen) * 0.1
    m = torch.randn(n, generator=gen) * 0.01
    v = torch.rand(n, generator=gen) * 1e-3
    if edges:
        pick = torch.randint(0, 8, (n,), generator=gen)
        p[pick == 0] = 0.0
        p[pick == 1] = 1.0
        g[pick == 2] = 0.0
        g[pick == 3] = 50.0            # a large step down, through 0
        g[pick == 4] = -50.0           # and up, through 1
        p[pick == 5] = 1e-3
        g[pick == 6] = 0.0             # and on zero moments
        m[pick == 6] = 0.0
        v[pick == 6] = 0.0
    return [p, g, m, v]


def run_kernel(lib, leaves):
    """One launch a leaf of ``leaves`` ([p, g, m, v, step]), in place."""
    for p, g, m, v, step in leaves:
        assert lib.adam_launch(*kadam.adam_args(p, g, m, v, step, LR, BETAS,
                                                EPS, None)) == 0


def run_plain(leaves):
    for p, g, m, v, step in leaves:
        adam_update_plain(p, g, m, v, *BETAS, EPS,
                          *step_scalars(LR, *BETAS, step))


def assert_bits_equal(got, want, what):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), what


def check(lib, leaves):
    """The kernel on copies of ``leaves`` equal to the plain version on
    other copies, every array bit for bit."""
    k = [[t.clone() for t in lf[:4]] + [lf[4]] for lf in leaves]
    w = [[t.clone() for t in lf[:4]] + [lf[4]] for lf in leaves]
    run_kernel(lib, k)
    run_plain(w)
    for i, (a, b) in enumerate(zip(k, w)):
        for name, x, y in zip("pmv", (a[0], a[2], a[3]), (b[0], b[2], b[3])):
            assert_bits_equal(x, y, f"leaf {i} {name}, step {a[4]}")
    return k


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 4097, 20000])
def test_two_leaves_over_three_steps(host_lib, n):
    gen = torch.Generator().manual_seed(n)
    state = [leaf(n, gen), leaf(3 * n, gen)]
    for step in (1, 2, 3):
        leaves = [lf + [step] for lf in state]
        for lf in leaves:
            lf[1] = torch.randn(lf[0].shape, generator=gen) * 0.1
            lf[1][::5] = 0.0
        out = check(host_lib, leaves)
        state = [lf[:4] for lf in out]
    for p, *_ in state:
        assert bool(((p >= 0) & (p <= 1)).all())


def test_clip_edges_and_nan(host_lib):
    gen = torch.Generator().manual_seed(7)
    p, g, m, v = leaf(4097, gen)
    g[::97] = float("nan")
    out = check(host_lib, [[p, g, m, v, 1]])
    p1 = out[0][0]
    nan = torch.isnan(g)
    assert bool(torch.isnan(p1[nan]).all())
    assert bool(((p1[~nan] >= 0) & (p1[~nan] <= 1)).all())
    # The large gradients drive their parameters onto the bounds.
    assert bool((p1[~nan] == 0).any()) and bool((p1[~nan] == 1).any())
    # A zero gradient and zero moments leave the parameter where it was.
    still = (g == 0) & (m == 0) & (v == 0)
    assert bool(still.any()) and torch.equal(p1[still], p[still])


@pytest.mark.parametrize("bad", ["g_permuted", "g_float64", "m_strided",
                                 "v_short", "step_0"])
def test_the_wrapper_refuses_mismatched_arrays(bad):
    gen = torch.Generator().manual_seed(11)
    p, g, m, v = (t.reshape(5, 7, 3) for t in leaf(105, gen, edges=False))
    step = 1
    if bad == "g_permuted":            # the same 105 elements, other shape
        g = g.permute(2, 0, 1).contiguous()
    elif bad == "g_float64":
        g = g.double()
    elif bad == "m_strided":
        m = m.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "v_short":
        v = v.reshape(-1)[:104]
    else:
        step = 0
    with pytest.raises(ValueError):
        kadam._check(p, g, m, v, step)
    kadam._check(*(t.reshape(5, 7, 3) for t in leaf(105, gen)), 1)


def test_off_boundary_leaf_takes_the_scalar_loop(host_lib):
    gen = torch.Generator().manual_seed(13)
    n = 1029
    arrays = []
    for t in leaf(n, gen):
        buf = torch.empty(n + 1)
        view = buf[1:]                 # 4 bytes past a 16-byte boundary
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        arrays.append(view)
    check(host_lib, [arrays + [2], leaf(17, gen) + [2]])


def test_the_wrapper_refuses_other_devices():
    p = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kadam.adam_update(p, p, p, p, 1, LR, BETAS, EPS)
