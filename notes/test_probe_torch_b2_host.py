"""The unshipped B2 builds that ``notes/probe_torch_b2.py`` times, built with
g++ through ``csrc/host_shim.h`` and held on the CPU to ``trace_rays`` bit
for bit before the probe times them on the card:

    python -m pytest notes/test_probe_torch_b2_host.py -q     # ~40 s

* the resident grids of ``probe_torch_b2_grid.cu`` (a warp's or a block's
  fetch from a cursor) and the warp schedule of postponed descends of
  ``probe_torch_b2_postpone.cu`` (a descend when 16 lanes hold one, its
  default, when every walking lane does or 8 do, and with LoD bytes
  descended at once), on the warp and device-count cases of
  ``tests/test_torch_traverse_host.py``; their launchers take the cursor's
  scratch after the outputs, and each launch must leave it zeroed;
* ``bm::skip_quotient`` of ``probe_torch_b2_skip_dda.cuh`` (csrc's dda.cuh
  with the skip's measured forms) built with each exact ``BM_SKIP`` form,
  against the division ``floorf(x / td)`` it replaces.

These files are not in the port, so the tier-1 suite (``tests/``) does not
run them.  Skipped only where there is no g++.
"""

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tests"))

from _host_build import host_build  # noqa: E402
from test_torch_traverse_host import COUNTS, WARP_CASES, check_device_count, \
    check_warp, scenes  # noqa: E402,F401  (scenes: a fixture)

from brickmap_tpu_torch.kernels import traverse as ktrav  # noqa: E402
from brickmap_tpu_torch.kernels.build import CSRC  # noqa: E402

GRID = os.path.join(HERE, "probe_torch_b2_grid.cu")
POSTPONE = os.path.join(HERE, "probe_torch_b2_postpone.cu")
BUILDS = {"warp fetch": ("b2_grid", ("BM_B2_GRID=1",), GRID),
          "block fetch": ("b2_grid", ("BM_B2_GRID=2",), GRID),
          "postponed": ("b2_postpone", (), POSTPONE),
          "postponed, all": ("b2_postpone", ("BM_B2_HOLD=0",), POSTPONE),
          "postponed, 8": ("b2_postpone", ("BM_B2_HOLD=8",), POSTPONE),
          "postponed, bytes at once": ("b2_postpone", ("BM_B2_HOLD_BYTE=0",),
                                       POSTPONE)}


@pytest.fixture()
def rng(request):
    """A generator seeded from the test's id, as in tests/conftest.py."""
    return np.random.default_rng(
        zlib.crc32(request.node.nodeid.encode()) & 0xFFFFFFFF)


@pytest.fixture(scope="module")
def notes_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = str(tmp_path_factory.mktemp("b2notes"))
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as ex:
        paths = dict(zip(BUILDS, ex.map(lambda b: host_build(
            b[0], out, b[1], b[2]), BUILDS.values())))
    libs = {}
    for name, path in paths.items():
        libs[name] = ctypes.CDLL(path)
        ktrav._bind(libs[name])
        libs[name].traverse_launch.argtypes = tuple(
            libs[name].traverse_launch.argtypes[:-1]) + (
            ctypes.c_void_p, ctypes.c_void_p)
    return libs


def notes_trace(lib, o, d, sc, cam, grid, steps, count=None, out=None):
    """``host_trace`` through a launcher that takes the cursor's scratch;
    the launch must leave it zeroed."""
    inputs, fresh = ktrav.launch_inputs(o, d, grid)
    out = fresh if out is None else out
    n = torch.tensor([o.shape[0] if count is None else count],
                     dtype=torch.int32)
    scratch = torch.zeros(2, dtype=torch.int32)
    args = ktrav.launch_args(inputs, sc.index_volume, sc, cam, grid, steps,
                             out, None, n)
    assert lib.traverse_launch(*args[:-1], scratch.data_ptr(), None) == 0
    assert not bool(scratch.any()), "the launch left its scratch dirty"
    return out


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("case", WARP_CASES)
def test_notes_schedule_warps(notes_libs, build, case):
    check_warp(lambda *a: notes_trace(notes_libs[build], *a), case)


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("count", COUNTS)
def test_notes_stop_at_the_device_count(notes_libs, scenes, rng, build,
                                        count):
    check_device_count(lambda *a, **k: notes_trace(notes_libs[build], *a,
                                                   **k), scenes, rng, count)


# bm::skip_quotient built with each exact BM_SKIP form that replaces the
# division, against the division, over arrays of (x, d): the quotient
# floorf(x / td) with td from make_axis(d).
SKIP_FORMS = (1, 3)
SKIP_SRC = r"""
#include "probe_torch_b2_skip_dda.cuh"
extern "C" void skip_quotients(const float* x, const float* d, int n,
                               float* fast, float* div) {
  for (int i = 0; i < n; ++i) {
    const bm::Axis a = bm::make_axis(d[i]);
    fast[i] = bm::skip_quotient(x[i], a);
    div[i] = floorf(x[i] / (a.td == 0.0f ? 1.0f : a.td));
  }
}
"""


@pytest.fixture(scope="module", params=SKIP_FORMS)
def skip_lib(tmp_path_factory, request):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("skipq")
    src, lib = out / "skip.cpp", out / f"libskip{request.param}.so"
    src.write_text(SKIP_SRC)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-DBM_SKIP={request.param}",
                    "-include", os.path.join(CSRC, "host_shim.h"), "-I",
                    HERE, "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    so.skip_quotients.argtypes = [p, p, ctypes.c_int, p, p]
    return so


def skip_pair(lib, x, d):
    x = np.ascontiguousarray(x, np.float32).ravel()
    d = np.ascontiguousarray(np.broadcast_to(d, x.shape), np.float32)
    fast, div = np.empty_like(x), np.empty_like(x)
    lib.skip_quotients(x.ctypes.data, d.ctypes.data, x.size,
                       fast.ctypes.data, div.ctypes.data)
    return fast, div


def assert_same_bits(fast, div):
    bad = fast.view(np.int32) != div.view(np.int32)
    assert not bad.any(), (fast[bad][:5], div[bad][:5])


def near_multiples(td, ks, ulps=3):
    """Products k * td rounded, and the floats up to ``ulps`` on each side:
    the quotients x / td that land on or next to an integer."""
    x = (np.asarray(ks, np.float32)[:, None] * np.float32(td)).astype(
        np.float32)
    steps = np.arange(-ulps, ulps + 1)
    bits = x.view(np.int32)[..., None] + np.where(x[..., None] >= 0, steps,
                                                  -steps)
    return bits.astype(np.int32).view(np.float32)


@pytest.mark.parametrize("group", ["unit directions", "powers of two",
                                   "td near 0", "td near 1", "the skip's x"])
def test_skip_quotient_equals_the_division(skip_lib, group):
    """floorf(x / td) of the skip, by the division and by
    ``bm::skip_quotient`` (the division only near an integer), equal bit
    for bit at quotients on and next to the integers 0..600 (and -3..-1),
    for directions of each kind: unit vectors' components, powers of two
    (td exact), |d| large enough that td falls below 2^-60 (the division's
    path) and |d| just under 1."""
    rng = np.random.default_rng(5)
    if group == "unit directions":
        d = rng.normal(size=(300, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).ravel()
    elif group == "powers of two":
        d = np.concatenate([2.0 ** -np.arange(0, 70), -2.0 ** -np.arange(
            0, 70)])
    elif group == "td near 0":
        d = np.concatenate([10.0 ** np.arange(15, 39), 2.0 ** np.arange(
            55, 66)])
    elif group == "td near 1":
        d = 1 - 2.0 ** -np.arange(1, 25)
    else:
        d = rng.uniform(-1, 1, 200)
    ks = np.concatenate([np.arange(-3, 601), rng.integers(601, 5000, 50)])
    for di in np.asarray(d, np.float32):
        td = np.float32(np.abs(np.float32(1) / di)) if di else np.float32(1)
        if group == "the skip's x":
            # x = (ta + rf * td) - ta, as the skip forms it
            ta = rng.uniform(0, 400, 64).astype(np.float32)
            rf = rng.integers(1, 511, 64).astype(np.float32)
            x = ((ta + rf * td).astype(np.float32) - ta).astype(np.float32)
            x = np.concatenate([x, near_multiples(td, ks).ravel()])
        else:
            x = near_multiples(td, ks).ravel()
        assert_same_bits(*skip_pair(skip_lib, x, di))


def test_skip_quotient_on_any_floats(skip_lib):
    """The same on hypothesis' float32 pairs: every finite, infinite, NaN,
    zero and subnormal value of x and d."""
    from hypothesis import given, settings, strategies as st
    from hypothesis.extra.numpy import arrays

    f32 = st.floats(width=32, allow_nan=True, allow_infinity=True,
                    allow_subnormal=True)

    @settings(max_examples=300, deadline=None, database=None)
    @given(arrays(np.float32, 64, elements=f32),
           arrays(np.float32, 64, elements=f32))
    def check(x, d):
        assert_same_bits(*skip_pair(skip_lib, x, d))

    check()
