"""Kernels R1 and R2's plain versions (``brickmap_tpu_torch/ops/replay.py``)
against the JAX package's functions they replace, on the same inputs made
with numpy from a seed.

* R1 (:func:`segment_geom_plain`) against JAX ``_segment_geom`` plus the -1
  poison of ``_row_chunk_grad``: slots and visited voxels equal, at K = 4
  and 8, on segments recorded over a small world, with strided [C, K]
  columns, axis-aligned directions and invalid segments.
* R2 (:func:`composite_sse_plain`) against JAX ``_composite_core3`` under
  ``jax.value_and_grad`` of the SSE, and against the autograd of the
  port's ``_CompositeCore3``: rtol 1e-6 / atol 1e-6, as the replay on
  injected segments (tests/test_torch_diff.py), for the same reason (the
  sums run in another order).  The inputs hold occupancies at exactly 0
  and 1, values outside [0, 1] and masked steps.
* R2's own contract: masked steps give exact zeros and leave T as it was,
  so appending masked segments moves neither the SSE nor any cotangent.
* The wrappers take the plain versions only for CPU tensors and raise on
  any other device (here the meta device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu import scene as jscene
from brickmap_tpu.config import GridConfig as JGrid
from brickmap_tpu.diff import sparse as jsparse
from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.diff import sparse as tsparse
from brickmap_tpu_torch.kernels import replay as krep
from brickmap_tpu_torch.kernels.record import record_segments
from brickmap_tpu_torch.ops.replay import composite_sse_plain, \
    segment_geom_plain

torch.set_num_threads(2)

JG, TG = JGrid(grid_size=128, grid_height=128), \
    GridConfig(grid_size=128, grid_height=128)
NVOX = 22
RTOL = ATOL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(102)
    dense = np.zeros((128, 128, 128), bool)
    dense[16:32, 32:64, 32:64] = rng.random((16, 32, 32)) < 0.35
    dense[48:56, 80:96, 40:56] = True
    sc = jscene.scene_from_dense(dense, JG)
    tsc = tscene.scene_from_numpy(sc.index_volume, sc.pool_words,
                                  sc.pool_base, device="cpu")
    return tsc, tsparse.cell_pool_map(tsc, TG)


def rays(seed, n):
    """Rays from above at the blobs; a quarter grazing, some axis-aligned
    or with a zero component."""
    rng = np.random.default_rng(seed)
    o = (np.array([64.0, 64.0, 120.0]) + rng.normal(scale=10.0, size=(n, 3))
         ).astype(np.float32)
    centers = np.array([[48.0, 48.0, 24.0], [48.0, 88.0, 52.0]])
    d = centers[rng.integers(0, 2, n)] + rng.normal(scale=14.0,
                                                    size=(n, 3)) - o
    g = n // 4
    o[:g] = rng.uniform([20, 20, 17], [30, 30, 31], (g, 3))
    d[:g] = [1.0, 1.0, 0.0] + rng.normal(scale=0.08, size=(g, 3))
    d[g:g + 8] = [0.0, 0.0, -1.0]
    d[g + 8:g + 16, 0] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.fixture(scope="module")
def segs(world):
    """The port's record of 300 rays at K = 8, as numpy."""
    tsc, _ = world
    o, d = rays(5, 300)
    s = record_segments(t(o), t(d), tsc, TG, k_segments=8)
    out = {k: v.numpy() for k, v in s.items()}
    out["d"] = d
    # Invalidate a few segments the way the record leaves them unused.
    out["cells"][:5, 3:] = -1
    return out


def jax_geom(s, cellmap, keff):
    cols = slice(0, keff)
    slots, lin, mask = jsparse._segment_geom(
        jnp.asarray(s["o_cells"]), jnp.asarray(s["d"]),
        jnp.asarray(s["cells"][:, cols]), jnp.asarray(s["nd"][:, cols]),
        jnp.asarray(s["ncode"][:, cols]), jnp.asarray(s["entry_normal"]),
        jnp.asarray(cellmap.numpy()), JG, keff)
    c = slots.shape[0]
    lin2 = jnp.where(mask, lin, -1).reshape(c * keff, NVOX)
    return np.asarray(slots).reshape(-1), np.asarray(lin2)


@pytest.mark.parametrize("keff", [4, 8])
def test_segment_geom_plain_matches_jax(world, segs, keff):
    """R1's plain version on column cuts [:, :keff] of the [C, 8] record
    (strided, as the replay's slices pass them) equals JAX's geometry plus
    the poison on every slot and visited voxel."""
    _, cellmap = world
    s = segs
    cells, nd, ncode = (t(s[k])[:, :keff] for k in ("cells", "nd", "ncode"))
    assert not cells.is_contiguous() or keff == 8
    slots, lin2 = segment_geom_plain(t(s["o_cells"]), t(s["d"]), cells, nd,
                                     ncode, t(s["entry_normal"]), cellmap,
                                     TG)
    want_slots, want_lin2 = jax_geom(s, cellmap, keff)
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    np.testing.assert_array_equal(lin2.numpy(), want_lin2)
    assert slots.dtype == lin2.dtype == torch.int32
    assert int((lin2 >= 0).sum()) > 1000 and int((lin2 < 0).sum()) > 100


def composite_inputs(seed, c, keff, masked_share=0.3):
    """B4f-shaped values: occupancies a mix of exact 0, exact 1, (0, 1),
    below 0 and above 1; albedo in [-0.2, 1.2]; a share of masked steps
    (values 0 there, as B4f writes them) and a few fully masked rays."""
    rng = np.random.default_rng(seed)
    cs = c * keff
    # Mostly thin occupancies, so that light reaches the later steps.
    x = rng.uniform(0.0, 0.35, (cs, NVOX)).astype(np.float32)
    pick = rng.integers(0, 16, (cs, NVOX))
    x[pick == 0] = 0.0
    x[pick == 1] = 1.0
    x[pick == 2] = rng.uniform(-0.5, -1e-3, int((pick == 2).sum()))
    x[pick == 3] = rng.uniform(1.001, 1.5, int((pick == 3).sum()))
    alb = rng.uniform(-0.2, 1.2, (cs, 3 * NVOX)).astype(np.float32)
    lin2 = rng.integers(0, 512, (cs, NVOX)).astype(np.int32)
    lin2[rng.random((cs, NVOX)) < masked_share] = -1
    lin2[:keff * 2] = -1                         # rays 0 and 1: no step
    vals = np.concatenate([x, alb], axis=1)
    vals[:, :NVOX][lin2 < 0] = 0.0
    for f in range(1, 4):
        vals[:, f * NVOX:(f + 1) * NVOX][lin2 < 0] = 0.0
    bg = rng.uniform(0, 1, (c, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (c, 3)).astype(np.float32)
    return vals, lin2, bg, tgt


def split(v, c, keff):
    """[C*K, 4*nvox] -> occupancy and three albedo planes [C, K*nvox]."""
    return [v[:, f * NVOX:(f + 1) * NVOX].reshape(c, keff * NVOX)
            for f in range(4)]


def jax_composite(vals, lin2, bg, tgt, c, keff):
    mask = jnp.asarray((lin2 >= 0).reshape(c, keff * NVOX))

    def per_ray(v):
        x, r, g, b = split(v, c, keff)
        occ_v = jnp.where(mask, jnp.clip(x, 0.0, 1.0), 0.0)
        rgb, _ = jsparse._composite_core3(occ_v, r, g, b, jnp.asarray(bg))
        return jnp.sum((rgb - jnp.asarray(tgt)) ** 2, axis=1)

    sse = per_ray(jnp.asarray(vals))
    dvals = jax.grad(lambda v: jnp.sum(per_ray(v)))(jnp.asarray(vals))
    return np.asarray(sse), np.asarray(dvals)


def torch_core3(vals, lin2, bg, tgt, c, keff):
    """The port's autograd path before R2: _clip01, the mask, and the
    _CompositeCore3 Function."""
    v = t(vals).requires_grad_()
    x, r, g, b = split(v, c, keff)
    mask = t(lin2 >= 0).reshape(c, keff * NVOX)
    occ_v = torch.where(mask, tsparse._clip01(x), 0.0)
    rgb, _ = tsparse._composite_core3(occ_v, r, g, b, t(bg))
    sse = torch.sum((rgb - t(tgt)) ** 2, dim=1)
    sse.sum().backward()
    return sse.detach().numpy(), v.grad.numpy()


@pytest.mark.parametrize("keff", [4, 8])
@pytest.mark.parametrize("reference", ["jax", "torch_core3"])
def test_composite_sse_plain_matches(keff, reference):
    """R2's plain version against JAX's composite + VJP, and against the
    port's _CompositeCore3 autograd, at occupancies exactly 0 and 1, out of
    range, and masked."""
    c = 64
    vals, lin2, bg, tgt = composite_inputs(11 + keff, c, keff)
    sse, dvals = composite_sse_plain(t(vals), t(lin2), t(bg), t(tgt))
    ref = jax_composite if reference == "jax" else torch_core3
    want_sse, want_dvals = ref(vals, lin2, bg, tgt, c, keff)
    np.testing.assert_allclose(sse.numpy(), want_sse, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dvals.numpy(), want_dvals, rtol=RTOL,
                               atol=ATOL)
    d_occ = dvals.numpy()[:, :NVOX]
    x = vals[:, :NVOX]
    valid = lin2 >= 0
    # The clip: half the cotangent at a bound, none outside [0, 1].
    assert np.all(d_occ[valid & ((x < 0) | (x > 1))] == 0.0)
    assert np.any(d_occ[valid & (x == 0.0)] != 0.0)
    assert np.any(d_occ[valid & (x == 1.0)] != 0.0)
    assert np.all(d_occ[~valid] == 0.0)
    assert np.all(np.isfinite(dvals.numpy()))


def test_composite_sse_masked_steps_change_nothing():
    """Masked steps composite as occ = 0 without touching T: filling them
    with other values, or appending fully masked segments (a larger K),
    leaves every SSE and every cotangent of the real steps bit for bit."""
    c, keff = 48, 4
    vals, lin2, bg, tgt = composite_inputs(3, c, keff)
    sse, dvals = composite_sse_plain(t(vals), t(lin2), t(bg), t(tgt))
    noisy = vals.copy()
    rng = np.random.default_rng(4)
    masked = np.concatenate([lin2 < 0] * 4, axis=1)
    noisy[masked] = rng.uniform(-2, 2, int(masked.sum()))
    sse2, dvals2 = composite_sse_plain(t(noisy), t(lin2), t(bg), t(tgt))
    assert torch.equal(sse, sse2)
    assert torch.equal(dvals[:, :NVOX], dvals2[:, :NVOX])
    valid4 = torch.from_numpy(~masked)
    assert torch.equal(dvals[valid4], dvals2[valid4])
    # K = 4 -> 6: two masked segments appended to each ray.
    k2 = keff + 2
    vals6 = np.zeros((c, k2, 4 * NVOX), np.float32)
    lin6 = np.full((c, k2, NVOX), -1, np.int32)
    vals6[:, :keff] = vals.reshape(c, keff, -1)
    lin6[:, :keff] = lin2.reshape(c, keff, -1)
    sse6, dvals6 = composite_sse_plain(t(vals6.reshape(c * k2, -1)),
                                       t(lin6.reshape(c * k2, -1)), t(bg),
                                       t(tgt))
    assert torch.equal(sse, sse6)
    assert torch.equal(dvals.reshape(c, keff, -1),
                       dvals6.reshape(c, k2, -1)[:, :keff])
    assert torch.all(dvals6.reshape(c, k2, -1)[:, keff:, :NVOX] == 0)


def test_wrappers_take_plain_on_cpu_and_raise_elsewhere(world, segs):
    """On CPU tensors the wrappers return the plain versions' results and
    count no launch; on the meta device they raise."""
    _, cellmap = world
    s = segs
    args = (t(s["o_cells"]), t(s["d"]), t(s["cells"]), t(s["nd"]),
            t(s["ncode"]), t(s["entry_normal"]), cellmap)
    before = (krep.segment_geom.launches, krep.composite_sse.launches)
    got = krep.segment_geom(*args, TG)
    want = segment_geom_plain(*args, TG)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    vals, lin2, bg, tgt = composite_inputs(8, 16, 2)
    got = krep.composite_sse(t(vals), t(lin2), t(bg), t(tgt))
    want = composite_sse_plain(t(vals), t(lin2), t(bg), t(tgt))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (krep.segment_geom.launches,
            krep.composite_sse.launches) == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        krep.segment_geom(*meta, TG)
    with pytest.raises(ValueError, match="unsupported device"):
        krep.composite_sse(*(t(a).to("meta") for a in (vals, lin2, bg, tgt)))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("keff", [4, 8])
def test_cuda_kernels_match_plain(world, segs, cuda_device, keff):
    """R1 and R2 on the card against their plain versions on the card, bit
    for bit, on the recorded segments (strided columns) and on random
    composite inputs; each launches once."""
    _, cellmap = world
    s = segs
    args = [t(s["o_cells"]), t(s["d"]), t(s["cells"])[:, :keff],
            t(s["nd"])[:, :keff], t(s["ncode"])[:, :keff],
            t(s["entry_normal"]), cellmap]
    dev_args = [a.to(cuda_device) for a in args]
    dev_args[2:5] = [t(s[k]).to(cuda_device)[:, :keff]
                     for k in ("cells", "nd", "ncode")]
    before = krep.segment_geom.launches
    got = krep.segment_geom(*dev_args, TG)
    want = segment_geom_plain(*dev_args, TG)
    assert krep.segment_geom.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    vals, lin2, bg, tgt = (t(a).to(cuda_device)
                           for a in composite_inputs(21, 256, keff))
    before = krep.composite_sse.launches
    got = krep.composite_sse(vals, lin2, bg, tgt)
    want = composite_sse_plain(vals, lin2, bg, tgt)
    assert krep.composite_sse.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
