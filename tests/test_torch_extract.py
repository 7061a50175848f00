"""Kernels B4f/B4b's plain versions (brickmap_tpu_torch.ops.extract) and the
autograd Function around them, against the JAX package's row replay: the
row gather ``jnp.take(field2, slots)``, ``extract_rows_pallas`` in interpret
mode, its VJP and the row scatter-add ``.at[slots].add``.

Random fields in the port's voxel-interleaved layout ``field4 [P*512, 4]``
(the JAX side gets the same numbers as rows ``[P, 4*512]``); ``lin`` with -1,
values >= 512 and duplicates; many rows sharing one slot; row counts that
are not a multiple of the Pallas block (512).  Values are equal exactly
(both sides pick them); gradients within rtol/atol 1e-6, since the JAX side
sums a row's duplicate voxels before adding the row and the port adds entry
by entry.  The row-contract plain versions stay the oracle of
``extract_rows_pallas`` and are held against it exactly.  The ``cuda`` test
holds the CUDA kernels against the plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu.diff.sparse import _extract_rows as jax_extract_rows
from brickmap_tpu.pallas.extract import extract_rows_pallas
from brickmap_tpu_torch.kernels import extract as kext
from brickmap_tpu_torch.ops.extract import extract_bwd_plain, \
    extract_fwd_plain, extract_rows_bwd_plain, extract_rows_plain

torch.set_num_threads(2)

NV = 512
# (rows, visited voxels per row, pool slots, rows sharing slot 1)
CASES = [(700, 22, 9, 0), (37, 22, 3, 0), (130, 7, 5, 0), (600, 22, 4, 300)]


def make_lin(rng, cs, nvox, nv=NV):
    lin = rng.integers(-2, nv + 8, size=(cs, nvox)).astype(np.int32)
    lin[:, 0] = -1                       # invalid step
    lin[:, 1] = nv                       # just past the row
    if nvox > 4:
        lin[:, 4] = lin[:, 2]            # a duplicate voxel
    return lin


def make_case(rng, cs, nvox, nv=NV):
    rows = rng.normal(size=(cs, 4 * nv)).astype(np.float32)
    dvals = rng.normal(size=(cs, 4 * nvox)).astype(np.float32)
    return rows, make_lin(rng, cs, nvox, nv), dvals


def make_field_case(rng, cs, nvox, pool, shared):
    """field4 [pool*512, 4], slots [cs] (the first ``shared`` rows on slot
    1), lin [cs, nvox], dvals [cs, 4*nvox]."""
    field4 = rng.normal(size=(pool * NV, 4)).astype(np.float32)
    slots = rng.integers(0, pool, size=cs).astype(np.int32)
    slots[:shared] = 1
    dvals = rng.normal(size=(cs, 4 * nvox)).astype(np.float32)
    return field4, slots, make_lin(rng, cs, nvox), dvals


def as_rows(field4):
    """[P*512, 4] -> the JAX row layout [P, 4*512] (columns f*512 + v)."""
    return np.ascontiguousarray(
        field4.reshape(-1, NV, 4).transpose(0, 2, 1).reshape(-1, 4 * NV))


def as_field4(rows):
    return np.ascontiguousarray(
        rows.reshape(-1, 4, NV).transpose(0, 2, 1).reshape(-1, 4))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cs,nvox,pool,shared", CASES)
def test_plain_matches_pallas_and_vjp(rng, cs, nvox, pool, shared):
    """(a) B4f/B4b's plain versions against the JAX composition, and the row
    plain versions against ``extract_rows_pallas`` and its VJP."""
    field4, slots, lin, dvals = make_field_case(rng, cs, nvox, pool, shared)
    field2 = as_rows(field4)
    rows = jnp.take(jnp.asarray(field2), jnp.asarray(slots), axis=0)
    want, vjp = jax.vjp(lambda r: extract_rows_pallas(r, jnp.asarray(lin),
                                                      True), rows)
    (drows_want,) = vjp(jnp.asarray(dvals))
    dfield_want = as_field4(np.asarray(
        jnp.zeros_like(field2).at[jnp.asarray(slots)].add(drows_want)))

    got = extract_fwd_plain(t(field4), t(slots), t(lin))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dfield = extract_bwd_plain(torch.zeros(field4.shape), t(slots), t(lin),
                               t(dvals))
    np.testing.assert_allclose(dfield.numpy(), dfield_want, rtol=1e-6,
                               atol=1e-6)
    # The row contract's plain versions stay the oracle of the Pallas pair.
    rows_np = np.asarray(rows)
    np.testing.assert_array_equal(
        extract_rows_plain(t(rows_np), t(lin)).numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        extract_rows_bwd_plain(t(lin), t(dvals), 4 * NV).numpy(),
        np.asarray(drows_want))
    # Through the autograd Function (CPU path: the plain versions).
    f4 = t(field4).requires_grad_()
    vals = kext.extract_field(f4, t(slots), t(lin))
    vals.backward(t(dvals))
    assert torch.equal(vals.detach(), got)
    assert torch.equal(f4.grad, dfield)


@pytest.mark.parametrize("cs,nvox,pool,shared", CASES[:3])
def test_field_plain_matches_row_plain(rng, cs, nvox, pool, shared):
    """(b) The same plain versions against the row plain versions composed
    with ``index_select`` / ``index_add_``; a slot outside [0, P) reads 0
    and adds nothing."""
    field4, slots, lin, dvals = make_field_case(rng, cs, nvox, pool, shared)
    f4, s, ln, dv = t(field4), t(slots), t(lin), t(dvals)
    rows2 = t(as_rows(field4)).index_select(0, s.long())
    assert torch.equal(extract_fwd_plain(f4, s, ln),
                       extract_rows_plain(rows2, ln))
    drows = extract_rows_bwd_plain(ln, dv, 4 * NV)
    dfield2 = torch.zeros((pool, 4 * NV)).index_add_(0, s.long(), drows)
    got = extract_bwd_plain(torch.zeros_like(f4), s, ln, dv)
    np.testing.assert_allclose(got.numpy(), as_field4(dfield2.numpy()),
                               rtol=1e-6, atol=1e-6)

    bad = s.clone()
    bad[0], bad[1] = pool, -1
    assert not extract_fwd_plain(f4, bad, ln)[:2].any()
    ln_off = ln.clone()
    ln_off[:2] = -1
    assert torch.equal(extract_bwd_plain(torch.zeros_like(f4), bad, ln, dv),
                       extract_bwd_plain(torch.zeros_like(f4), s, ln_off, dv))


def test_jax_layout_twin(rng):
    """The JAX package's plain twin of B4 in its layout (``diff.sparse.
    _extract_rows``: [C, K, 4*512] rows, [C, K, nvox] lin -> [C, K, nvox, 4])
    against ``extract_rows_plain`` on the flattened rows."""
    c, k, nvox = 24, 3, 22
    rows, lin, _ = make_case(rng, c * k, nvox)
    lin = np.clip(lin, 0, 511)           # the JAX twin takes in-range lin
    want = jax_extract_rows(jnp.asarray(rows.reshape(c, k, -1)),
                            jnp.asarray(lin.reshape(c, k, nvox)))
    got = extract_rows_plain(t(rows), t(lin))
    got = got.reshape(c, k, 4, nvox).permute(0, 1, 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gradcheck_float64(rng):
    """(c) The autograd Function on ``field4`` in float64."""
    field4, slots, lin, _ = make_field_case(rng, 9, 6, 2, 5)
    f4 = torch.from_numpy(field4.astype(np.float64)).requires_grad_()
    s, ln = t(slots), t(lin)
    assert torch.autograd.gradcheck(lambda x: kext.extract_field(x, s, ln),
                                    (f4,))


def test_wrapper_on_cpu_and_other_devices(rng):
    """(d) On the CPU the wrappers run the plain versions and count no
    launch; B4b adds in place; the ``meta`` device raises."""
    field4, slots, lin, dvals = make_field_case(rng, 16, 22, 2, 0)
    before = (kext.extract_fwd.launches, kext.extract_bwd.launches)
    vals = kext.extract_fwd(t(field4), t(slots), t(lin))
    dfield = torch.zeros(field4.shape)
    out = kext.extract_bwd(dfield, t(slots), t(lin), t(dvals))
    assert (kext.extract_fwd.launches, kext.extract_bwd.launches) == before
    assert out is dfield and bool(dfield.any())
    assert torch.equal(vals, extract_fwd_plain(t(field4), t(slots), t(lin)))
    meta = torch.zeros((2 * NV, 4), device="meta")
    s, ln = (torch.zeros(a, dtype=torch.int32, device="meta")
             for a in ((4,), (4, 22)))
    with pytest.raises(ValueError):
        kext.extract_fwd(meta, s, ln)
    with pytest.raises(ValueError):
        kext.extract_bwd(meta, s, ln, torch.zeros((4, 88), device="meta"))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device, rng):
    """(e) The CUDA kernels against the plain versions: values equal, the
    field gradient within 1e-6 * max|want| (atomics add in no fixed order).
    The last case puts every row on one slot and one voxel, with dyadic
    cotangents whose sums are exact in any order."""
    cases = [make_field_case(rng, *c) for c in
             ((8192, 22, 64, 0), (1000, 22, 7, 600), (300, 7, 3, 0))]
    f4, s, ln, dv = make_field_case(rng, 20000, 22, 5, 20000)
    ln[:, 2:] = 17
    cases.append((f4, s, ln, (rng.integers(-8, 9, dv.shape) / 4).astype(
        np.float32)))
    for case in cases:
        field4, slots, lin, dvals = (t(a).to(cuda_device) for a in case)
        before = (kext.extract_fwd.launches, kext.extract_bwd.launches)
        vals = kext.extract_fwd(field4, slots, lin)
        dfield = kext.extract_bwd(torch.zeros_like(field4), slots, lin, dvals)
        assert (kext.extract_fwd.launches, kext.extract_bwd.launches) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(vals, extract_fwd_plain(field4, slots, lin))
        want = extract_bwd_plain(torch.zeros_like(field4), slots, lin, dvals)
        err = float((dfield - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), err
    shifted = torch.empty(field4.numel() + 1, device=cuda_device)[1:]
    with pytest.raises(ValueError):       # not 16-byte aligned
        kext.extract_fwd(shifted.view(-1, 4), slots, lin)
