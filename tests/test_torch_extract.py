"""Kernels B4f/B4b's plain versions (brickmap_tpu_torch.ops.extract) and the
autograd Function around them, against the JAX package's
``extract_rows_pallas`` in interpret mode and its VJP.

Random rows; ``lin`` with -1, values >= 512 and duplicates; row counts that
are not a multiple of the Pallas block (512).  Equality is exact: both sides
pick values, and the transpose sums duplicates in ascending j from zero.
The ``cuda`` test holds the CUDA kernels against the plain versions on the
card, also exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brickmap_tpu.diff.sparse import _extract_rows as jax_extract_rows
from brickmap_tpu.pallas.extract import extract_rows_pallas
from brickmap_tpu_torch.diff.sparse import _extract_rows
from brickmap_tpu_torch.kernels import extract as kext
from brickmap_tpu_torch.ops.extract import extract_rows_bwd_plain, \
    extract_rows_plain

torch.set_num_threads(2)


def make_case(rng, cs, nvox, nv=512):
    rows = rng.normal(size=(cs, 4 * nv)).astype(np.float32)
    lin = rng.integers(-2, nv + 8, size=(cs, nvox)).astype(np.int32)
    lin[:, 0] = -1                       # invalid step
    lin[:, 1] = nv                       # just past the row
    if nvox > 4:
        lin[:, 4] = lin[:, 2]            # a duplicate voxel
    dvals = rng.normal(size=(cs, 4 * nvox)).astype(np.float32)
    return rows, lin, dvals


@pytest.mark.parametrize("cs,nvox", [(700, 22), (37, 22), (130, 7)])
def test_plain_matches_pallas_and_vjp(rng, cs, nvox):
    rows, lin, dvals = make_case(rng, cs, nvox)
    want, vjp = jax.vjp(lambda r: extract_rows_pallas(r, jnp.asarray(lin),
                                                      True),
                        jnp.asarray(rows))
    got = extract_rows_plain(torch.from_numpy(rows), torch.from_numpy(lin))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (drows_want,) = vjp(jnp.asarray(dvals))
    drows = extract_rows_bwd_plain(torch.from_numpy(lin),
                                   torch.from_numpy(dvals), rows.shape[1])
    np.testing.assert_array_equal(drows.numpy(), np.asarray(drows_want))
    # Through the autograd Function (CPU path: the plain versions).
    r = torch.from_numpy(rows).requires_grad_()
    vals = kext.extract_rows(r, torch.from_numpy(lin))
    vals.backward(torch.from_numpy(dvals))
    assert torch.equal(vals.detach(), got)
    assert torch.equal(r.grad, drows)


def test_jax_layout_twin(rng):
    """``diff.sparse._extract_rows`` ([C, K, 4*512] rows, [C, K, nvox] lin ->
    [C, K, nvox, 4]) against its JAX namesake."""
    c, k, nvox = 24, 3, 22
    rows, lin, _ = make_case(rng, c * k, nvox)
    lin = np.clip(lin, 0, 511)           # the JAX twin takes in-range lin
    rows3, lin3 = rows.reshape(c, k, -1), lin.reshape(c, k, nvox)
    want = jax_extract_rows(jnp.asarray(rows3), jnp.asarray(lin3))
    got = _extract_rows(torch.from_numpy(rows3), torch.from_numpy(lin3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gradcheck_float64(rng):
    rows, lin, _ = make_case(rng, 9, 6, nv=16)
    r = torch.from_numpy(rows.astype(np.float64)).requires_grad_()
    lin_t = torch.from_numpy(lin)
    assert torch.autograd.gradcheck(lambda x: kext.extract_rows(x, lin_t),
                                    (r,))


def test_wrapper_on_cpu_and_other_devices(rng):
    rows, lin, dvals = make_case(rng, 16, 22)
    before = (kext.extract_fwd.launches, kext.extract_bwd.launches)
    kext.extract_fwd(torch.from_numpy(rows), torch.from_numpy(lin))
    kext.extract_bwd(torch.from_numpy(lin), torch.from_numpy(dvals), 2048)
    assert (kext.extract_fwd.launches, kext.extract_bwd.launches) == before
    meta = torch.zeros((4, 2048), device="meta")
    with pytest.raises(ValueError):
        kext.extract_fwd(meta, torch.zeros((4, 22), dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError):
        kext.extract_bwd(torch.zeros((4, 22), dtype=torch.int32,
                                     device="meta"),
                         torch.zeros((4, 88), device="meta"), 2048)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device, rng):
    for cs, nvox in ((8192, 22), (1000, 22), (300, 7)):
        rows, lin, dvals = (torch.from_numpy(a).to(cuda_device)
                            for a in make_case(rng, cs, nvox))
        before = (kext.extract_fwd.launches, kext.extract_bwd.launches)
        vals = kext.extract_fwd(rows, lin)
        drows = kext.extract_bwd(lin, dvals, rows.shape[1])
        assert (kext.extract_fwd.launches, kext.extract_bwd.launches) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(vals, extract_rows_plain(rows, lin))
        assert torch.equal(drows, extract_rows_bwd_plain(lin, dvals,
                                                         rows.shape[1]))
