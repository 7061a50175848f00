"""The sparse fields' one layout, ``diff/field4.py``: every maker returns
occupancy and albedo as the column views of one contiguous ``field4``
[A*512, 4]; the sparse step replays from that storage with no copy
(``diff/sparse.py::_pack_field``) and returns the gradients as the same
views of one ``dfield``, scaled in place; ``ClippedAdam`` steps the
``field4`` in one ``adam_update`` call, with its moments in the same
layout; ``parallel/render.py::_pmean_`` reduces it once.  Everything is
held bit for bit against contiguous copies of the same fields, which take
the path of fields from outside the program (a cat, one Adam call a
field).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.app import scaling
from brickmap_tpu_torch.app.benchmark import active_fields
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.diff import optim, sparse
from brickmap_tpu_torch.diff.field4 import field4_of, field4_views
from brickmap_tpu_torch.kernels.record import record_segments
from brickmap_tpu_torch.parallel import render as par

torch.set_num_threads(2)

GRID = GridConfig(grid_size=128, grid_height=128)
LR = 0.05


@pytest.fixture(scope="module")
def problem():
    """A fixed batch of rays from above over a 128^3 world and the fields
    over the bricks they reach (the benchmark's training frame, small)."""
    world = tscene.generate_terrain_scene(GRID, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(22)
    n = 1024
    xy = 32.0 + 64.0 * torch.rand((n, 2), generator=gen)
    o = torch.cat([xy, torch.full((n, 1), 125.0)], dim=1)
    d = torch.randn((n, 3), generator=gen)
    d[:, 2] = -d[:, 2].abs() - 1.0
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    segs = record_segments(o, d, world, GRID, k_segments=8)
    cellmap, occ, alb = active_fields(world, GRID, segs["cells"])
    bg = torch.full((n, 3), 0.2)
    tgt = torch.full((n, 3), 0.4)
    return world, (o, d, bg, tgt), cellmap, occ, alb


def interleaved_copy(occ, alb):
    """Fresh fields with ``occ``/``alb``'s values, as the program lays
    them out: the views of one ``field4``."""
    base = torch.cat([occ.reshape(-1, 1), alb.reshape(-1, 3)], dim=1)
    return (base, *field4_views(base))


@pytest.fixture
def adam_calls(monkeypatch):
    """The number of ``adam_update`` calls ``ClippedAdam`` makes (on the
    CPU each runs the plain version; on the card each is one A1 launch)."""
    calls = []
    real = optim.adam_update

    def counted(p, *args):
        calls.append(p.shape)
        return real(p, *args)

    monkeypatch.setattr(optim, "adam_update", counted)
    return calls


@pytest.fixture
def packs(monkeypatch):
    """For each ``_pack_field`` call, whether it returned the fields' own
    storage (True) or a new field4 (False)."""
    shared = []
    real = sparse._pack_field

    def recorded(occ, alb):
        field = real(occ, alb)
        shared.append(field.data_ptr() == occ.data_ptr())
        return field

    monkeypatch.setattr(sparse, "_pack_field", recorded)
    return shared


def run_steps(problem, occ, alb, adam_calls, packs, steps=3):
    """``steps`` cached loss/gradient + Adam steps; per step (loss, grads,
    params, moments) as copies, and the adam_update calls and
    ``_pack_field`` results it made."""
    world, (o, d, bg, tgt), cellmap = problem[:3]
    params = (occ, alb)
    opt = optim.make_adam(params, LR)
    cache, out = {}, []
    for _ in range(steps):
        del packs[:]
        loss, grads = sparse.l2_loss_and_grads_sparse(
            o, d, world, cellmap, occ, alb, bg, tgt, GRID, k_segments=8,
            seg_cache=cache)
        packed = list(packs)
        before = len(adam_calls)
        optim.adam_step(opt, params, grads)
        out.append({
            "loss": loss.clone(), "grads": [g.clone() for g in grads],
            "grad_views": grads, "params": [p.clone() for p in params],
            "moments": [opt.state[p][k].clone() for p in params
                        for k in ("exp_avg", "exp_avg_sq")],
            "calls": len(adam_calls) - before, "packed": packed})
    return out, opt


def _active_fields(problem):
    return problem[3], problem[4], 0.8, 0.6


def _pool_fields_from_bitmask(problem):
    return (*sparse.pool_fields_from_bitmask(problem[0]), 1.0, 1.0)


@pytest.mark.parametrize("make", [_active_fields, _pool_fields_from_bitmask])
def test_active_fields_are_views_of_one_field4(problem, make):
    """Each maker of sparse fields in the program returns the views of one
    new field4, with its values."""
    occ, alb, occ_value, alb_value = make(problem)
    a = occ.shape[0]
    assert occ.shape == (a, 512) and alb.shape == (a, 512, 3)
    assert occ.stride() == (2048, 4) and alb.stride() == (2048, 4, 1)
    base = field4_of(occ, alb)
    assert base.shape == (a * 512, 4) and base.is_contiguous()
    assert base.data_ptr() == occ.data_ptr()
    assert bool((alb == np.float32(alb_value)).all())
    assert set(torch.unique(occ).tolist()) == {0.0, np.float32(occ_value)}


def test_interleaved_steps_equal_contiguous_steps(problem, adam_calls,
                                                  packs):
    """Three cached steps + Adam on the interleaved fields and on
    contiguous copies: loss, gradients, parameters and both moments equal
    bit for bit at every step; the storage replayed against a cat; one
    adam_update call a step against two; the gradients the views of one
    dfield on both."""
    _, occ_i, alb_i = interleaved_copy(problem[3], problem[4])
    occ_c, alb_c = problem[3].contiguous().clone(), \
        problem[4].contiguous().clone()
    assert occ_c.is_contiguous() and alb_c.is_contiguous()
    got, _ = run_steps(problem, occ_i, alb_i, adam_calls, packs)
    want, _ = run_steps(problem, occ_c, alb_c, adam_calls, packs)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a["loss"], b["loss"]), i
        for key in ("grads", "params", "moments"):
            for x, y in zip(a[key], b[key]):
                assert x.shape == y.shape and torch.equal(x, y), (i, key)
        assert (a["calls"], b["calls"]) == (1, 2)
        assert (a["packed"], b["packed"]) == ([True], [False])
        for grads in (a["grad_views"], b["grad_views"]):
            assert not any(g.is_contiguous() for g in grads)
            assert field4_of(*grads) is not None
    assert float(got[-1]["loss"]) < float(got[0]["loss"])


def test_pack_field_returns_the_storage(problem):
    base, occ, alb = interleaved_copy(problem[3], problem[4])
    field = sparse._pack_field(occ, alb)
    assert field.data_ptr() == base.data_ptr()
    assert field.shape == base.shape and field.stride() == base.stride()


def _two_bases(occ, alb):
    return occ.clone(), alb.clone()


def _sliced(occ, alb):
    """Views of a [N, 5] storage: they do not tile it."""
    big = torch.zeros((occ.numel(), 5))
    big[:, 0], big[:, 1:4] = occ.reshape(-1), alb.reshape(-1, 3)
    return big[:, 0].view(occ.shape), big[:, 1:4].view(alb.shape)


def _transposed(occ, alb):
    """Views of a non-contiguous [N, 4] (the transpose of a [4, N])."""
    base = torch.cat([occ.reshape(1, -1), alb.reshape(-1, 3).t()]).t()
    assert not base.is_contiguous()
    return base[:, 0].view(occ.shape), base[:, 1:].view(alb.shape)


def _float64(occ, alb):
    _, o, a = interleaved_copy(occ.double(), alb.double())
    return o, a


@pytest.mark.parametrize("make", [_two_bases, _sliced, _transposed,
                                  _float64])
def test_other_inputs_fall_back(problem, adam_calls, make):
    """Inputs that are not the columns of one contiguous float32 [N, 4]:
    _pack_field cats, and ClippedAdam steps each field, with the same
    values as contiguous fields."""
    occ, alb = make(problem[3], problem[4])
    assert field4_of(occ, alb) is None
    field = sparse._pack_field(occ, alb)
    assert field.is_contiguous() and field.data_ptr() != occ.data_ptr()
    assert torch.equal(field, torch.cat([occ.reshape(-1, 1),
                                         alb.reshape(-1, 3)], dim=1))
    gen = torch.Generator()
    gen.manual_seed(3)
    grads = tuple(torch.randn(p.shape, generator=gen, dtype=p.dtype) * 0.1
                  for p in (occ, alb))
    ref = tuple(p.contiguous().clone() for p in (occ, alb))
    opt, opt_ref = optim.make_adam((occ, alb), LR), optim.make_adam(ref, LR)
    optim.adam_step(opt, (occ, alb), grads)
    assert len(adam_calls) == 2
    optim.adam_step(opt_ref, ref, grads)
    assert all(torch.equal(a, b) for a, b in zip((occ, alb), ref))


def _columns(base, occ_cols, alb_cols, rows=(slice(None), slice(None))):
    """``base[rows[0], occ_cols]`` and ``base[rows[1], alb_cols]`` as
    [P, 512] and [P, 512, 3]."""
    occ, alb = base[rows[0], occ_cols], base[rows[1], alb_cols]
    return occ.view(-1, 512), alb.reshape(-1, 512, alb.shape[-1])


# (occupancy, albedo) of a contiguous float32 [1024, 4], and whether they
# are its field4 views.
FIELD4_LAYOUTS = {
    "the pair": (lambda s: field4_views(s), True),
    "one brick": (lambda s: field4_views(s[:512]), True),
    "the pair swapped": (lambda s: field4_views(s)[::-1], False),
    "a column short": (lambda s: _columns(s, 0, slice(1, 3)), False),
    "overlapping columns": (lambda s: _columns(s, 0, slice(0, 3)), False),
    "a wider base": (lambda s: _columns(torch.zeros((1024, 5)), 0,
                                        slice(1, 4)), False),
    "a transposed base": (lambda s: _columns(torch.zeros((4, 1024)).t(), 0,
                                             slice(1, 4)), False),
    "other rows": (lambda s: _columns(s, 0, slice(1, 4),
                                      (slice(0, 512), slice(512, 1024))),
                   False),
    "separate storages": (lambda s: tuple(f.clone()
                                          for f in field4_views(s)), False),
    "float64": (lambda s: field4_views(s.double()), False),
}


@pytest.mark.parametrize("layout", list(FIELD4_LAYOUTS))
def test_field4_of_cases(layout):
    """field4_of names the field4 of exactly its two views, else None."""
    s = torch.zeros((1024, 4))
    make, is_pair = FIELD4_LAYOUTS[layout]
    occ, alb = make(s)
    got = field4_of(occ, alb)
    if not is_pair:
        assert got is None
        return
    assert got.data_ptr() == s.data_ptr() and got.is_contiguous()
    assert got.shape == (occ.shape[0] * 512, 4)
    assert all(torch.equal(x, y) for x, y in zip(field4_views(got),
                                                 (occ, alb)))


def test_adam_state_round_trip_keeps_the_layout(problem, adam_calls):
    """adam_state_arrays / load_adam_state on interleaved fields: the
    resumed optimizer's moments are views of one storage in the fields'
    layout, and its next step equals an uninterrupted one bit for bit, in
    one adam_update call."""
    _, occ, alb = interleaved_copy(problem[3], problem[4])
    a = (occ, alb)
    gen = torch.Generator()
    gen.manual_seed(5)
    grads = [tuple(torch.randn(p.shape, generator=gen) * 0.1 for p in a)
             for _ in range(3)]
    # The gradients as the sparse step returns them: views of one dfield.
    grads = [interleaved_copy(*g)[1:] for g in grads]
    opt = optim.make_adam(a, LR)
    for g in grads[:2]:
        optim.adam_step(opt, a, g)
    leaves = optim.adam_state_arrays(opt, a)
    assert int(leaves[0]) == 2
    _, *b = interleaved_copy(occ, alb)
    opt_b = optim.make_adam(b, LR)
    optim.load_adam_state(opt_b, b, leaves)
    for key in ("exp_avg", "exp_avg_sq"):
        assert field4_of(*[opt_b.state[p][key] for p in b]) is not None
    for x, y in zip(optim.adam_state_arrays(opt_b, b), leaves):
        np.testing.assert_array_equal(x, y)
    # Loading into an optimizer that has stepped copies into its moments.
    before = [opt.state[p]["exp_avg"].data_ptr() for p in a]
    optim.load_adam_state(opt, a, leaves)
    assert [opt.state[p]["exp_avg"].data_ptr() for p in a] == before
    del adam_calls[:]
    optim.adam_step(opt, a, grads[2])
    optim.adam_step(opt_b, b, grads[2])
    assert len(adam_calls) == 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for x, y in zip(optim.adam_state_arrays(opt, a),
                    optim.adam_state_arrays(opt_b, b)):
        np.testing.assert_array_equal(x, y)


@pytest.fixture
def world_of_one():
    scaling.init_single_process("cpu")
    try:
        yield par.make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_pmean_reduces_the_shared_storage(world_of_one, monkeypatch):
    """Over gloo in a world of one, with each all_reduce doubling its
    tensor as a second rank of equal values would: the interleaved
    gradients (views of one storage) come back as their mean over a mesh
    of two, unchanged, so the reduction landed in them; a strided tensor
    that tiles no storage raises."""
    reduced = []
    real = dist.all_reduce

    def doubled(t, group=None):
        real(t, group=group)
        t.mul_(2.0)
        reduced.append(t.data_ptr())

    monkeypatch.setattr(par.dist, "all_reduce", doubled)
    mesh = par.Mesh(world_of_one.group, 2, 0, torch.device("cpu"))
    occ = torch.rand((3, 512))
    alb = torch.rand((3, 512, 3))
    base, docc, dalb = interleaved_copy(occ, alb)
    loss = torch.tensor(1.5)
    want = base.clone()
    par._pmean_(mesh, loss, docc, dalb)
    assert float(loss) == 1.5 and torch.equal(base, want)
    assert reduced == [loss.data_ptr(), base.data_ptr()]
    with pytest.raises(ValueError):
        par._pmean_(mesh, docc)                # a column short of its base
    with pytest.raises(ValueError):
        par._pmean_(mesh, torch.rand((4, 6))[:, ::2])
