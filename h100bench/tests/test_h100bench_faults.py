"""A run with the timed path broken underneath comes out not correct, and
so does the control (the reference computed in bfloat16 in the program's
place), against the cells' own limits; a sound run comes out correct.
The look for a card is skipped: these run on the CPU at a tiny size."""

import time

import pytest

from h100bench import harness
from h100bench.calibrate import bf16

from conftest import SEED, tiny_cell


def run(cell_name, cpu, seconds=0.3):
    cell = tiny_cell(cell_name)
    return harness.Run(cell, SEED, cpu, time.perf_counter()).execute(
        seconds, False)


@pytest.mark.parametrize("cell", ["view.over_world", "view.from_outside",
                                  "train.fixed_rays"])
def test_sound_run_is_correct(cell, cpu):
    assert run(cell, cpu)["correct"]


def _half_frame(render_wave):
    def broken(*a, **k):
        rgb, count, req = render_wave(*a, **k)
        n = rgb.shape[0] // 2
        rgb[n:] = 0.0
        count[n:] = 0.0
        return rgb, count, req
    return broken


def _altered_frame(shade):
    def broken(*a, **k):
        out = shade(*a, **k)
        if out is None:
            return out
        rgb, count, req = out
        return rgb * (1.0 + 1e-3) + 1e-4, count, req
    return broken


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_view_faults_fail(fault, cpu, monkeypatch):
    from brickmap_tpu_torch.kernels import wave as kwave
    from brickmap_tpu_torch.render import pathtrace

    if fault == "half":
        monkeypatch.setattr(pathtrace, "render_wave",
                            _half_frame(pathtrace.render_wave))
    else:
        monkeypatch.setattr(kwave, "shade", _altered_frame(kwave.shade))
    assert not run("view.from_outside", cpu)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_train_faults_fail(fault, cpu, monkeypatch):
    from brickmap_tpu_torch.diff import optim, sparse

    if fault == "unchanged":
        monkeypatch.setattr(optim, "adam_step", lambda *a, **k: None)
    else:
        real = sparse.l2_loss_and_grads_sparse

        def half(origin, direction, scene, cellmap, occ, alb, bg, tgt, grid,
                 **k):
            m = origin.shape[0] // 2
            k.pop("seg_cache", None)
            return real(origin[:m], direction[:m], scene, cellmap, occ, alb,
                        bg[:m], tgt[:m], grid, **k)

        monkeypatch.setattr(sparse, "l2_loss_and_grads_sparse", half)
    assert not run("train.fixed_rays", cpu)["correct"]


def test_view_control_fails(cpu):
    """The control's wave against the reference's, by the cell's limits
    (views from outside the box: at this size views 0-3 start inside the
    terrain and see nothing but the solid voxel they start in)."""
    from h100bench.calibrate import view_control
    from h100bench.loops import view as lview

    cell = tiny_cell("view.from_outside")
    loop = lview.Loop(cell["config_data"], cell["traffic_data"], SEED, cpu)
    got = view_control(loop, SEED)
    assert any(got[k] > v for k, v in cell["limits"].items())


def test_train_control_fails(cpu):
    from h100bench.calibrate import train_reference

    cell = tiny_cell("train.fixed_rays")
    got = train_reference(cell, SEED, quant=bf16)
    assert any(got[k] > v for k, v in cell["limits"].items())
