"""The dense differentiable renderer (``diff/render.py``) and the
inverse-rendering optimizer (``diff/optim.py``) of brickmap_tpu_torch against
the JAX package's, same inputs.

* Dense compositor and its loss/gradients: atol 1e-5, rtol 1e-6.
* Adam against ``optax.adam`` over the same gradients: rtol 1e-5, atol 3e-6.
  optax takes the bias correction 1 - 0.999^t in float32 (1.3e-5 relative
  off at t = 1), the port in double, so parameters moved by a few steps of
  size lr = 0.05 differ by up to ~2e-6 absolute.
* The port's optimizer on the CPU (kernel A1's plain version) against
  ``torch.optim.Adam`` and ``clamp_``, the arithmetic it replaced, over 3
  steps: parameters and second moments within 4 ulp, first moments within 4
  ulp of their largest value (torch's is a lerp, which rounds apart where
  the two terms nearly cancel); and its state through
  ``adam_state_arrays`` / ``load_adam_state`` and back, the next step equal.
* A JAX ``InverseRenderer`` checkpoint resumed in the port, and back: the
  next loss matches to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from brickmap_tpu.diff import render as jrender
from brickmap_tpu.diff.optim import InverseRenderer as JInverseRenderer
from brickmap_tpu_torch.diff import optim as toptim, render as trender

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Dense compositor
# ---------------------------------------------------------------------------

def dense_problem(rng, g=16, n=96):
    occ = rng.uniform(0, 1, (g, g, g)).astype(np.float32)
    occ[occ < 0.6] = 0.0                  # exact zeros: clip's tie gradient
    occ[occ > 0.95] = 1.0
    alb = rng.uniform(0, 1, (g, g, g, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.full(3, g / 2) - dirs * 1.6 * g).astype(np.float32)
    origins[:8] = rng.uniform(1, g - 1, (8, 3))   # start inside the grid
    bg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return occ, alb, origins, dirs, bg, tgt


def test_composite_rays_matches(rng):
    occ, alb, o, d, bg, _ = dense_problem(rng)
    want = jrender.composite_rays(*(jnp.asarray(a) for a in
                                    (o, d, occ, alb, bg)), max_steps=48)
    got = trender.composite_rays(t(o), t(d), t(occ), t(alb), t(bg),
                                 max_steps=48)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)


@pytest.mark.parametrize("chunk", [32768, 40])
def test_dense_loss_and_grads_match(rng, chunk):
    occ, alb, o, d, bg, tgt = dense_problem(rng)
    lw, (gow, gaw) = jrender.l2_loss_and_grads(
        *(jnp.asarray(a) for a in (o, d, occ, alb, bg, tgt)), max_steps=48,
        rays_per_chunk=chunk)
    lg, (gog, gag) = trender.l2_loss_and_grads(
        t(o), t(d), t(occ), t(alb), t(bg), t(tgt), max_steps=48,
        rays_per_chunk=chunk)
    np.testing.assert_allclose(float(lg), float(lw), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(gog.numpy(), np.asarray(gow), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(gag.numpy(), np.asarray(gaw), atol=1e-5,
                               rtol=1e-6)
    assert float(gog.abs().sum()) > 0


# ---------------------------------------------------------------------------
# Optimizer and checkpoints
# ---------------------------------------------------------------------------

def test_adam_matches_optax(rng):
    """5 steps from one start, the same gradient sequence on both sides."""
    occ = rng.uniform(0, 1, (6, 6, 6)).astype(np.float32)
    alb = rng.uniform(0, 1, (6, 6, 6, 3)).astype(np.float32)
    grads = [(rng.normal(size=occ.shape).astype(np.float32),
              rng.normal(size=alb.shape).astype(np.float32))
             for _ in range(5)]
    opt = optax.adam(0.05)
    params = (jnp.asarray(occ), jnp.asarray(alb))
    state = opt.init(params)
    tp = (t(occ).clone(), t(alb).clone())
    topt = toptim.make_adam(tp, 0.05)
    for go, ga in grads:
        upd, state = opt.update((jnp.asarray(go), jnp.asarray(ga)), state)
        params = tuple(jnp.clip(p, 0.0, 1.0)
                       for p in optax.apply_updates(params, upd))
        toptim.adam_step(topt, tp, (t(go), t(ga)))
    for a, b in zip(tp, params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=3e-6)
    leaves = jax.tree_util.tree_flatten(state)[0]
    for a, b in zip(toptim.adam_state_arrays(topt, tp), leaves):
        # torch's first moment is a lerp, optax's a weighted sum: ulps.
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)


def clip_problem(rng):
    """Fields with values at 0 and 1, and 3 steps of gradients, some 0."""
    occ = rng.uniform(0, 1, (6, 6, 6)).astype(np.float32)
    occ[occ < 0.2] = 0.0
    occ[occ > 0.9] = 1.0
    alb = rng.uniform(0, 1, (6, 6, 6, 3)).astype(np.float32)
    grads = []
    for _ in range(3):
        go = rng.normal(size=occ.shape).astype(np.float32)
        ga = rng.normal(size=alb.shape).astype(np.float32)
        go[::2, 0, 0] = 0.0
        grads.append((t(go), t(ga)))
    return (t(occ), t(alb)), grads


def test_clipped_adam_matches_torch_adam_and_clamp(rng):
    params, grads = clip_problem(rng)
    mine = tuple(p.clone() for p in params)
    ref = tuple(p.clone() for p in params)
    opt = toptim.make_adam(mine, 0.05)
    assert not isinstance(opt, torch.optim.Adam)
    ropt = torch.optim.Adam(list(ref), lr=0.05, betas=(0.9, 0.999),
                            eps=1e-8)
    for gs in grads:
        toptim.adam_step(opt, mine, gs)
        for p, g in zip(ref, gs):
            p.grad = g
        ropt.step()
        with torch.no_grad():
            for p in ref:
                p.clamp_(0.0, 1.0)
                p.grad = None
    for a, b in zip(mine, ref):
        assert bool(((a >= 0) & (a <= 1)).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2.0 ** -22)   # 4 ulp in [0.5, 1)
        sa, sb = opt.state[a], ropt.state[b]
        assert int(sa["step"]) == int(sb["step"]) == 3
        np.testing.assert_allclose(sa["exp_avg_sq"].numpy(),
                                   sb["exp_avg_sq"].numpy(),
                                   rtol=4 * 2.0 ** -23, atol=0)
        top = np.float32(sb["exp_avg"].abs().max())
        np.testing.assert_allclose(sa["exp_avg"].numpy(),
                                   sb["exp_avg"].numpy(), rtol=0,
                                   atol=4 * np.spacing(top))


def test_clipped_adam_state_round_trip(rng):
    params, grads = clip_problem(rng)
    a = tuple(p.clone() for p in params)
    opt = toptim.make_adam(a, 0.05)
    for gs in grads[:2]:
        toptim.adam_step(opt, a, gs)
    leaves = toptim.adam_state_arrays(opt, a)
    assert int(leaves[0]) == 2 and leaves[0].dtype == np.int32
    b = tuple(p.clone() for p in a)
    opt_b = toptim.make_adam(b, 0.05)
    toptim.load_adam_state(opt_b, b, leaves)
    for x, y in zip(toptim.adam_state_arrays(opt_b, b), leaves):
        np.testing.assert_array_equal(x, y)
    toptim.adam_step(opt, a, grads[2])
    toptim.adam_step(opt_b, b, grads[2])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(toptim.adam_state_arrays(opt, a),
                    toptim.adam_state_arrays(opt_b, b)):
        np.testing.assert_array_equal(x, y)
    assert opt_b.param_groups[0]["betas"] == (0.9, 0.999)


def optim_problem(rng, g=8, n=128):
    """tests/test_optim.py::make_problem."""
    occ_true = np.zeros((g, g, g), np.float32)
    occ_true[2:6, 2:6, 2:6] = 1.0
    alb_true = np.full((g, g, g, 3), 0.7, np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = (np.array([g / 2] * 3) - dirs * 2 * g).astype(np.float32)
    bg = np.zeros((n, 3), np.float32)
    target, _, _ = jrender.composite_rays(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(occ_true),
        jnp.asarray(alb_true), jnp.asarray(bg), max_steps=3 * g)
    return origins, dirs, bg, np.asarray(target)


def test_jax_checkpoint_resumes_in_port(tmp_path, rng):
    o, d, bg, tgt = optim_problem(rng)
    jtr = JInverseRenderer(grid_shape=(8, 8, 8), max_steps_per_ray=24)
    ja = tuple(jnp.asarray(a) for a in (o, d, bg, tgt))
    for _ in range(5):
        jtr.train_step(*ja)
    ckpt = str(tmp_path / "jax.npz")
    jtr.save_checkpoint(ckpt)
    want = jtr.train_step(*ja)

    ttr = toptim.InverseRenderer(grid_shape=(8, 8, 8), max_steps_per_ray=24,
                                 device="cpu")
    ttr.load_checkpoint(ckpt)
    assert ttr.step == 5
    got = ttr.train_step(t(o), t(d), t(bg), t(tgt))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(ttr.occupancy.numpy(),
                               np.asarray(jtr.occupancy), rtol=1e-5,
                               atol=1e-6)

    # And back: the port's checkpoint resumes in the JAX package.
    ckpt2 = str(tmp_path / "port.npz")
    ttr.save_checkpoint(ckpt2)
    jtr2 = JInverseRenderer(grid_shape=(8, 8, 8), max_steps_per_ray=24)
    jtr2.load_checkpoint(ckpt2)
    np.testing.assert_allclose(jtr2.train_step(*ja),
                               ttr.train_step(t(o), t(d), t(bg), t(tgt)),
                               rtol=1e-5)


def test_trainer_converges_and_mesh_is_not_ported(rng):
    o, d, bg, tgt = (t(a) for a in optim_problem(rng))
    tr = toptim.InverseRenderer(grid_shape=(8, 8, 8), max_steps_per_ray=24,
                                device="cpu")
    losses = [tr.train_step(o, d, bg, tgt) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.5 and tr.step == 40
    # Sharded training is ported (tests/test_torch_parallel.py); a mesh this
    # rank is outside of refuses the step instead of training alone.
    from brickmap_tpu_torch.parallel.render import Mesh

    outside = Mesh(None, 2, -1, torch.device("cpu"))
    tr = toptim.InverseRenderer(grid_shape=(8, 8, 8), mesh=outside)
    with pytest.raises(ValueError, match="outside the mesh"):
        tr.train_step(o, d, bg, tgt)


@pytest.mark.parametrize("extra", [["--grid", "8", "--rays", "256"],
                                   ["--sparse", "--world", "128",
                                    "--world-height", "128", "--rays",
                                    "512"]])
def test_inverse_cli(capsys, extra):
    """``python -m brickmap_tpu_torch inverse [--sparse] --device cpu``: the
    loss falls over a few Adam steps."""
    import json

    from brickmap_tpu_torch.app import cli

    assert cli.main(["inverse", "--device", "cpu", "--steps", "5",
                     *extra]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["steps"] == 5
    assert out["loss_final"] < out["loss_first"]
