"""The port's configuration against ``brickmap_tpu.config``: the five
presets field by field (the TPU traversal knobs the port dropped, and the
fields neither package reads, left out), the derived properties, the mesh
and seed as their readers take them, and the bit constants."""

import dataclasses

import pytest

from brickmap_tpu import config as jcfg
from brickmap_tpu_torch import config as tcfg

# The JAX package's Pallas traversal knobs; the port has no page rounds.
DROPPED = ("paged_", "rays_per_chunk", "rescue_")
# Fields of the JAX config that neither package reads: the camera owns the
# lens (``render/camera.py``'s ``Camera.focal_distance``/``lens_radius``),
# a wave is one sample a pixel, and the port's mesh has no axis names.
UNREAD = ("render.samples_per_pixel", "render.focal_distance",
          "render.lens_radius", "mesh.axis_name")


def fields(obj, prefix=""):
    """{dotted field name: value} of a config, nested dataclasses flattened,
    the dropped TPU knobs and the unread fields left out."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if any(f.name.startswith(d) for d in DROPPED) \
                or f"{prefix}{f.name}" in UNREAD:
            continue
        if dataclasses.is_dataclass(v):
            out.update(fields(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def test_preset_names_match():
    assert list(tcfg.PRESETS) == list(jcfg.PRESETS)


def build(presets, name):
    """A preset's config, or the error that building it raises."""
    try:
        return presets[name]()
    except ValueError as e:
        return e


@pytest.mark.parametrize("name", list(jcfg.PRESETS))
def test_preset_matches_jax(name):
    want = build(jcfg.PRESETS, name)
    got = build(tcfg.PRESETS, name)
    if isinstance(want, ValueError):
        # The JAX package's inverse preset (a 64-voxel world) fails its own
        # grid check (64 is no multiple of 8 * 16); the port's raises alike.
        assert isinstance(got, ValueError) and str(got) == str(want)
        return
    assert fields(got) == fields(want)
    for sub in ("grid", "render"):
        j, t = getattr(want, sub), getattr(got, sub)
        for prop in ("cells", "cells_height", "supergrid_xy",
                     "num_superchunks", "bricks_per_superchunk", "world_max",
                     "num_pixels"):
            if hasattr(j, prop):
                assert getattr(t, prop) == getattr(j, prop), (sub, prop)


@pytest.mark.parametrize("d", [1, 4])
def test_preset_inverse_mesh(d, monkeypatch):
    """Config 5 with its grid check lifted (it raises as built, above):
    the mesh carries the device count, every field equals the JAX one."""
    monkeypatch.setattr(jcfg.GridConfig, "__post_init__", lambda self: None)
    monkeypatch.setattr(tcfg.GridConfig, "__post_init__", lambda self: None)
    got = tcfg.preset_inverse(d)
    assert got.mesh == tcfg.MeshConfig(num_devices=d)
    assert fields(got) == fields(jcfg.preset_inverse(d))


def test_dropped_fields_are_only_tpu_knobs():
    j = {f.name for f in dataclasses.fields(jcfg.RenderConfig)}
    t = {f.name for f in dataclasses.fields(tcfg.RenderConfig)}
    assert t <= j
    assert all(any(n.startswith(d) for d in DROPPED)
               or f"render.{n}" in UNREAD for n in j - t)
    j = {f.name for f in dataclasses.fields(jcfg.MeshConfig)}
    t = {f.name for f in dataclasses.fields(tcfg.MeshConfig)}
    assert t <= j and {f"mesh.{n}" for n in j - t} <= set(UNREAD)


def test_mesh_config_sizes_the_mesh():
    """``make_mesh(cfg.mesh)`` takes the config's device count: a world of
    one process (gloo) and a config of one rank, or a ValueError for a
    config that asks for more ranks than the world has."""
    import torch.distributed as dist

    from brickmap_tpu_torch.app.scaling import init_single_process
    from brickmap_tpu_torch.parallel.render import make_mesh

    init_single_process("cpu")
    try:
        mesh = make_mesh(tcfg.preset_full().mesh)
        assert (mesh.size, mesh.rank, mesh.member) == (1, 0, True)
        with pytest.raises(ValueError, match="2 ranks of a world of 1"):
            make_mesh(tcfg.MeshConfig(num_devices=2))
    finally:
        dist.destroy_process_group()


def test_cli_seed_reaches_the_config():
    """The CLI's ``--seed`` is the config's ``seed``, which its commands
    read; the presets keep the JAX package's seed 0."""
    import argparse

    from brickmap_tpu_torch.app.cli import _config

    args = argparse.Namespace(world=128, world_height=128, width=8, height=4,
                              bounces=1, max_steps=64, seed=7)
    cfg = _config(args)
    assert cfg.seed == 7 and cfg.mesh == tcfg.MeshConfig()
    assert all(p().seed == 0 for n, p in tcfg.PRESETS.items()
               if n != "inverse")


def test_bit_constants_match():
    for k in dir(jcfg):
        if k.startswith("BRICK_"):
            assert getattr(tcfg, k) == getattr(jcfg, k), k
