"""The reference agrees with the port's plain CPU path on a tiny world."""

import torch

from h100bench.loops import train as ltrain, view as lview
from h100bench.reference import compare, sparse as rsparse, world as rworld

from conftest import SEED, tiny_cell


def test_world_equals_the_ports_numpy_world(cpu):
    from brickmap_tpu_torch import scene

    cell = tiny_cell("view.over_world")
    loop = lview.Loop(cell["config_data"], cell["traffic_data"], SEED, cpu)
    ref = rworld.build_world(loop.rcfg.grid, cpu)
    prog = scene.generate_terrain_scene(loop.cfg.grid, use_native=False,
                                        device=cpu)
    for a, b in ((ref.index_volume, prog.index_volume),
                 (ref.pool_words, prog.pool_words),
                 (ref.pool_base, prog.pool_base)):
        assert torch.equal(a, b)
    assert compare.world_cells_differ(prog, ref, loop.rcfg.grid) == 0


def test_wave_equals_the_ports_wave(cpu):
    """The reference's wave against ``render_wave`` on the CPU (the plain
    versions) for the same uniforms: every pixel and count equal."""
    from brickmap_tpu_torch import scene

    cell = tiny_cell("view.from_outside")
    loop = lview.Loop(cell["config_data"], cell["traffic_data"], SEED, cpu)
    loop.setup()
    loop.scene = scene.generate_terrain_scene(loop.cfg.grid,
                                              use_native=False, device=cpu)
    world = rworld.build_world(loop.rcfg.grid, cpu)
    for i in range(len(loop.views)):
        gen = torch.Generator(device=cpu)
        gen.manual_seed(loop._hold_seed(i))
        rgb, count, req = loop.pathtrace.render_wave(
            loop.scene, loop.arrays[i], loop.bricks[i], loop.cfg,
            loop.width, loop.height, generator=gen)
        rgb_r, count_r, traced_r, exh_r, traces = loop._ref_wave(
            world, i, loop._hold_seed(i), 1)
        assert compare.pixels_differ(rgb, count, rgb_r, count_r) == 0.0
        assert int(req["traced_rays"]) == traced_r
        assert int(req["exhausted_rays"]) == exh_r == 0
        assert len(traces) == loop.cfg.render.max_bounces + 2
        assert sum(t["rays"] for t in traces) == traced_r


def test_training_steps_equal_the_ports(cpu):
    """Three steps of the port's loss, gradients and Adam on the CPU against
    the reference's: losses and leaf norms equal to rounding."""
    cell = tiny_cell("train.fixed_rays")
    c = cell["config_data"]
    loop = ltrain.Loop(c, cell["traffic_data"], SEED, cpu)
    loop.setup()
    grid = rsparse.GridConfig(**c["grid"])
    ref = rsparse.follow(rworld.build_world(grid, cpu), grid, *loop.rays,
                         loop.k, loop.lr, c["occupancy_scale"], c["albedo"])
    assert ref["active"] == loop.active > 0
    for a, b in zip(loop.losses, ref["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b)
    assert ref["losses"][2] < ref["losses"][0]
    assert compare.leaf_gap(loop.grad_norms, ref["grad_norms"],
                            ref["grad_norms"]) < 1e-5
    assert compare.leaf_gap(loop.change_norms, ref["change_norms"],
                            ref["grad_norms"]) < 1e-5
