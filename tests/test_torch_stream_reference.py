"""The port's streaming manager and frames against the benchmark's plain
reference (``h100bench/reference/stream.py``), on the CPU: the same request
lists end in the same residency state, and two frames of the benchmark's
stream loop equal the reference's frames over the reference's state."""

import numpy as np
import pytest
import torch

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import GridConfig
from brickmap_tpu_torch.stream import StreamingScene
from h100bench import harness
from h100bench.loops import stream as lstream
from h100bench.reference import compare, config as rconfig, \
    stream as rstream

SEED = 2**31 + 91


@pytest.fixture(scope="module")
def truth():
    return tscene.generate_terrain_scene(
        GridConfig(grid_size=256, grid_height=128), use_native=False,
        device="cpu")


def request_lists(truth, rng, n_lists, size):
    """Requests from non-empty bricks in clusters (as a wave's rays ask for
    neighbouring bricks), repeated and with empty cells among them."""
    iv = truth.index_volume.numpy().view(np.uint32)
    full = np.argwhere(iv & np.uint32(0xE000_0000))
    empty = np.argwhere((iv & np.uint32(0xE000_0000)) == 0)
    out = []
    for _ in range(n_lists):
        start = int(rng.integers(0, full.shape[0] - size))
        z_y_x = np.concatenate([full[start:start + size],
                                full[rng.integers(0, full.shape[0], size)],
                                empty[rng.integers(0, empty.shape[0], 9)]])
        z_y_x = z_y_x[rng.permutation(z_y_x.shape[0])]
        reqs = [(int(x), int(y), int(z)) for z, y, x in z_y_x]
        out.append(reqs + reqs[::7])
    return out


@pytest.mark.parametrize("queue, capacity", [(64, 4), (1024, 16)])
def test_manager_equals_the_reference(truth, queue, capacity):
    """Capped and uncapped batches, segment growth, stale lists and a reset:
    bit-equal states after every list."""
    rng = np.random.default_rng(queue)
    grid = GridConfig(grid_size=256, grid_height=128)
    port = StreamingScene(truth, grid, queue_size=queue,
                          starting_capacity=capacity, device="cpu")
    ref = rstream.Manager(*port.truth_arrays(),
                          rconfig.GridConfig(grid_size=256, grid_height=128),
                          queue, capacity)
    lists = request_lists(truth, rng, 5, 150)
    grew = capped = 0
    for i, reqs in enumerate(lists + lists[:2]):
        if i == 4:
            port.reset()
            ref.reset()
        rebases, dropped = port.total_rebases, port.total_dropped
        assert port.process_requests(reqs) == ref.process(reqs)
        grew += port.total_rebases > rebases
        capped += port.total_dropped > dropped
        assert rstream.state_differ(port.state(), ref.state()) == 0
    assert grew >= 2 and (capped >= 2 if queue == 64 else capped == 0)


def _tiny_cell():
    cell = harness.cell_spec("stream.cold_start", harness.benchmark())
    c = cell["config_data"]
    c["grid"].update(grid_size=128, grid_height=128)
    c["render"].update(width=64, height=48, max_top_steps=256)
    # View 4 sits outside the box looking back; view 0 scaled into this
    # small world sits inside the terrain and requests nothing.
    cell["traffic_data"] = dict(cell["traffic_data"], view=4, cycle=2)
    return cell


def test_two_frames_equal_the_references():
    """A cycle of the stream loop on the CPU: before each frame the port's
    state equals the reference manager's fed the same lists, and the frame,
    its traced rays and its pulled requests equal the reference's frame
    over that state."""
    cpu = torch.device("cpu")
    cell = _tiny_cell()
    loop = lstream.Loop(cell["config_data"], cell["traffic_data"], SEED, cpu)
    loop.setup()
    ref = loop.ref_manager()
    mgr = loop.mgr
    gen = torch.Generator(device=cpu)
    gen.manual_seed(loop._cycle_seed(5))
    mgr.reset()
    film = loop.pathtrace.film_init(loop.width, loop.height, cpu)
    for k in range(loop.cycle):
        assert rstream.state_differ(mgr.state(), ref.state()) == 0
        film, rgb, count, req, traced, got, uploads, _ = loop._frame(film,
                                                                     gen)
        rgb_r, count_r, traced_r, exh_r, req_r = loop.ref_frame(
            ref.world(cpu), 5, k + 1)
        assert compare.pixels_differ(rgb, count, rgb_r, count_r) == 0.0
        assert traced == traced_r and int(req["exhausted_rays"]) == exh_r
        assert got == rstream.pull(req_r, loop.queue) and got
        assert uploads == ref.process(got) > 0
    assert rstream.state_differ(mgr.state(), ref.state()) == 0
