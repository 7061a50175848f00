"""The sample wave as one CUDA graph (``render/wave_graph.py``).

On the CPU, in the style of the host rehearsals: the key and the capture
rule as plain Python over fake keys and CPU tensors (what changes the key
and what does not, the third consecutive sighting capturing, an
interrupted sequence not, at most ``MAX_GRAPHS`` graphs kept, the waves
that stay eager), a replay's bookkeeping over a stand-in graph, and the
in-place draws against ``torch.randint`` / ``torch.rand``.  The ``cuda``
case holds the graphed wave bit-equal to the eager one on the card.
"""

import dataclasses

import pytest
import torch

from brickmap_tpu_torch import scene as tscene
from brickmap_tpu_torch.config import BrickmapConfig, GridConfig, \
    RenderConfig
from brickmap_tpu_torch.kernels import traverse as ktrav, wave as kwave
from brickmap_tpu_torch.ops import sunsky as tss
from brickmap_tpu_torch.render import pathtrace as tpt, wave_graph as wg
from brickmap_tpu_torch.render.camera import Camera, camera_arrays_for
from brickmap_tpu_torch.render.sampling import draw_wave_uniforms
from brickmap_tpu_torch.utils import profiling

torch.set_num_threads(2)

W, H = 16, 12
CFG = BrickmapConfig(grid=GridConfig(grid_size=128, grid_height=128),
                     render=RenderConfig(width=W, height=H, max_bounces=1,
                                         max_top_steps=64))
WRAPPERS = (kwave.primary, kwave.compact, kwave.gather_clip, ktrav.trace,
            kwave.rescue, kwave.shade)


@dataclasses.dataclass
class FakeScene:
    index_volume: torch.Tensor
    pool_words: torch.Tensor
    pool_base: torch.Tensor


def base():
    """A scene, tile order and the rest of a key's arguments."""
    scene = FakeScene(torch.zeros(8, dtype=torch.int32),
                      torch.zeros(32, dtype=torch.int32),
                      torch.zeros(4, dtype=torch.int32))
    perm = torch.arange(W * H)
    return {"scene": scene, "perm": perm, "cam_brick": (3, 4, 5),
            "cfg": CFG, "width": W, "height": H}


def key(a):
    return wg.wave_key(a["scene"], a["perm"], a["cam_brick"], a["cfg"],
                       a["width"], a["height"])


def _swap(field, make):
    def change(a):
        s = a["scene"]
        a["scene"] = dataclasses.replace(s, **{field: make(getattr(s,
                                                                   field))})
    return change


@pytest.mark.parametrize("change", [
    _swap("pool_words", torch.zeros_like),           # another address
    _swap("pool_words", lambda t: t[:16]),           # same address, shape
    _swap("index_volume", torch.zeros_like),
    _swap("index_volume", lambda t: t.view(2, 4)),
    _swap("pool_base", torch.zeros_like),
    lambda a: a.update(cam_brick=(3, 4, 6)),
    lambda a: a.update(perm=torch.arange(W * H - 1)),   # the lane count
    lambda a: a.update(perm=torch.arange(W * H)),       # another tile order
    lambda a: a.update(width=H, height=W),
    lambda a: a.update(cfg=dataclasses.replace(
        CFG, render=dataclasses.replace(CFG.render, max_bounces=2))),
    lambda a: a.update(cfg=dataclasses.replace(
        CFG, grid=dataclasses.replace(CFG.grid, grid_height=256))),
], ids=["pool_words ptr", "pool_words shape", "index_volume ptr",
        "index_volume shape", "pool_base ptr", "cam_brick", "lanes",
        "perm ptr", "frame size", "bounces", "grid"])
def test_key_changes_with_what_the_capture_bakes_in(change):
    a = base()
    k0 = key(a)
    change(a)
    assert key(a) != k0


@pytest.mark.parametrize("change", [
    lambda a: a.update(scene=dataclasses.replace(a["scene"])),  # new object
    lambda a: a["scene"].pool_words.fill_(7),       # contents, in place
    lambda a: a["scene"].index_volume.add_(1),
    lambda a: a.update(cam_brick=(3.0, 4.0, 5.0)),
    lambda a: a.update(cam_brick=torch.tensor([3, 4, 5])),
], ids=["scene object", "pool contents", "index contents", "float brick",
        "tensor brick"])
def test_key_keeps_what_a_replay_reads_afresh(change):
    """Contents are read at each replay and the scene object is not
    baked in, so neither moves the key (nor do the camera arrays and the
    generator, which are not its arguments: they are the graph's
    inputs)."""
    a = base()
    k0 = key(a)
    change(a)
    assert key(a) == k0


@pytest.mark.parametrize("keys, ways", [
    ("A", "E"),
    ("AA", "EE"),
    ("AAA", "EEC"),
    ("AAAAA", "EECRR"),
    ("AABA", "EEEE"),
    ("ABAB", "EEEE"),
    ("AAABBBA", "EECEECR"),
    ("AA-A", "EEEE"),        # a wave that must run eagerly interrupts
    ("AAA-A", "EECER"),
    ("ABBBA", "EEECE"),
    ("AAAB-BBBA", "EECEEEECR"),
], ids=lambda v: v)
def test_capture_rule(keys, ways):
    """The third of three consecutive sightings captures; a captured key
    replays whenever it comes back; any other key (or an eager-only call,
    ``-``) among the three means no capture."""
    assert wg.CAPTURE_AT == 3
    table = wg.GraphTable()
    got = []
    for k in keys:
        way, graph = table.step(None if k == "-" else k)
        if way == wg.CAPTURE:
            table.add(k, f"graph {k}")
        if way == wg.REPLAY:
            assert graph == f"graph {k}"
        got.append({wg.EAGER: "E", wg.CAPTURE: "C", wg.REPLAY: "R"}[way])
    assert "".join(got) == ways


def test_table_keeps_the_eight_most_recently_used():
    table = wg.GraphTable()
    assert wg.MAX_GRAPHS == 8
    for i in range(8):
        for _ in range(3):
            if table.step(i)[0] == wg.CAPTURE:
                table.add(i, i)
    assert table.step(0) == (wg.REPLAY, 0)    # 0 is now the most recent
    for i in (8, 9):
        table.step(i)
        table.step(i)
        assert table.step(i)[0] == wg.CAPTURE
        table.add(i, i)
    assert len(table.graphs) == 8
    assert list(table.graphs) == [3, 4, 5, 6, 7, 0, 8, 9]
    assert table.step(1) == (wg.EAGER, None)
    assert table.step(0) == (wg.REPLAY, 0)


@pytest.mark.parametrize("which", range(len(WRAPPERS) + 2),
                         ids=[w.__name__ for w in WRAPPERS]
                         + ["uniforms", "none"])
def test_eager_only(which, monkeypatch):
    """Injected uniforms and any wrapper's ``.events`` hook keep a wave on
    the card eager; the CPU has no table at all."""
    uniforms = None
    if which < len(WRAPPERS):
        monkeypatch.setattr(WRAPPERS[which], "events", [])
    elif which == len(WRAPPERS):
        uniforms = draw_wave_uniforms(4, 1, device="cpu")
    assert wg.eager_only(uniforms) == (which <= len(WRAPPERS))
    assert wg.table("cpu") is None and wg.table(torch.device("cpu")) is None


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_in_place_draws_equal_fresh_draws(seed):
    """The draws into a captured wave's inputs are ``torch.randint`` /
    ``torch.rand``'s bits, in their order, and the generator ends where
    the fresh draws leave it."""
    n, nb = 257, 2
    g = torch.Generator().manual_seed(seed)
    want = {"stratum": torch.randint(0, 16, (n,), generator=g),
            "jitter": torch.rand((n, 2), generator=g),
            "lens": torch.rand((n, 2), generator=g),
            "cone": torch.rand((nb + 1, 2, n), generator=g),
            "hemi": torch.rand((nb + 1, 2, n), generator=g)}
    after = torch.rand(3, generator=g)
    inputs = wg.Inputs(n, nb, "cpu")
    g.manual_seed(seed)
    got = draw_wave_uniforms(n, nb, g, "cpu", out=inputs.uniforms)
    assert got is inputs.uniforms
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(torch.rand(3, generator=g), after)
    g.manual_seed(seed)
    fresh = draw_wave_uniforms(n, nb, g, "cpu")
    assert all(torch.equal(fresh[k], want[k]) for k in want)


def test_inputs_take_the_camera_arrays():
    inputs = wg.Inputs(4, 1, "cpu")
    cam = Camera.from_angles((20.0, 20.0, 100.0), 0.3, -0.2)
    arrays = camera_arrays_for(
        cam, tss.sun_direction_from_position((0.05, 0.1), "cpu"), W, H,
        "cpu")
    inputs.set_camera(arrays)
    for k, t in inputs.camera.items():
        assert t.dtype == torch.float32 and torch.equal(t, arrays[k].float())
    with pytest.raises(ValueError, match="focal_distance"):
        inputs.set_camera({**arrays,
                           "focal_distance": torch.ones(3)})


class StandInGraph:
    """A CUDA graph's stand-in: each replay writes the next values into
    the wave's outputs, as the captured kernels would."""

    def __init__(self, outputs, counts):
        self.outputs, self.counts, self.n = outputs, counts, 0

    def replay(self):
        self.n += 1
        for t in (*self.outputs, *self.counts):
            t.fill_(self.n)


@pytest.mark.parametrize("profiled", [False, True])
def test_replay_clones_outputs_and_counts_launches(profiled, monkeypatch):
    """A replay's outputs and trace counts are copies (the next replay
    leaves them as they were), the trace counts are copied only while a
    profiler records, and no wrapper's ``.launches`` moves: a replay
    launches the graph, not the wrappers."""
    outputs = (torch.zeros(6, 3), torch.zeros(6), torch.zeros(6),
               torch.zeros(6, 3), torch.zeros(()), torch.zeros(()))
    counts = [torch.zeros(1, dtype=torch.int32) for _ in range(3)]
    graph = wg.WaveGraph(StandInGraph(outputs, counts), outputs, counts,
                         keep=())
    monkeypatch.setattr(profiling, "recording", lambda: profiled)
    before = [w.launches for w in WRAPPERS]
    rgb, count, req, kept = graph.replay()
    assert [w.launches for w in WRAPPERS] == before
    rgb2, _, req2, kept2 = graph.replay()
    assert float(rgb.max()) == 1 and float(rgb2.min()) == 2
    assert float(req["traced_rays"]) == 1 and float(req2["pos"].min()) == 2
    assert rgb.data_ptr() != outputs[0].data_ptr()
    assert len(kept) == (3 if profiled else 0)
    assert all(int(c) == 1 for c in kept)
    assert all(int(c) == 2 for c in kept2)


@pytest.fixture(scope="module")
def tiny_world():
    return tscene.generate_terrain_scene(CFG.grid, feature_scale=64.0,
                                         use_native=False, device="cpu")


def test_cpu_wave_runs_eagerly(tiny_world):
    """A wave on the CPU runs the plain versions, counted eager, whatever
    repeats, and keeps ``wave.graph_replays`` 0 under a profiler."""
    sun = tss.sun_direction_from_position((0.05, 0.1), "cpu")
    cam = Camera.from_angles((20.0, 20.0, 100.0), 0.7, -0.3)
    arrays = camera_arrays_for(cam, sun, W, H, "cpu")
    calls = dict(wg.calls)
    g = torch.Generator()
    outs = []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            g.manual_seed(11)
            outs.append(tpt.render_wave(tiny_world, arrays,
                                        cam.brick_position, CFG, W, H,
                                        generator=g))
        kept = profiling.take_counts()
    assert [wg.calls[k] - calls.get(k, 0) for k in (
        wg.EAGER, wg.CAPTURE, wg.REPLAY)] == [3, 0, 0]
    assert kept["wave.graph_replays"] == [0, 0, 0]
    assert len(kept["wave.trace_rays"]) == 3 * (CFG.render.max_bounces + 2)
    assert all(torch.equal(outs[0][0], o[0]) for o in outs[1:])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_graphed_wave_equals_eager_wave():
    """On the card, over two views and three seeds: the first two
    sightings run eagerly, the third captures and later ones replay, each
    bit-equal to the eager wave for the same generator state; a replay's
    outputs stay as they were after the next replay; ``manual_seed``
    between replays is honoured; a capture advances each wrapper's
    ``.launches`` as the eager wave does and a replay advances none; and a
    replay makes no synchronising call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = BrickmapConfig(grid=GridConfig(grid_size=512, grid_height=128),
                         render=RenderConfig(width=320, height=180))
    w, h = cfg.render.width, cfg.render.height
    world = tscene.generate_terrain_scene(cfg.grid, device=dev)
    sun = tss.sun_direction_from_position((0.05, 0.1), dev)
    def looking(frm, at):
        d = torch.tensor(at) - torch.tensor(frm)
        return Camera(position=frm, direction=tuple((d / d.norm()).tolist()))

    # Over the terrain (the viewer's default view), and from outside the
    # world box looking back.
    cams = (looking((60.0, 60.0, 110.0), (256.0, 256.0, 40.0)),
            looking((-200.0, 256.0, 160.0), (256.0, 256.0, 40.0)))
    gen = torch.Generator(device=dev)

    def wave(cam, arrays, seed, eager=False, sync=True):
        """(outputs, launches a wrapper) of one render_wave call."""
        if eager:
            ktrav.trace.events = []
        try:
            gen.manual_seed(seed)
            before = [x.launches for x in WRAPPERS]
            out = tpt.render_wave(world, arrays, cam.brick_position, cfg, w,
                                  h, generator=gen)
            if sync:
                torch.cuda.synchronize()
        finally:
            ktrav.trace.events = None
        return out, [x.launches - b for x, b in zip(WRAPPERS, before)]

    def same(a, b):
        return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))

    def copy(out):
        return (out[0].clone(), out[1].clone(),
                {k: v.clone() for k, v in out[2].items()})

    seeds = (101, 2**31 + 7, 2**31 + 8)
    with torch.cuda.stream(torch.cuda.Stream()):   # a table of its own
        for view, cam in enumerate(cams):
            arrays = camera_arrays_for(cam, sun, w, h, dev)
            want = {}
            for s in seeds:
                want[s], eager_launches = wave(cam, arrays, s, eager=True)
            for s in seeds:
                assert int(want[s][2]["traced_rays"]) > 0
                assert float(want[s][0].sum()) > 0     # not a black frame
            ways = dict(wg.calls)
            first, _ = wave(cam, arrays, seeds[0])
            again0, _ = wave(cam, arrays, seeds[0])
            # Arrays remade, as a live caller remakes them: the same key.
            second, cap_launches = wave(
                cam, camera_arrays_for(cam, sun, w, h, dev), seeds[0])
            kept = copy(second)
            torch.cuda.set_sync_debug_mode("error")
            try:
                third, rep_launches = wave(cam, arrays, seeds[1],
                                           sync=False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            other, _ = wave(cam, arrays, seeds[2])
            again, _ = wave(cam, arrays, seeds[0])
            assert [wg.calls[k] - ways.get(k, 0) for k in (
                wg.EAGER, wg.CAPTURE, wg.REPLAY)] == [2, 1, 3]
            for got, s in ((first, 0), (again0, 0), (second, 0), (third, 1),
                           (other, 2), (again, 0)):
                assert same(got, want[seeds[s]]), (view, s)
            assert same(second, kept)          # after three more replays
            assert not torch.equal(want[seeds[1]][0], want[seeds[2]][0])
            assert eager_launches == cap_launches
            assert eager_launches[0] == 1
            assert eager_launches[3] == cfg.render.max_bounces + 2
            assert eager_launches[1] == 2 * eager_launches[3]
            assert rep_launches == [0] * len(WRAPPERS)
