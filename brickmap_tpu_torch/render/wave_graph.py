"""The sample wave replayed as one CUDA graph.

On the card :func:`~brickmap_tpu_torch.render.pathtrace.render_wave`
launches 36 kernels a wave: the five draws of its uniforms, W1, five traces
(W0, W2, B2, W0, W4) and five W3.  Each launch from Python costs the host
tens of microseconds, more than most of the kernels take on the device.
W0 leaves every count on the device, so W1 to the final W3 make no host
round trip, and a wave that repeats is captured once as a CUDA graph and
then replayed with one launch.  The kernels, their arguments and their
order are the eager wave's.

What a capture bakes in is the key (:func:`wave_key`): the frame size, the
lane count and the tile order, the configuration, ``cam_brick`` and the
scene's three arrays, each by address and shape.  Their contents are not
in it: a replay reads whatever those addresses hold when it runs, so index
words that a streaming scene rewrites in place stay right.  The camera
arrays and the uniforms are the graph's inputs (:class:`Inputs`): before
each replay the uniforms are drawn into them from the caller's generator,
as the eager wave draws them, and the caller's camera arrays are copied in.
So neither is in the key, and the replay is bit-equal to the eager wave
for the same generator state.

:class:`GraphTable` is the capture rule, in plain Python: a key is captured
on the third of three consecutive calls with it (the first runs eagerly,
which also builds what the capture needs: the kernels, the tile order, the
sky constants, the launchers' occupancy), and replays on every later call
while it is among the ``MAX_GRAPHS`` most recently used.  A capture costs
more than an eager wave, so a key that comes back only once (a moving
camera's brick, held for two frames) is not captured.
:class:`WaveGraphs` is that table on one device and stream: its graphs
share one memory pool and one set of inputs a wave shape, and replay in
order on that stream; each replay's outputs are cloned out before the
next.  A wave stays eager, whatever its key, on the CPU, with injected
uniforms (their check reads the host) or while a kernel wrapper's
``.events`` hook times its launches (:func:`eager_only`).
:func:`prepare` is the entry point: it decides how one call runs and
counts it in :data:`calls`.  A kernel wrapper's ``.launches`` counts the
launches it makes, a capture's included; a replay launches the graph and
no wrapper, and is counted in ``calls[REPLAY]``.
"""

from __future__ import annotations

import collections
import contextlib

import torch

from ..kernels import traverse as ktrav, wave as kwave
from ..utils import profiling
from .sampling import empty_wave_uniforms

__all__ = ["MAX_GRAPHS", "CAPTURE_AT", "EAGER", "CAPTURE", "REPLAY",
           "calls", "GraphTable", "WaveGraphs", "WaveGraph", "Inputs",
           "Call", "table", "prepare", "wave_key", "eager_only"]

MAX_GRAPHS = 8     # captured waves kept a device and stream
CAPTURE_AT = 3     # the consecutive call with one key that captures it
EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"
# The camera arrays a wave reads, with their shapes: its graph's inputs.
CAMERA_SHAPES = {"position": (3,), "direction": (3,), "right": (3,),
                 "up": (3,), "focal_distance": (), "lens_radius": (),
                 "sun_direction": (3,)}

_tables: dict = {}   # (device index, stream) -> WaveGraphs
# render_wave's calls each way, on every device: {EAGER: n, CAPTURE: n,
# REPLAY: n}.
calls: collections.Counter = collections.Counter()


def _wrappers() -> tuple:
    """The kernel wrappers a wave launches through (read when called, so
    that a wrapper put in their place is the one seen)."""
    return (kwave.primary, kwave.compact, kwave.gather_clip, ktrav.trace,
            kwave.rescue, kwave.shade)


def eager_only(uniforms) -> bool:
    """Whether a wave on the card runs eagerly whatever its key: with
    injected ``uniforms`` (:func:`~brickmap_tpu_torch.render.pathtrace.
    render_wave` checks them with a host read) or while a kernel wrapper's
    ``.events`` hook times each launch."""
    return uniforms is not None or any(w.events is not None
                                       for w in _wrappers())


def wave_key(scene, perm, cam_brick, cfg, width: int, height: int) -> tuple:
    """What a captured wave bakes in: the frame size, the lane count and the
    tile order ``perm``, ``cfg``, ``cam_brick`` (B2's and W4's LoD origin)
    and the scene's index volume, pool words and pool bases, each tensor by
    its address and shape."""
    def where(t):
        return t.data_ptr(), tuple(t.shape)

    return (width, height, perm.shape[0], where(perm), cfg,
            tuple(int(c) for c in cam_brick), where(scene.index_volume),
            where(scene.pool_words), where(scene.pool_base))


class GraphTable:
    """The capture rule and the captured waves of one device and stream.

    :meth:`step` says what a call with ``key`` does: replay the graph
    captured for it, capture it (it is the ``CAPTURE_AT``-th call in a row
    with that key), or run eagerly.  At most ``MAX_GRAPHS`` graphs are
    kept, the least recently used dropped first."""

    def __init__(self):
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.last = None      # the previous call's key
        self.run = 0          # calls in a row with it

    def step(self, key) -> tuple:
        """``(REPLAY, graph)``, ``(CAPTURE, None)`` or ``(EAGER, None)`` for
        a call with ``key``; a key of None (a wave that must run eagerly)
        runs eagerly and breaks the sequence."""
        graph = None if key is None else self.graphs.get(key)
        self.run = self.run + 1 if key is not None and key == self.last \
            else 1
        self.last = key
        if graph is not None:
            self.graphs.move_to_end(key)
            return REPLAY, graph
        if key is not None and self.run >= CAPTURE_AT:
            return CAPTURE, None
        return EAGER, None

    def add(self, key, graph) -> None:
        """Keep ``graph`` for ``key``, dropping the least recently used
        beyond ``MAX_GRAPHS``."""
        self.graphs[key] = graph
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)


class Inputs:
    """A captured wave's inputs on ``device``: the uniforms of ``n`` lanes
    and ``max_bounces`` bounces, and the camera arrays."""

    def __init__(self, n: int, max_bounces: int, device):
        self.uniforms = empty_wave_uniforms(n, max_bounces, device)
        self.camera = {k: torch.empty(s, dtype=torch.float32, device=device)
                       for k, s in CAMERA_SHAPES.items()}

    def set_camera(self, camera_arrays: dict) -> None:
        """Copy the caller's camera arrays in (copies on the device)."""
        for k, t in self.camera.items():
            src = camera_arrays[k]
            if tuple(src.shape) != t.shape:
                raise ValueError(f"{k}: shape {tuple(src.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(src)


class WaveGraph:
    """One captured wave: the graph, its outputs and the W0 count of each
    trace (in the graph's memory), and the tensors it reads that nothing
    else keeps alive."""

    def __init__(self, graph, outputs: tuple, counts: list, keep: tuple):
        self.graph = graph
        self.outputs = outputs
        self.counts = counts
        self.keep = keep

    def replay(self) -> tuple:
        """Launch the graph on the current stream.  Returns its outputs
        cloned out of the graph's memory (rgb, count, requests, and the
        trace counts while a profiler records, else []), with no host round
        trip."""
        self.graph.replay()
        rgb, count, mask, pos, traced, exhausted = (
            t.clone() for t in self.outputs)
        counts = ([c.clone() for c in self.counts]
                  if profiling.recording() else [])
        return rgb, count, {"mask": mask, "pos": pos, "traced_rays": traced,
                            "exhausted_rays": exhausted}, counts


class WaveGraphs(GraphTable):
    """:class:`GraphTable` on a CUDA ``device`` and its current stream, with
    what the captures share: a capture stream, one memory pool (replays run
    in order on one stream and their outputs are cloned out, so a graph may
    reuse what another captured before it let go) and one :class:`Inputs`
    a wave shape."""

    def __init__(self, device):
        super().__init__()
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.inputs: dict = {}

    def inputs_for(self, n: int, max_bounces: int) -> Inputs:
        key = (n, max_bounces)
        if key not in self.inputs:
            self.inputs[key] = Inputs(n, max_bounces, self.device)
        return self.inputs[key]

    def capture(self, key, inputs: Inputs, body, keep: tuple) -> WaveGraph:
        """Capture ``body(inputs.uniforms, inputs.camera)`` (the wave from
        W1 to its final W3, returning (rgb, count, requests, trace counts))
        on the capture stream into the pool, and keep it for ``key``.
        Nothing runs on the device until the graph is replayed."""
        dev = self.device
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            # W0's and W4's scratch for the capture stream, zeroed before
            # the capture (the caller's stream waits for it).
            kwave.scratch(dev)
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                rgb, count, req, counts = body(inputs.uniforms, inputs.camera)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        out = WaveGraph(graph, (rgb, count, req["mask"], req["pos"],
                                req["traced_rays"], req["exhausted_rays"]),
                        counts, keep)
        self.add(key, out)
        return out


class Call:
    """A call of the wave that runs as a graph: its uniforms are drawn into
    :attr:`uniforms` (the graph's inputs), then :meth:`run` captures the
    wave, if it is not captured yet, and replays it."""

    def __init__(self, graphs: WaveGraphs, key, inputs: Inputs, graph,
                 keep: tuple):
        self.graphs, self.key, self.inputs = graphs, key, inputs
        self.graph, self.keep = graph, keep
        self.uniforms = inputs.uniforms

    def run(self, camera_arrays: dict, trace) -> tuple:
        """Copy ``camera_arrays`` into the graph's inputs and replay it,
        capturing ``trace(uniforms, camera_arrays)`` first if need be:
        (rgb, count, requests, trace counts), the caller's to keep."""
        self.inputs.set_camera(camera_arrays)
        graph = self.graph
        if graph is None:
            graph = self.graphs.capture(self.key, self.inputs, trace,
                                        self.keep)
        return graph.replay()


def table(device) -> WaveGraphs | None:
    """The captured waves of ``device`` and its current stream; None off
    CUDA (a wave on the CPU runs the plain versions)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    at = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if at not in _tables:
        _tables[at] = WaveGraphs(dev)
    return _tables[at]


def prepare(scene, perm, cam_brick, cfg, width: int, height: int,
            uniforms) -> Call | None:
    """How a call of the wave runs: None, eagerly, or a :class:`Call`
    that replays (capturing first, as :class:`GraphTable` rules) the graph
    of its :func:`wave_key`.  Counts the call in :data:`calls` and, while a
    profiler records, keeps ``wave.graph_replays`` (1 where the wave runs
    as a graph)."""
    graphs = table(scene.device)
    key = None
    if graphs is not None and not eager_only(uniforms):
        key = wave_key(scene, perm, cam_brick, cfg, width, height)
    way, graph = (EAGER, None) if graphs is None else graphs.step(key)
    calls[way] += 1
    profiling.count("wave.graph_replays", int(way != EAGER))
    if way == EAGER:
        return None
    keep = () if graph is not None else (
        perm, kwave.sky_constants(cfg.sky, scene.device))
    return Call(graphs, key,
                graphs.inputs_for(perm.shape[0], cfg.render.max_bounces),
                graph, keep)
