"""Probe: the live viewer's presentation, the float path against W5.

    python3 notes/probe_torch_live_present.py [--frames 240] [--seed N]

On the card, flies the benchmark's tour (``view.preview_540p``: the
terrain_live_540p world streamed from cold, 960 x 540, the tour's first
``--frames`` frames) through ``LiveSession.frame`` without presenting, and
presents each frame's film both ways, in alternating order, each after a
synchronise:

* ``float``: the path before W5: ``tonemap`` (5 eager ops), the 6.2 MB
  float32 image copied to the host with ``.cpu().numpy()``, and the PNG
  encode that ``PreviewServer.update`` used to run on the render thread
  (``to_uint8`` + ``encode_png``), timed as its two parts;
* ``w5``: ``present`` (one launch of W5), the 1.5 MB uint8 copy, and
  ``update`` as it is now (it keeps the frame and encodes nothing).

Prints host ms a frame (median / mean) of each part, the PNG's bytes, W5's
device time (CUDA events around its launch), whether the two paths' 8-bit
frames agree on every frame, and for each leg of the tour how many of its
frames are black (every byte 0: the camera inside the terrain, where no
presentation fault can show) and the share of bytes that are not 0.
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=240)
    p.add_argument("--seed", type=int, default=3250000901)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    from brickmap_tpu_torch import scene as scene_mod
    from brickmap_tpu_torch.app.live import LiveSession
    from brickmap_tpu_torch.kernels import wave as kwave
    from brickmap_tpu_torch.ops import sunsky as ss
    from brickmap_tpu_torch.render import pathtrace as pt
    from brickmap_tpu_torch.render.camera import Camera
    from brickmap_tpu_torch.stream import StreamingScene
    from brickmap_tpu_torch.utils.image import encode_png, to_uint8
    from brickmap_tpu_torch.utils.preview import PreviewServer
    from h100bench import harness
    from h100bench.loops import live as llive

    dev = torch.device("cuda", 0)
    cell = harness.cell_spec("view.preview_540p", limits=False)
    loop = llive.Loop(cell["config_data"], cell["traffic_data"], args.seed,
                      dev)
    cfg, w, h = loop.cfg, loop.width, loop.height
    truth = scene_mod.generate_terrain_scene(cfg.grid, device=dev)
    mgr = StreamingScene(truth, cfg.grid, queue_size=loop.queue,
                         starting_capacity=loop.starting_capacity,
                         device=dev)
    del truth
    sun = ss.sun_direction_from_position(loop.config["sun_position"], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    srv = PreviewServer(0)
    live = LiveSession(mgr, sun, w, h, cfg, gen,
                       Camera.from_angles(*loop.poses[0]))
    inputs = llive.tour_inputs(loop.poses, loop.per_leg, live.move_scale)

    def sync():
        torch.cuda.synchronize()

    def float_path(film):
        t0 = time.perf_counter()
        img = pt.tonemap(film, w, h).cpu().numpy()
        t1 = time.perf_counter()
        png = encode_png(img)
        t2 = time.perf_counter()
        return to_uint8(img), png, {"float.copy": t1 - t0,
                                    "float.encode": t2 - t1}

    def w5_path(film):
        t0 = time.perf_counter()
        img = pt.present(film, w, h).cpu().numpy()
        t1 = time.perf_counter()
        srv.update(img, frame=0)
        t2 = time.perf_counter()
        return img, {"w5.copy": t1 - t0, "w5.update": t2 - t1}

    for k in range(4):           # warm-up: both paths build and run once
        live.frame(inputs[k], present=False)
        float_path(live.film)
        w5_path(live.film)
    times: dict = {}
    equal, sizes, lit = 0, [], []
    kwave.blit.events = []
    n = min(args.frames, len(inputs) - 4)
    for k in range(4, 4 + n):
        live.frame(inputs[k], present=False)
        sync()
        if k % 2:
            img_f, png, tf = float_path(live.film)
            sync()
            img_w, tw = w5_path(live.film)
        else:
            img_w, tw = w5_path(live.film)
            sync()
            img_f, png, tf = float_path(live.film)
        sync()
        for key, v in {**tf, **tw}.items():
            times.setdefault(key, []).append(v)
        equal += bool(np.array_equal(img_f, img_w))
        sizes.append(len(png))
        lit.append((k // loop.per_leg, float((img_w != 0).mean())))
    sync()
    w5_us = [a.elapsed_time(b) * 1e3 for a, b in kwave.blit.events]
    kwave.blit.events = None
    srv.close()
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(f"card: {card}; {n} frames of the tour at {w}x{h}")
    for key in ("float.copy", "float.encode", "w5.copy", "w5.update"):
        v = times[key]
        print(f"{key}: host ms median {statistics.median(v) * 1e3:.4f}, "
              f"mean {statistics.mean(v) * 1e3:.4f}, "
              f"max {max(v) * 1e3:.4f}")
    fl = [a + b for a, b in zip(times["float.copy"], times["float.encode"])]
    ww = [a + b for a, b in zip(times["w5.copy"], times["w5.update"])]
    print(f"float path total: median {statistics.median(fl) * 1e3:.4f} ms; "
          f"w5 path total: median {statistics.median(ww) * 1e3:.4f} ms")
    print(f"PNG bytes median {statistics.median(sizes):.0f}, "
          f"min {min(sizes)}, max {max(sizes)}")
    print(f"W5 device us (events): median {statistics.median(w5_us):.3f}, "
          f"min {min(w5_us):.3f}, max {max(w5_us):.3f} over {len(w5_us)}")
    print(f"8-bit frames equal on {equal} of {n} frames")
    for leg in sorted({g for g, _ in lit}):
        shares = [x for g, x in lit if g == leg]
        print(f"leg {leg}: {sum(x == 0 for x in shares)} of {len(shares)} "
              f"frames black; bytes not 0: median "
              f"{statistics.median(shares):.4f}, min {min(shares):.4f}")
    return 0 if equal == n else 1


if __name__ == "__main__":
    sys.exit(main())
