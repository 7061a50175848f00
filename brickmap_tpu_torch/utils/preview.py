"""Live HTTP preview of a progressive render, with fly-camera input.

The port's copy of ``brickmap_tpu/utils/preview.py`` (standard library only).
The reference presents frames in a GLFW window with an ImGui stats panel and
a WASD/mouse fly camera (``main.cpp:26-190``, ``camera.cpp:3-46``); on a
headless host the equivalent is a tiny dependency-free HTTP server: the
render loop hands over each frame (the image as it is + stats), any browser
pointed at the port sees a self-refreshing view, and key input in the page is
POSTed back as camera deltas that the render loop applies between waves
(resetting accumulation, kernel.cu:387-403).  Serving is decoupled from the
render loop: a frame is PNG-encoded only when a client fetches it, once for
each frame handed over, on the server's thread.  A 1 spp frame is noise,
which deflate barely shrinks: encoding one of 960 x 540 takes tens of ms of
host time, several times a wave's, so the render loop never pays it, and a
slow or absent viewer never blocks a wave.

Routes:

* ``/``           — HTML page: frame image + live stats + key capture.
* ``/frame.png``  — latest frame, encoded at its first fetch (no-cache).
* ``/stats.json`` — latest wave stats (wave index, Mrays/s, spp, ...).
* ``POST /camera``— accumulated input deltas ``{"move":[f,r,u],
  "rot":[dyaw,dpitch]}`` (forward/right/up impulses, radians), answered
  204; drained by the render loop via :meth:`PreviewServer.pop_camera`.

Binds 127.0.0.1 by default (frames should not be exposed on all interfaces
of a shared host unauthenticated); pass ``host="0.0.0.0"`` / the CLI's
``--serve-host`` to opt in to external access.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["PreviewServer"]

_PAGE = b"""<!doctype html>
<html><head><title>brickmap-tpu live preview</title>
<style>
 body { background:#111; color:#ddd; font-family:monospace; margin:1em; }
 img  { max-width:100%; image-rendering:pixelated; border:1px solid #333; }
 #stats { margin:0.5em 0; white-space:pre; }
 #help { color:#777; margin:0.5em 0; }
</style></head><body>
<div id="stats">waiting for first frame...</div>
<img id="frame" src="/frame.png">
<div id="help">fly: WASD move &#183; R/F up/down &#183; arrows look &#183;
shift = 10x &#183; (click page first)</div>
<script>
 async function tick() {
   try {
     const r = await fetch('/stats.json', {cache: 'no-store'});
     const s = await r.json();
     document.getElementById('stats').textContent =
       Object.entries(s).map(([k, v]) => k + ': ' + v).join('   ');
     if (s.frame_seq !== window._seq) {
       window._seq = s.frame_seq;
       document.getElementById('frame').src = '/frame.png?' + s.frame_seq;
     }
   } catch (e) {}
   setTimeout(tick, 500);
 }
 tick();
 // Fly-camera input: keys accumulate move/rot deltas, flushed at 10 Hz.
 const held = {};
 window.addEventListener('keydown', e => { held[e.key.toLowerCase()] = true;
   if (e.key.startsWith('Arrow')) e.preventDefault(); });
 window.addEventListener('keyup', e => { held[e.key.toLowerCase()] = false; });
 let acc = {move: [0,0,0], rot: [0,0]};
 setInterval(() => {
   const sp = (held['shift'] ? 10 : 1) * 0.1;
   if (held['w']) acc.move[0] += sp;
   if (held['s']) acc.move[0] -= sp;
   if (held['d']) acc.move[1] += sp;
   if (held['a']) acc.move[1] -= sp;
   if (held['r']) acc.move[2] += sp;
   if (held['f']) acc.move[2] -= sp;
   if (held['arrowleft'])  acc.rot[0] -= 0.05;
   if (held['arrowright']) acc.rot[0] += 0.05;
   if (held['arrowup'])    acc.rot[1] += 0.05;
   if (held['arrowdown'])  acc.rot[1] -= 0.05;
 }, 50);
 setInterval(() => {
   if (acc.move.some(v => v) || acc.rot.some(v => v)) {
     fetch('/camera', {method: 'POST', body: JSON.stringify(acc)});
     acc = {move: [0,0,0], rot: [0,0]};
   }
 }, 100);
</script></body></html>
"""


class PreviewServer:
    """Background HTTP server showing the latest pushed frame.

    ``update(img, **stats)`` is called from the render loop with a uint8
    [H, W, 3] image (or float in [0, 1]) and keeps it as it is, not a copy:
    hand over an array the caller no longer writes.  ``GET /frame.png``
    encodes the latest image, once for each ``frame_seq``, on the serving
    thread, and keeps the bytes for later fetches of the same frame.
    Serving runs on daemon threads.  ``pop_camera()`` drains input deltas
    POSTed by the page since the last call.
    """

    def __init__(self, port: int, host: str = "127.0.0.1"):
        from .image import encode_png

        self._encode = encode_png
        self._lock = threading.Lock()
        self._encoding = threading.Lock()   # one encode of a frame at once
        self._img = None
        self._png = (0, b"")                # (frame_seq, PNG bytes)
        self._stats: dict = {"frame_seq": 0}
        self._cam = {"move": [0.0, 0.0, 0.0], "rot": [0.0, 0.0]}
        self._cam_dirty = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                path = self.path.split("?")[0]
                if path == "/":
                    body, ctype = _PAGE, "text/html"
                elif path == "/frame.png":
                    body = outer._frame_png()
                    ctype = "image/png"
                    if not body:
                        self.send_response(404)
                        self.end_headers()
                        return
                elif path == "/stats.json":
                    with outer._lock:
                        body = json.dumps(outer._stats).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 (stdlib API name)
                path = self.path.split("?")[0]
                if path != "/camera":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    d = json.loads(self.rfile.read(n) or b"{}")
                    move = [float(v) for v in d.get("move", [0, 0, 0])][:3]
                    rot = [float(v) for v in d.get("rot", [0, 0])][:2]
                except (ValueError, TypeError):
                    self.send_response(400)
                    self.end_headers()
                    return
                with outer._lock:
                    for i in range(3):
                        outer._cam["move"][i] += move[i]
                    for i in range(2):
                        outer._cam["rot"][i] += rot[i]
                    outer._cam_dirty = True
                self.send_response(204)
                self.end_headers()

            def log_message(self, *a):  # quiet: no per-request stderr spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]   # resolved (port=0 ok)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def update(self, img, **stats) -> None:
        """Keep ``img`` as the latest frame with its ``stats``; encodes
        nothing."""
        with self._lock:
            self._img = img
            seq = self._stats.get("frame_seq", 0) + 1
            self._stats = {**stats, "frame_seq": seq}

    def _frame_png(self) -> bytes:
        """The latest frame's PNG (b"" before the first), encoded at the
        first fetch of its ``frame_seq`` and kept for the next."""
        with self._encoding:
            with self._lock:
                img, seq = self._img, self._stats["frame_seq"]
                if img is None or self._png[0] == seq:
                    return self._png[1]
            png = self._encode(img)
            with self._lock:
                self._png = (seq, png)
            return png

    def pop_camera(self) -> dict | None:
        """Drain accumulated input deltas: ``{"move": [fwd, right, up],
        "rot": [dyaw, dpitch]}`` or None if no input arrived."""
        with self._lock:
            if not self._cam_dirty:
                return None
            out = {"move": list(self._cam["move"]),
                   "rot": list(self._cam["rot"])}
            self._cam = {"move": [0.0, 0.0, 0.0], "rot": [0.0, 0.0]}
            self._cam_dirty = False
        return out

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
