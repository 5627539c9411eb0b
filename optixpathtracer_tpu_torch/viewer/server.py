"""Interactive web viewer (port of optixpathtracer_tpu/viewer/server.py): the
display stack for a renderer on a machine without a display.

Frames stream to a browser over HTTP as multipart JPEG (MJPEG), encoded by
the port's own `io.image.encode_jpeg` (no image library), and pointer
events come back: a drag orbits the trackball, the wheel zooms, and the
cursor position sets the foveated renderer's gaze. Routes: `/` (the page),
`/stats` (the renderer's stats as JSON), `/event`, `/frame.jpg` (the latest
frame) and `/stream` (every new frame, multipart). Standard library HTTP.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..core.camera import Trackball
from ..io.image import encode_jpeg

_PAGE = """<!doctype html>
<html><head><title>optixpathtracer_tpu_torch</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace}
#wrap{display:flex;gap:12px;padding:10px}
img{image-rendering:pixelated;cursor:crosshair;border:1px solid #333}
#stats{white-space:pre}
</style></head><body><div id="wrap">
<img id="view" src="/stream">
<div id="stats">connecting...</div></div>
<script>
const img = document.getElementById('view');
let drag = false, btn = 0;
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('mousedown', e => {drag = true; btn = e.button;
  fetch(`/event?type=down&x=${e.offsetX}&y=${e.offsetY}&b=${btn}`);});
window.addEventListener('mouseup', () => {drag = false;});
img.addEventListener('mousemove', e => {
  fetch(`/event?type=move&x=${e.offsetX}&y=${e.offsetY}&b=${drag ? btn : -1}`);});
img.addEventListener('wheel', e => {e.preventDefault();
  fetch(`/event?type=wheel&d=${e.deltaY > 0 ? -1 : 1}`);});
setInterval(async () => {
  const r = await fetch('/stats');
  document.getElementById('stats').textContent = JSON.stringify(await r.json(), null, 2);
}, 500);
</script></body></html>"""


class ViewerServer:
    """Streams a renderer's frames; feeds pointer events to camera and gaze."""

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8000,
                 trackball=None, jpeg_quality: int = 85):
        self.renderer = renderer
        self.trackball = trackball
        self._frame_lock = threading.Lock()
        self._frame_bytes: bytes | None = None
        self._running = False
        self.host, self.port = host, port
        self.jpeg_quality = jpeg_quality
        self._httpd: ThreadingHTTPServer | None = None
        self.camera_changed = False

    # -- frame publication (called from the render loop) -------------------
    def publish(self, frame) -> None:
        """Encode a frame ((H, W, 3|4) numpy array, as `render()` returns
        it, or a tensor on any device; uint8 or float in [0, 1]) as the
        JPEG that `/frame.jpg` and `/stream` serve."""
        data = encode_jpeg(frame, self.jpeg_quality)
        with self._frame_lock:
            self._frame_bytes = data

    # -- event plumbing -----------------------------------------------------
    def _on_event(self, q: dict) -> None:
        typ = q.get("type", [""])[0]
        if typ == "wheel" and self.trackball is not None:
            self.trackball.zoom(int(q.get("d", ["1"])[0]))
            self.camera_changed = True
        elif typ in ("down", "move"):
            x = int(q.get("x", ["0"])[0])
            y = int(q.get("y", ["0"])[0])
            b = int(q.get("b", ["-1"])[0])
            if hasattr(self.renderer, "set_gaze"):
                self.renderer.set_gaze(x, y)  # the gaze follows the cursor (sv4)
            if self.trackball is not None:
                if typ == "down":
                    self.trackball.start_tracking(x, y)
                elif b == 0:
                    self.trackball.update_tracking(
                        x, y, self.renderer.config.width, self.renderer.config.height)
                    self.camera_changed = True

    def _stats(self) -> dict:
        try:
            return self.renderer.stats()
        except Exception:  # noqa: BLE001 — the page polls it; a failed read shows {}
            return {}

    # -- server -------------------------------------------------------------
    def start(self) -> None:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def _send(self, body: bytes, kind: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", kind)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                elif u.path == "/stats":
                    self._send(json.dumps(viewer._stats()).encode(), "application/json")
                elif u.path == "/event":
                    viewer._on_event(parse_qs(u.query))
                    self.send_response(204)
                    self.end_headers()
                elif u.path == "/frame.jpg":
                    with viewer._frame_lock:
                        data = viewer._frame_bytes
                    if data is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self._send(data, "image/jpeg")
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    try:
                        last = None
                        while viewer._running:
                            with viewer._frame_lock:
                                data = viewer._frame_bytes
                            if data is not None and data is not last:
                                self.wfile.write(b"--frame\r\n")
                                self.wfile.write(b"Content-Type: image/jpeg\r\n")
                                self.wfile.write(f"Content-Length: {len(data)}\r\n\r\n".encode())
                                self.wfile.write(data)
                                self.wfile.write(b"\r\n")
                                last = data
                            time.sleep(0.03)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

        self._running = True
        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._running = False
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def run_interactive(renderer, camera, host="127.0.0.1", port=8000, max_frames=None) -> ViewerServer:
    """Render loop (main.cpp:253-289): render -> publish -> apply camera
    changes, which restart the accumulation. The trackball is gimbal-locked
    to the frame (1,0,0), (0,0,1), (0,1,0). A failure to render or to
    encode ends the loop with its exception; the server stops either way."""
    tb = Trackball(camera)
    tb.set_reference_frame((1, 0, 0), (0, 0, 1), (0, 1, 0))
    tb.gimbal_lock = True
    server = ViewerServer(renderer, host, port, trackball=tb)
    server.start()
    print(f"viewer at http://{server.host}:{server.port}/", flush=True)
    frames = 0
    try:
        while max_frames is None or frames < max_frames:
            if server.camera_changed:
                server.camera_changed = False
                renderer.set_camera(camera)  # resets accumulation
            frame = renderer.render()
            server.publish(frame)
            frames += 1
    finally:
        server.stop()
    return server
