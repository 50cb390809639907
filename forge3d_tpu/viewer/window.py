# forge3d_tpu/viewer/window.py — the interactive viewer window.
#
# Parity notes (reference behavior, not code): the reference's viewer
# opens a winit OS window with a 60 FPS event loop, orbit-drag camera
# input and an on-frame HUD (src/viewer/event_loop/runner.rs:58-89,
# src/viewer/hud.rs, src/viewer/input/). A render node is headless —
# the display belongs to the client — so this build's "window" is an
# HTTP surface: any browser is the swapchain. It serves
#   GET /            the window page (live <img>, drag-orbit, wheel zoom)
#   GET /frame.png   the current frame with the HUD burned in
#   GET /stream      multipart/x-mixed-replace live stream of frames
#   GET /input?...   orbit/zoom deltas (dphi/dtheta/dradius) + HUD toggle
# on top of the same ViewerServer state the IPC protocol drives, so the
# window and the IPC client always show the same scene. The HUD mirrors
# the reference's: fps, frame count, camera phi/theta/radius, resolution
# and memory, rendered with the packaged-font text engine.

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

__all__ = ["ViewerWindow"]

_PAGE = """<!doctype html>
<html><head><title>forge3d_tpu viewer</title>
<style>body{margin:0;background:#10141c;display:grid;place-items:center;
height:100vh}img{image-rendering:pixelated;cursor:grab}</style></head>
<body><img id="v" src="/stream" draggable="false">
<script>
const v = document.getElementById('v');
let drag = null;
v.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  fetch(`/input?dphi=${dx * 0.5}&dtheta=${-dy * 0.5}`);
});
v.addEventListener('wheel', e => {
  e.preventDefault();
  fetch(`/input?dradius=${e.deltaY > 0 ? 1.1 : 0.9}`);
}, {passive: false});
window.addEventListener('keydown', e => {
  if (e.key === 'h') fetch('/input?hud=toggle');
});
</script></body></html>"""


class ViewerWindow:
    """Browser-backed interactive window over a ViewerServer."""

    def __init__(self, server=None, *, host: str = "127.0.0.1",
                 port: int = 0, fps: float = 30.0):
        if server is None:
            from .server import ViewerServer

            server = ViewerServer()
        self.server = server
        self.fps = float(fps)
        self.hud_enabled = True
        self._frame_count = 0
        self._fps_est = 0.0
        self._dirty = threading.Event()
        self._dirty.set()
        self._stop = threading.Event()
        self._frame_lock = threading.Lock()
        self._frame_png: Optional[bytes] = None

        window = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/frame.png":
                    body = window.frame_png()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=f3dframe")
                    self.end_headers()
                    try:
                        while not window._stop.is_set():
                            body = window.frame_png()
                            self.wfile.write(b"--f3dframe\r\n"
                                             b"Content-Type: image/png\r\n"
                                             b"\r\n" + body + b"\r\n")
                            time.sleep(1.0 / max(window.fps, 1.0))
                    except (BrokenPipeError, ConnectionResetError):
                        return
                elif url.path == "/input":
                    q = parse_qs(url.query)
                    window.apply_input(
                        dphi=float(q.get("dphi", [0.0])[0]),
                        dtheta=float(q.get("dtheta", [0.0])[0]),
                        dradius=float(q.get("dradius", [1.0])[0]),
                        hud=q.get("hud", [None])[0])
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        self._http = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._http.server_address
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ViewerWindow":
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._http.shutdown()
        self._http.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    # -- input ----------------------------------------------------------------
    def apply_input(self, *, dphi: float = 0.0, dtheta: float = 0.0,
                    dradius: float = 1.0, hud=None) -> None:
        cam = self.server.state.cam
        cam["phi_deg"] = (cam["phi_deg"] + dphi) % 360.0
        cam["theta_deg"] = float(np.clip(cam["theta_deg"] + dtheta,
                                         2.0, 88.0))
        cam["radius"] = float(np.clip(cam["radius"] * dradius, 1e-2, 1e7))
        if hud == "toggle":
            self.hud_enabled = not self.hud_enabled
        elif hud in ("on", "off"):
            self.hud_enabled = hud == "on"
        self._dirty.set()

    # -- frames ----------------------------------------------------------------
    def render(self) -> np.ndarray:
        t0 = time.perf_counter()
        frame = self.server.render_frame().copy()
        dt = max(time.perf_counter() - t0, 1e-6)
        self._fps_est = 0.8 * self._fps_est + 0.2 * (1.0 / dt) \
            if self._fps_est else 1.0 / dt
        self._frame_count += 1
        if self.hud_enabled:
            self._draw_hud(frame)
        return frame

    def frame_png(self) -> bytes:
        """Current frame as PNG bytes (renders only when dirty)."""
        if self._dirty.is_set() or self._frame_png is None:
            self._dirty.clear()
            frame = self.render()
            from ..io.png import encode_png

            with self._frame_lock:
                self._frame_png = encode_png(frame)
        with self._frame_lock:
            return self._frame_png

    def _draw_hud(self, frame: np.ndarray) -> None:
        """The reference HUD's fields: fps, frames, camera orbit, size,
        memory (src/viewer/hud.rs)."""
        from ..labels.font import draw_shaped_text
        from ..mem import global_tracker

        s = self.server.state
        mem_mb = global_tracker().metrics().get("used_bytes", 0) \
            / (1024 * 1024)
        lines = [
            f"forge3d_tpu viewer  {frame.shape[1]}x{frame.shape[0]}",
            f"fps {self._fps_est:5.1f}   frame {self._frame_count}",
            (f"cam phi {s.cam['phi_deg']:.1f}  theta "
             f"{s.cam['theta_deg']:.1f}  r {s.cam['radius']:.1f}"),
            f"mem {mem_mb:.1f} MiB   [h] hud",
        ]
        y = 6
        for text in lines:
            draw_shaped_text(frame, text, (8, y),
                             color=(235, 240, 245, 255),
                             halo=(10, 12, 16, 220), halo_width_px=1.0,
                             font_size=11.0)
            y += 14
