# forge3d_tpu/viewer — interactive viewer client (ViewerHandle +
# open_viewer_async).
#
# Parity notes (reference behavior, not code):
# /root/reference/python/forge3d/{viewer.py,viewer_ipc.py} launch the
# viewer binary as a subprocess, wait for "FORGE3D_VIEWER_READY port=N" on
# stdout, then open a TCP socket per command sending one JSON object per
# line. The same contract holds here with `python -m forge3d_tpu.viewer`
# as the server process.

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

from ..errors import RenderError

__all__ = ["ViewerHandle", "open_viewer_async", "ViewerError"]

_READY_PATTERN = re.compile(r"FORGE3D_VIEWER_READY port=(\d+)")


class ViewerError(RenderError):
    pass


class ViewerHandle:
    """Client for a running viewer process (socket per command)."""

    def __init__(self, port: int, process: Optional[subprocess.Popen] = None,
                 host: str = "127.0.0.1", timeout: float = 60.0):
        self.port = int(port)
        self.host = host
        self.timeout = float(timeout)
        self._process = process
        self._closed = False

    # ------------------------------------------------------------- plumbing
    def send(self, cmd: str, **fields) -> dict:
        """Send one command; returns the server's response dict (raises
        ViewerError when ok=False)."""
        if self._closed:
            raise ViewerError("viewer handle is closed")
        req = {"cmd": cmd, **fields}
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout) as sock:
            sock.sendall(json.dumps(req).encode() + b"\n")
            buf = b""
            while b"\n" not in buf:
                chunk = sock.recv(1 << 20)
                if not chunk:
                    raise ViewerError("viewer closed the connection")
                buf += chunk
        resp = json.loads(buf.split(b"\n", 1)[0])
        if not resp.get("ok"):
            raise ViewerError(resp.get("error", "viewer command failed"))
        return resp

    def close(self) -> None:
        if self._closed:
            return
        try:
            self.send("close")
        except (ViewerError, OSError):
            pass
        self._closed = True
        if self._process is not None:
            try:
                self._process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._process.kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- commands
    def snapshot(self, path, width: Optional[int] = None,
                 height: Optional[int] = None, *, poll_timeout: float = 120.0):
        fields = {"path": str(path)}
        if width:
            fields["width"] = int(width)
        if height:
            fields["height"] = int(height)
        resp = self.send("snapshot", **fields)
        # reference clients poll for the file; the server already wrote it,
        # but keep the poll for contract parity with slow filesystems
        deadline = time.monotonic() + poll_timeout
        while not Path(str(path)).exists():
            if time.monotonic() > deadline:
                raise ViewerError(f"snapshot not written: {path}")
            time.sleep(0.05)
        return resp

    def set_orbit_camera(self, target=None, radius=None, phi_deg=None,
                         theta_deg=None, fov_y_deg=None) -> dict:
        fields = {}
        if target is not None:
            fields["target"] = [float(v) for v in target]
        for k, v in (("radius", radius), ("phi_deg", phi_deg),
                     ("theta_deg", theta_deg), ("fov_y_deg", fov_y_deg)):
            if v is not None:
                fields[k] = float(v)
        return self.send("set_terrain_camera", **fields)

    def cam_lookat(self, eye, target) -> dict:
        return self.send("cam_lookat", eye=list(map(float, eye)),
                         target=list(map(float, target)))

    def set_sun(self, azimuth_deg=None, elevation_deg=None, intensity=None):
        fields = {k: float(v) for k, v in (
            ("azimuth_deg", azimuth_deg), ("elevation_deg", elevation_deg),
            ("intensity", intensity)) if v is not None}
        return self.send("set_terrain_sun", **fields)

    def set_z_scale(self, value: float) -> dict:
        return self.send("set_z_scale", value=float(value))

    def set_terrain(self, heights, span: Optional[float] = None) -> dict:
        import numpy as np

        arr = np.asarray(heights, np.float32)
        fields = {"heights": arr.tolist()}
        if span is not None:
            fields["span"] = float(span)
        return self.send("set_terrain", **fields)

    def load_terrain(self, path) -> dict:
        return self.send("load_terrain", path=str(path))

    def load_obj(self, path, name: Optional[str] = None) -> dict:
        fields = {"path": str(path)}
        if name:
            fields["name"] = name
        return self.send("load_obj", **fields)

    def add_label(self, text: str, x: float, y: float, **kw) -> int:
        return int(self.send("add_label", text=text, x=x, y=y, **kw)["id"])

    def remove_label(self, label_id: int) -> dict:
        return self.send("remove_label", id=int(label_id))

    def clear_labels(self) -> dict:
        return self.send("clear_labels")

    def set_declutter_algorithm(self, algorithm: str) -> dict:
        return self.send("set_declutter_algorithm", algorithm=algorithm)

    def pick_at(self, x: float, y: float) -> dict:
        return self.send("pick_at", x=float(x), y=float(y))

    def get_stats(self) -> dict:
        return self.send("get_stats")["stats"]

    def save_bundle(self, path) -> dict:
        return self.send("save_bundle", path=str(path))

    def load_bundle(self, path) -> dict:
        return self.send("load_bundle", path=str(path))


def _holds_gpu() -> bool:
    """True when this process has already opened a JAX GPU backend. JAX
    reserves most of a card's memory when it opens it, so a second JAX
    process that opens the same card fails for want of memory."""
    if "jax" not in sys.modules:
        return False
    from jax._src import xla_bridge

    if not xla_bridge.backends_are_initialized():
        return False
    import jax

    return any(d.platform == "gpu" for d in jax.devices())


def _child_may_open_gpu(env: dict) -> bool:
    """Whether a JAX child process started with `env` would reserve the
    usual share of a GPU (no platform restriction away from the GPU and
    no explicit memory fraction)."""
    if "XLA_PYTHON_CLIENT_MEM_FRACTION" in env:
        return False
    platforms = [p for p in env.get("JAX_PLATFORMS", "").split(",") if p]
    return not platforms or any(p in ("cuda", "gpu") for p in platforms)


def open_viewer_async(*, terrain_path=None, width: int = 1024,
                      height: int = 768, timeout: float = 120.0,
                      env: Optional[dict] = None) -> ViewerHandle:
    """Launch the viewer server process and return a connected handle
    (reference seam: open_viewer_async, viewer.py:1363).

    The viewer is a second JAX process. If this process already holds the
    GPU, the launch is refused with a ViewerError unless `env` keeps the
    viewer off the card (JAX_PLATFORMS=cpu) or gives it its own share
    (XLA_PYTHON_CLIENT_MEM_FRACTION)."""
    cmd = [sys.executable, "-m", "forge3d_tpu.viewer",
           "--width", str(width), "--height", str(height)]
    proc_env = dict(os.environ)
    if env:
        proc_env.update(env)
    if _child_may_open_gpu(proc_env) and _holds_gpu():
        raise ViewerError(
            "this process already holds the GPU through JAX, which "
            "reserves most of the card's memory; a viewer process opening "
            "the same card would fail for want of device memory. Open the "
            "viewer before any JAX work, or pass env={'JAX_PLATFORMS': "
            "'cpu'} or an XLA_PYTHON_CLIENT_MEM_FRACTION share for it.")
    # the package must be importable in the child
    repo_root = str(Path(__file__).resolve().parents[2])
    proc_env["PYTHONPATH"] = repo_root + os.pathsep + proc_env.get("PYTHONPATH", "")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            env=proc_env)
    deadline = time.monotonic() + timeout
    port = None
    assert proc.stdout is not None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise ViewerError(
                    f"viewer process exited with code {proc.returncode}")
            time.sleep(0.01)
            continue
        m = _READY_PATTERN.search(line)
        if m:
            port = int(m.group(1))
            break
    if port is None:
        proc.kill()
        raise ViewerError("viewer did not become ready in time")
    handle = ViewerHandle(port, process=proc)
    if terrain_path is not None:
        handle.load_terrain(terrain_path)
    return handle
