# Tests for the browser-backed viewer window (forge3d_tpu/viewer/window.py).
#
# Parity notes: the reference viewer opens a winit window with a 60 FPS
# event loop, orbit input and a HUD (src/viewer/event_loop/runner.rs:58-89,
# src/viewer/hud.rs). This build serves the same loop over HTTP; these
# tests drive the endpoints exactly as the browser page does.

import io
import urllib.request

import numpy as np
import pytest

from forge3d_tpu.viewer.window import ViewerWindow


@pytest.fixture(scope="module")
def window():
    w = ViewerWindow(fps=5.0).start()
    yield w
    w.close()


def _get(window, path):
    with urllib.request.urlopen(window.url.rstrip("/") + path, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_window_page_served(window):
    status, ctype, body = _get(window, "/")
    assert status == 200 and "text/html" in ctype
    assert b"/stream" in body and b"/input" in body


def test_frame_png_endpoint(window):
    status, ctype, body = _get(window, "/frame.png")
    assert status == 200 and ctype == "image/png"
    from forge3d_tpu.io.png import decode_png

    frame = decode_png(body)
    assert frame.ndim == 3 and frame.shape[2] in (3, 4)
    assert frame.size > 0


def test_input_orbits_camera(window):
    cam = window.server.state.cam
    phi0, theta0, r0 = cam["phi_deg"], cam["theta_deg"], cam["radius"]
    status, _, _ = _get(window, "/input?dphi=10&dtheta=-5&dradius=1.1")
    assert status == 204
    assert cam["phi_deg"] == pytest.approx((phi0 + 10.0) % 360.0)
    assert cam["theta_deg"] == pytest.approx(
        float(np.clip(theta0 - 5.0, 2.0, 88.0)))
    assert cam["radius"] == pytest.approx(r0 * 1.1)


def test_theta_clamped_to_valid_orbit(window):
    _get(window, "/input?dtheta=-500")
    assert window.server.state.cam["theta_deg"] == 2.0
    _get(window, "/input?dtheta=500")
    assert window.server.state.cam["theta_deg"] == 88.0


def test_hud_toggle_changes_frame(window):
    window.hud_enabled = True
    window._dirty.set()
    _, _, with_hud = _get(window, "/frame.png")
    _get(window, "/input?hud=off")
    assert window.hud_enabled is False
    _, _, without = _get(window, "/frame.png")
    assert with_hud != without
    _get(window, "/input?hud=toggle")
    assert window.hud_enabled is True


def test_input_invalidates_frame_cache(window):
    _, _, a = _get(window, "/frame.png")
    _, _, b = _get(window, "/frame.png")
    assert a == b  # no input between fetches -> cached bytes
    _get(window, "/input?dphi=30")
    _, _, c = _get(window, "/frame.png")
    assert c != b


def test_stream_yields_multipart_frames(window):
    req = urllib.request.urlopen(window.url.rstrip("/") + "/stream",
                                 timeout=10)
    try:
        ctype = req.headers.get("Content-Type", "")
        assert "multipart/x-mixed-replace" in ctype
        chunk = req.read(64)
        assert b"--f3dframe" in chunk
    finally:
        req.close()


def test_unknown_path_404(window):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(window, "/nope")
    assert exc.value.code == 404
