# forge3d_tpu/vector — GPU-equivalent vector overlay engine.
#
# Parity notes: the reference's vector module renders AA polylines,
# tessellated polygons, instanced points and OIT compositing through wgpu
# pipelines (the reference's src/vector/, SURVEY §2.4). This build
# evaluates analytic coverage per pixel (vector/coverage.py) and composites
# in linear color — same public add_points/add_lines/add_polygons/
# clear_vectors + render seam (src/py_functions/vector/*).

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .coverage import (  # noqa: F401
    composite_over,
    disc_coverage,
    oit_composite,
    polygon_coverage,
    stroke_coverage,
)


@dataclass
class _Layer:
    kind: str           # points|lines|polygons
    data: object
    color: Tuple[float, float, float]
    opacity: float
    width: float = 1.0  # stroke width / point radius
    pick_id: int = 0


def _dash_segments(pl: np.ndarray, dash: List[float]) -> np.ndarray:
    """Split a polyline into on-dash segments by arclength.

    dash = [on, off, on, off, ...] pixel lengths, cycled; the pattern
    phase runs continuously along the whole polyline."""
    period = float(sum(dash))
    if period <= 0:
        return np.concatenate([pl[:-1], pl[1:]], axis=1)
    # prefix pattern: intervals [start, end) that are "on" within a period
    ons = []
    acc = 0.0
    for i, d in enumerate(dash):
        if i % 2 == 0 and d > 0:
            ons.append((acc, acc + d))
        acc += d
    out = []
    s = 0.0                                   # arclength at segment start
    for a, b in zip(pl[:-1], pl[1:]):
        seg_len = float(np.hypot(*(b - a)))
        if seg_len <= 1e-9:
            continue
        dirv = (b - a) / seg_len
        # walk the dash pattern across this segment
        pos = 0.0
        while pos < seg_len - 1e-9:
            phase = (s + pos) % period
            # find the on-interval containing/after the phase
            nxt = None
            for o0, o1 in ons:
                if phase < o1:
                    nxt = (max(phase, o0), o1)
                    break
            if nxt is None:                   # rest of period is off
                pos += period - phase
                continue
            o0, o1 = nxt
            if phase < o0:                    # skip the off gap
                pos += o0 - phase
                phase = o0
            run = min(o1 - phase, seg_len - pos)
            p0 = a + dirv * pos
            p1 = a + dirv * (pos + run)
            out.append([p0[0], p0[1], p1[0], p1[1]])
            pos += run
        s += seg_len
    if not out:
        return np.zeros((0, 4), np.float32)
    return np.asarray(out, np.float32)


@dataclass
class VectorScene:
    """Retained vector overlay scene; render() produces an RGBA overlay and
    a pick-id map (reference: vector_render_oit_and_pick_py)."""

    layers: List[_Layer] = field(default_factory=list)
    _next_pick: int = 1

    def add_points(self, points, color=(1.0, 0.2, 0.1), size: float = 4.0,
                   opacity: float = 1.0) -> int:
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        pid = self._next_pick
        self._next_pick += 1
        self.layers.append(_Layer("points", pts, tuple(color), float(opacity),
                                  float(size), pid))
        return pid

    def add_lines(self, polyline, color=(0.1, 0.3, 0.9), width: float = 2.0,
                  opacity: float = 1.0, dash_array=None) -> int:
        """Add an AA polyline. dash_array=[on_px, off_px, ...] splits the
        stroke into dash segments by arclength (reference: the Mapbox GL
        line-dasharray semantics the CPU vector compositor honors)."""
        pl = np.asarray(polyline, np.float32).reshape(-1, 2)
        if len(pl) < 2:
            raise ValueError("polyline needs >= 2 vertices")
        segs = np.concatenate([pl[:-1], pl[1:]], axis=1)
        if dash_array:
            segs = _dash_segments(pl, [float(d) for d in dash_array])
        pid = self._next_pick
        self._next_pick += 1
        self.layers.append(_Layer("lines", segs, tuple(color), float(opacity),
                                  float(width), pid))
        return pid

    def add_polygons(self, rings, color=(0.2, 0.7, 0.3), opacity: float = 1.0) -> int:
        rings = [np.asarray(r, np.float32).reshape(-1, 2) for r in rings]
        pid = self._next_pick
        self._next_pick += 1
        self.layers.append(_Layer("polygons", rings, tuple(color),
                                  float(opacity), 0.0, pid))
        return pid

    def clear_vectors(self) -> None:
        self.layers.clear()
        self._next_pick = 1

    def _layer_coverage(self, layer: _Layer, width: int, height: int):
        if layer.kind == "points":
            return disc_coverage(width, height, layer.data,
                                 np.full(len(layer.data), layer.width * 0.5))
        if layer.kind == "lines":
            return stroke_coverage(width, height, layer.data, layer.width)
        return polygon_coverage(width, height, layer.data)

    def render(self, width: int, height: int,
               base_rgb: Optional[np.ndarray] = None):
        """Composite all layers. Returns (rgb (H,W,3) f32, alpha (H,W) f32,
        pick (H,W) int32)."""
        import jax.numpy as jnp

        rgb = (jnp.zeros((height, width, 3), jnp.float32)
               if base_rgb is None else jnp.asarray(base_rgb, jnp.float32))
        alpha = jnp.zeros((height, width), jnp.float32)
        pick = jnp.zeros((height, width), jnp.int32)
        for layer in self.layers:
            cov = self._layer_coverage(layer, width, height)
            a = cov * layer.opacity
            rgb = rgb * (1.0 - a[..., None]) + jnp.asarray(layer.color) * a[..., None]
            alpha = alpha + a * (1.0 - alpha)
            pick = jnp.where(cov > 0.5, layer.pick_id, pick)
        return np.asarray(rgb), np.asarray(alpha), np.asarray(pick)

    def pick_at(self, pick_map: np.ndarray, x: int, y: int) -> int:
        return int(pick_map[int(y), int(x)])


def render_overlay_rgba(scene: VectorScene, width: int, height: int) -> np.ndarray:
    """Overlay as straight-alpha RGBA float32 (H, W, 4)."""
    rgb, alpha, _ = scene.render(width, height)
    safe = np.maximum(alpha, 1e-6)[..., None]
    straight = np.where(alpha[..., None] > 0, rgb / safe, 0.0)
    return np.concatenate([straight, alpha[..., None]], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# Flat functional render surface (reference py_functions/vector parity:
# vector_render_oit_py / vector_render_oit_edl_py — width/height + point
# and polyline payloads -> RGBA u8 overlay; the MapScene point-cloud
# compositor drives exactly this contract).
# ---------------------------------------------------------------------------

def _scene_from_payload(points_xy=None, point_rgba=None, point_size=None,
                        polylines=None, polyline_rgba=None,
                        stroke_width=None) -> "VectorScene":
    vs = VectorScene()
    if points_xy:
        pts = np.asarray(points_xy, np.float64)
        rgba = list(point_rgba or [])
        sizes = list(point_size or [])
        for i in range(len(pts)):
            c = rgba[i] if i < len(rgba) else (1.0, 0.4, 0.1, 1.0)
            s = sizes[i] if i < len(sizes) else 4.0
            vs.add_points(pts[i:i + 1], color=tuple(c[:3]),
                          size=float(s), opacity=float(c[3]) if len(c) > 3
                          else 1.0)
    for k, pl in enumerate(polylines or ()):
        c = (polyline_rgba[k] if polyline_rgba and k < len(polyline_rgba)
             else (0.9, 0.9, 0.9, 1.0))
        w = (stroke_width[k] if stroke_width and k < len(stroke_width)
             else 2.0)
        vs.add_lines(np.asarray(pl, np.float64), color=tuple(c[:3]),
                     width=float(w),
                     opacity=float(c[3]) if len(c) > 3 else 1.0)
    return vs


def vector_render_oit(width: int, height: int, *, points_xy=None,
                      point_rgba=None, point_size=None, polylines=None,
                      polyline_rgba=None, stroke_width=None) -> np.ndarray:
    """Order-independent composite of points + polylines -> RGBA u8."""
    vs = _scene_from_payload(points_xy, point_rgba, point_size,
                             polylines, polyline_rgba, stroke_width)
    over = render_overlay_rgba(vs, width, height)
    return (np.clip(over, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def vector_render_oit_edl(width: int, height: int, *, edl_strength=1.5,
                          edl_radius_px=1.0, **payload) -> np.ndarray:
    """OIT render with eye-dome-lighting: isolated splats darken by the
    local alpha falloff (reference EDL point shading)."""
    vs = _scene_from_payload(**payload)
    rgb, alpha, _ = vs.render(width, height)
    r = max(int(round(edl_radius_px)), 1)
    pad = np.pad(alpha, r, mode="edge")
    neigh = np.zeros_like(alpha)
    for dy, dx in ((-r, 0), (r, 0), (0, -r), (0, r)):
        neigh += pad[r + dy:r + dy + alpha.shape[0],
                     r + dx:r + dx + alpha.shape[1]]
    occl = np.clip((alpha - neigh / 4.0) * float(edl_strength), 0.0, 1.0)
    rgb = rgb * (1.0 - occl[..., None])
    safe = np.maximum(alpha, 1e-6)[..., None]
    straight = np.where(alpha[..., None] > 0, rgb / safe, 0.0)
    out = np.concatenate([straight, alpha[..., None]], axis=-1)
    return (np.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def vector_render_pick_map(width: int, height: int, **payload) -> np.ndarray:
    """Pick-ID map of the payload (0 = background)."""
    vs = _scene_from_payload(**payload)
    _, _, pick = vs.render(width, height)
    return pick


def vector_render_oit_and_pick(width: int, height: int, **payload):
    vs = _scene_from_payload(**payload)
    rgb, alpha, pick = vs.render(width, height)
    safe = np.maximum(alpha, 1e-6)[..., None]
    straight = np.where(alpha[..., None] > 0, rgb / safe, 0.0)
    rgba = np.concatenate([straight, alpha[..., None]], axis=-1)
    return ((np.clip(rgba, 0, 1) * 255 + 0.5).astype(np.uint8), pick)
