# forge3d_tpu/labels/render.py
# SDF text compositing: atlas sample -> smoothstep coverage -> RGBA, with
# halo/outline, rotation (curved/line labels), and overlay composition.
#
# Parity notes (reference behavior, not code): the reference renders MSDF
# text in a screen-space pass with halo + depth occlusion + horizon fade
# (src/labels/mod.rs:1-12, text_overlay.wgsl). Here: labels are
# composited host-side (numpy) onto the rendered frame — label counts are
# small (thousands), so per-glyph bilinear SDF sampling is cheap and keeps
# the hot device path free of irregular work.

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .atlas import GlyphAtlas
from .shape import ShapedRun, text_shape

__all__ = ["draw_text_rgba", "draw_text_along_path",
           "render_label_overlay"]


def _sample_sdf(atlas_img: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                fill: float) -> np.ndarray:
    """Bilinear sample with border fill."""
    H, W = atlas_img.shape
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx = xs - x0
    fy = ys - y0

    def tap(xi, yi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = atlas_img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
        return np.where(ok, v, fill)

    return ((1 - fx) * (1 - fy) * tap(x0, y0) + fx * (1 - fy) * tap(x0 + 1, y0)
            + (1 - fx) * fy * tap(x0, y0 + 1) + fx * fy * tap(x0 + 1, y0 + 1))


def _smoothstep(e0, e1, x):
    t = np.clip((x - e0) / max(e1 - e0, 1e-6), 0.0, 1.0)
    return t * t * (3 - 2 * t)


#: half-pixel fill inset: the PIL-mask SDF sits ~half a texel outside
#: the true outline, rendering glyphs bolder than the reference's MSDF
#: text (tuned against the reference label recipe goldens)
FILL_BIAS = 0.45

#: smoothstep half-ramp in pixels around the glyph edge; the reference's
#: MSDF pass uses a sub-pixel fwidth ramp (text_overlay.wgsl), tuned
#: against the label recipe goldens
AA_RAMP = 0.6


def draw_text_rgba(target: np.ndarray, text_or_run, x: float, y: float, *,
                   atlas: Optional[GlyphAtlas] = None, size: Optional[float] = None,
                   color=(255, 255, 255, 255), halo_color=(0, 0, 0, 255),
                   halo_width: float = 0.0, rotation_deg: float = 0.0,
                   opacity: float = 1.0, anchor: str = "baseline") -> np.ndarray:
    """Composite text onto an RGBA u8 image; in-place.

    anchor="baseline": (x, y) is the baseline start (default).
    anchor="center": (x, y) is the VISUAL CENTER of the glyph box — the
    reference's exact-placement label convention
    (_map_scene_render.py _text_anchor_for_visual_center).
    SDF edges give analytic AA; halo_width (pixels) draws an outline ring
    behind the fill — the reference's label halo.
    """
    from .shape import _get_atlas

    atlas = _get_atlas(atlas)
    run = (text_or_run if isinstance(text_or_run, ShapedRun)
           else text_shape(str(text_or_run), atlas=atlas, size=size))
    scale = (size / atlas.px) if size else 1.0
    if anchor == "center":
        xs_b, py_lo, py_hi = [], [], []
        for g in run.glyphs:
            e = atlas.glyphs.get(g.char)
            if e is None or e.w == 0:
                continue
            xs_b.extend((g.x, g.x + e.w * scale))
            py_lo.append(g.y - e.h * scale)
            py_hi.append(g.y)
        if xs_b:
            x = x - (min(xs_b) + max(xs_b)) * 0.5
            y = y + (min(py_lo) + max(py_hi)) * 0.5
    H, W = target.shape[:2]
    cos_r, sin_r = math.cos(math.radians(rotation_deg)), math.sin(math.radians(rotation_deg))
    col = np.asarray(color, np.float32) / 255.0
    halo = np.asarray(halo_color, np.float32) / 255.0
    if col.size == 3:
        col = np.append(col, 1.0)
    if halo.size == 3:
        halo = np.append(halo, 1.0)

    for g in run.glyphs:
        entry = atlas.glyphs.get(g.char)
        if entry is None or entry.w == 0:
            continue
        gw, gh = entry.w * scale, entry.h * scale
        # glyph quad corners in screen space (y down; g.y is baseline-up)
        lx, ly = g.x, g.y
        corners = []
        for (cx, cy) in ((0, 0), (gw, 0), (0, -gh), (gw, -gh)):
            px = lx + cx
            py = ly + cy
            sx = x + px * cos_r - py * sin_r
            sy = y - (px * sin_r + py * cos_r)
            corners.append((sx, sy))
        xs = [c[0] for c in corners]
        ys = [c[1] for c in corners]
        x_min = max(int(math.floor(min(xs))) - 1, 0)
        x_max = min(int(math.ceil(max(xs))) + 1, W - 1)
        y_min = max(int(math.floor(min(ys))) - 1, 0)
        y_max = min(int(math.ceil(max(ys))) + 1, H - 1)
        if x_max < x_min or y_max < y_min:
            continue
        yy, xx = np.mgrid[y_min:y_max + 1, x_min:x_max + 1]
        # invert the rotation to glyph-local coordinates
        dx = xx - x
        dy = y - yy
        px = dx * cos_r + dy * sin_r   # inverse rotation (transpose)
        py = -dx * sin_r + dy * cos_r
        u = (px - lx) / scale + entry.x
        v = entry.y - (py - ly) / scale
        if atlas.image.ndim == 3:
            # true MSDF: per-channel bilinear sample, median3 decode
            # (reference text_overlay.wgsl: sdf = median3(sample.rgb))
            from .msdf import median3

            sdf = median3(*(
                _sample_sdf(atlas.image[..., c], u, v, -atlas.sdf_range)
                for c in range(3)))
        else:
            sdf = _sample_sdf(atlas.image, u, v, -atlas.sdf_range)
        sdf_px = sdf * scale  # distances scale with the glyph
        aa = AA_RAMP
        fill_cov = _smoothstep(-aa, aa, sdf_px - FILL_BIAS) * opacity
        region = target[y_min:y_max + 1, x_min:x_max + 1].astype(np.float32) / 255.0
        if halo_width > 0:
            # the SDF saturates at +-sdf_range texels; a halo wider than
            # the saturated distance would cover the whole glyph quad as
            # a box, so cap it just inside the representable band
            halo_eff = min(halo_width, atlas.sdf_range * scale - aa)
            halo_cov = _smoothstep(-aa, aa, sdf_px + halo_eff) * opacity
            a = halo_cov * halo[3]
            rgb = region[..., :3] * (1 - a[..., None]) + halo[:3] * a[..., None]
            alpha = region[..., 3] * (1 - a) + a
            region = np.concatenate([rgb, alpha[..., None]], -1)
        a = fill_cov * col[3]
        region_rgb = region[..., :3] * (1 - a[..., None]) + col[:3] * a[..., None]
        region_a = region[..., 3] * (1 - a) + a
        out = np.concatenate([region_rgb, region_a[..., None]], -1)
        target[y_min:y_max + 1, x_min:x_max + 1] = (
            np.clip(out, 0, 1) * 255 + 0.5).astype(np.uint8)
    return target


def render_label_overlay(width: int, height: int,
                         placements: Sequence, *,
                         atlas: Optional[GlyphAtlas] = None) -> np.ndarray:
    """Render planned label placements (plan.LabelPlacement) to a
    transparent RGBA overlay for compositing onto a frame."""
    overlay = np.zeros((height, width, 4), np.uint8)
    for p in placements:
        draw_text_rgba(
            overlay, p.text, p.x, p.y, atlas=atlas, size=p.size,
            color=p.color, halo_color=p.halo_color, halo_width=p.halo_width,
            rotation_deg=p.rotation_deg, opacity=p.opacity)
    return overlay


def draw_text_along_path(target: np.ndarray, text: str,
                         path_xy, *, size: float = 14.0,
                         offset: float = 0.0,
                         color=(255, 255, 255, 255),
                         halo_color=(0, 0, 0, 255),
                         halo_width: float = 0.0,
                         opacity: float = 1.0,
                         atlas: Optional[GlyphAtlas] = None) -> np.ndarray:
    """TRUE curved text: each glyph is placed and rotated to the local
    path tangent at its arc-length position (the reference's curved
    labels, src/labels/ curved placement — not the straight line-label
    approximation).

    `path_xy` is an (N, 2) screen-space polyline; `offset` shifts the
    text start along the arc. Text flips upright when the path runs
    right-to-left.
    """
    from .shape import _get_atlas

    atlas = _get_atlas(atlas)
    run = text_shape(str(text), atlas=atlas, size=size)
    pts = np.asarray(path_xy, np.float64).reshape(-1, 2)
    if len(pts) < 2:
        return target
    seg = np.diff(pts, axis=0)
    seg_len = np.hypot(seg[:, 0], seg[:, 1])
    total = float(seg_len.sum())
    if total <= 0:
        return target
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])

    # upright test: overall path direction
    flip = (pts[-1, 0] - pts[0, 0]) < 0

    def at(s):
        s = min(max(s, 0.0), total - 1e-9)
        i = int(np.searchsorted(cum, s, side="right") - 1)
        i = min(max(i, 0), len(seg) - 1)
        t = (s - cum[i]) / max(seg_len[i], 1e-12)
        p = pts[i] + t * seg[i]
        ang = math.degrees(math.atan2(-seg[i, 1], seg[i, 0]))
        return p, ang

    scale = size / atlas.px
    for g in run.glyphs:
        entry = atlas.glyphs.get(g.char)
        if entry is None or entry.w == 0:
            continue
        gw = entry.w * scale
        s_mid = offset + g.x + gw * 0.5
        if flip:
            s_mid = offset + (run.width - (g.x + gw * 0.5))
        (px, py), ang = at(s_mid)
        if flip:
            ang += 180.0
        # draw this single glyph at its own rotation; reuse
        # draw_text_rgba with a one-glyph run
        single = ShapedRun(glyphs=[type(g)(char=g.char, x=-gw * 0.5,
                                           y=g.y, advance=g.advance)],
                           width=gw, height=run.height,
                           ascent=run.ascent, descent=run.descent,
                           text=g.char, direction=run.direction)
        draw_text_rgba(target, single, float(px), float(py),
                       atlas=atlas, size=size, color=color,
                       halo_color=halo_color, halo_width=halo_width,
                       rotation_deg=ang, opacity=opacity)
    return target
