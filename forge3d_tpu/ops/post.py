# forge3d_tpu/ops/post.py
# Post-processing suite: bloom, depth-of-field, TAA, SSAO, SSR, vignette,
# sharpen, rect-area-light shading.
#
# Parity notes (reference behavior, not code): the reference implements
# these as WGSL passes (/root/reference/src/core/{bloom,dof,taa}.rs,
# src/passes/ ssao/ssgi/ssr, bloom_*.wgsl, dof.wgsl, taa.wgsl,
# ltc_*.rs). Here: each effect is a pure jnp function over image
# pytrees — XLA fuses the elementwise chains, and separable convolutions
# map onto vector units; no render-target plumbing. Rect area lights use the
# representative-point approximation (Karis 2013) rather than an LTC LUT —
# same visual contract (soft specular from rectangles), no 64kB table.
#
# All functions take/return float32 linear-light arrays (H, W, 3) unless
# noted, and are deterministic.

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["gaussian_blur", "bloom", "depth_of_field", "taa_resolve",
           "ssao", "ssr", "vignette", "sharpen", "halton_jitter",
           "rect_area_light", "PostConfig", "apply_post_chain"]

_F32 = jnp.float32


def _gauss_kernel(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=_F32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def gaussian_blur(img, sigma: float = 2.0, radius: Optional[int] = None):
    """Separable gaussian blur, edge-clamped."""
    if radius is None:
        radius = max(1, int(math.ceil(3 * sigma)))
    k = _gauss_kernel(float(sigma), int(radius))
    img = jnp.asarray(img, _F32)

    def conv1d(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (radius, radius)
        xp = jnp.pad(x, pad, mode="edge")
        idx = [slice(None)] * x.ndim
        out = jnp.zeros_like(x)
        for i in range(2 * radius + 1):
            idx[axis] = slice(i, i + x.shape[axis])
            out = out + k[i] * xp[tuple(idx)]
        return out

    return conv1d(conv1d(img, 0), 1)


def bloom(color, *, threshold: float = 1.0, intensity: float = 0.5,
          sigma: float = 6.0):
    """Brightpass -> blur -> additive composite
    (reference: bloom_brightpass/blur/composite passes)."""
    color = jnp.asarray(color, _F32)
    lum = (0.2126 * color[..., 0] + 0.7152 * color[..., 1]
           + 0.0722 * color[..., 2])
    knee = jnp.clip((lum - threshold) / jnp.maximum(threshold, 1e-4), 0.0, None)
    bright = color * (knee / jnp.maximum(lum, 1e-4))[..., None]
    # two-scale blur approximates the reference's mip chain
    blurred = 0.65 * gaussian_blur(bright, sigma) \
        + 0.35 * gaussian_blur(bright, sigma * 2.5)
    return color + intensity * blurred


def depth_of_field(color, depth, *, focus_distance: float,
                   focus_range: float = 2.0, max_coc: float = 8.0,
                   near_blur: bool = True):
    """Gather DOF: circle-of-confusion from depth, 3-tap-sigma blend
    (reference: dof.wgsl gather kernel)."""
    color = jnp.asarray(color, _F32)
    depth = jnp.asarray(depth, _F32)
    coc = jnp.abs(depth - focus_distance) / jnp.maximum(focus_range, 1e-4)
    if not near_blur:
        coc = jnp.where(depth < focus_distance, 0.0, coc)
    coc = jnp.clip(coc, 0.0, 1.0) * max_coc
    b_small = gaussian_blur(color, max(max_coc * 0.25, 0.5))
    b_large = gaussian_blur(color, max(max_coc * 0.75, 1.0))
    t = (coc / max(max_coc, 1e-4))[..., None]
    sharp_mix = jnp.clip(t * 2.0, 0.0, 1.0)
    blur_mix = jnp.clip(t * 2.0 - 1.0, 0.0, 1.0)
    return (color * (1 - sharp_mix) + b_small * sharp_mix) * (1 - blur_mix) \
        + b_large * blur_mix


_HALTON_2_3 = None


def halton_jitter(n: int = 8) -> jnp.ndarray:
    """(n, 2) Halton(2,3) subpixel jitter sequence in [-0.5, 0.5)
    (the reference's TAA jitter source)."""
    def halton(i, b):
        f, r = 1.0, 0.0
        while i > 0:
            f /= b
            r += f * (i % b)
            i //= b
        return r

    pts = [(halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5) for i in range(n)]
    return jnp.asarray(pts, _F32)


def taa_resolve(current, history, *, blend: float = 0.1,
                clamp_neighborhood: bool = True):
    """Temporal AA resolve: exponential history blend with 3x3
    neighborhood clamp to kill ghosting (reference: taa.wgsl)."""
    current = jnp.asarray(current, _F32)
    history = jnp.asarray(history, _F32)
    if clamp_neighborhood:
        shifts = [jnp.roll(current, (dy, dx), (0, 1))
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        stack = jnp.stack(shifts)
        lo = stack.min(0)
        hi = stack.max(0)
        history = jnp.clip(history, lo, hi)
    return blend * current + (1.0 - blend) * history


def ssao(depth, normal, *, radius: float = 6.0, intensity: float = 1.0,
         bias: float = 0.02, n_samples: int = 8):
    """Screen-space AO from depth+normal buffers: horizon-style occlusion
    using fixed spiral taps (reference: ssao pass). Returns (H, W) in
    [0, 1] (1 = unoccluded)."""
    depth = jnp.asarray(depth, _F32)
    normal = jnp.asarray(normal, _F32)
    H, W = depth.shape
    occl = jnp.zeros((H, W), _F32)
    golden = 2.399963

    def shift_clamp(a, dy, dx):
        """Sample a[y+dy, x+dx] with edge clamp (no wraparound)."""
        py0, py1 = max(dy, 0), max(-dy, 0)
        px0, px1 = max(dx, 0), max(-dx, 0)
        ap = jnp.pad(a, ((py1, py0), (px1, px0)), mode="edge")
        return ap[py1 + dy: py1 + dy + H, px1 + dx: px1 + dx + W]

    for i in range(n_samples):
        ang = i * golden
        r = radius * (i + 1) / n_samples
        dx = int(round(math.cos(ang) * r)) or 1
        dy = int(round(math.sin(ang) * r))
        d_s = shift_clamp(depth, dy, dx)
        # positive when the sampled neighbor is closer (occludes)
        delta = depth - d_s - bias
        # range falloff keeps distant silhouettes from darkening
        w = jnp.clip(1.0 - jnp.abs(delta) / (radius * 0.25 + 1e-4), 0.0, 1.0)
        occl = occl + jnp.where(delta > 0, w, 0.0)
    ao = 1.0 - intensity * occl / n_samples
    # normals facing the camera occlude less
    facing = jnp.clip(normal[..., 2] if normal.ndim == 3 else normal, 0.0, 1.0)
    return jnp.clip(ao * (0.75 + 0.25 * facing), 0.0, 1.0)


def ssr(color, depth, normal, *, stride: int = 2, max_steps: int = 24,
        intensity: float = 0.5, edge_fade: float = 0.1):
    """Screen-space reflections (vertical-mirror marching model): march up
    the depth buffer along the reflected direction, fade at edges
    (reference: ssr pass; exact-hit variant simplified for fused jnp)."""
    color = jnp.asarray(color, _F32)
    depth = jnp.asarray(depth, _F32)
    normal = jnp.asarray(normal, _F32)
    H, W = depth.shape
    # reflection strength from upward-facing normals (water/ground bounce)
    up = jnp.clip(normal[..., 1], 0.0, 1.0) if normal.ndim == 3 else normal
    best = jnp.zeros((H, W, 3), _F32)
    found = jnp.zeros((H, W), jnp.bool_)
    for step in range(1, max_steps + 1):
        dy = step * stride
        cand_c = jnp.roll(color, dy, axis=0)         # sample above (row - dy)
        cand_d = jnp.roll(depth, dy, axis=0)
        hit = (~found) & (cand_d < depth)            # closer surface above
        best = jnp.where(hit[..., None], cand_c, best)
        found = found | hit
    fade_y = jnp.clip(jnp.arange(H, dtype=_F32) / (H * edge_fade), 0, 1)[:, None]
    strength = intensity * up * found.astype(_F32) * fade_y
    return color * (1 - strength[..., None]) + best * strength[..., None]


def vignette(color, *, strength: float = 0.35, radius: float = 0.85):
    color = jnp.asarray(color, _F32)
    H, W = color.shape[:2]
    yy = (jnp.arange(H, dtype=_F32) / (H - 1) - 0.5) * 2
    xx = (jnp.arange(W, dtype=_F32) / (W - 1) - 0.5) * 2
    r = jnp.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2) / math.sqrt(2)
    fall = jnp.clip((r - radius) / jnp.maximum(1 - radius, 1e-4), 0, 1)
    return color * (1 - strength * fall * fall)[..., None]


def sharpen(color, *, amount: float = 0.3):
    """Unsharp mask (the reference's TAA sharpen companion)."""
    color = jnp.asarray(color, _F32)
    blur = gaussian_blur(color, 1.0, radius=2)
    return jnp.clip(color + amount * (color - blur), 0.0, None)


def rect_area_light(p, n, v, *, light_center, light_right, light_up,
                    half_extent: Tuple[float, float], color=(1.0, 1.0, 1.0),
                    intensity: float = 1.0, roughness: float = 0.3):
    """Rect area light via representative-point approximation (Karis):
    closest point on the rectangle stands in for the LTC integral; energy
    normalized by solid-angle estimate. Inputs are (..., 3) arrays."""
    p = jnp.asarray(p, _F32)
    n = jnp.asarray(n, _F32)
    v = jnp.asarray(v, _F32)
    c = jnp.asarray(light_center, _F32)
    r_axis = jnp.asarray(light_right, _F32)
    u_axis = jnp.asarray(light_up, _F32)
    hx, hy = half_extent
    to_c = c - p
    # project onto the light plane basis and clamp to the rect
    s = jnp.clip(jnp.sum(-to_c * r_axis, -1, keepdims=True), -hx, hx)
    t = jnp.clip(jnp.sum(-to_c * u_axis, -1, keepdims=True), -hy, hy)
    rep = c + s * r_axis + t * u_axis
    L = rep - p
    dist = jnp.linalg.norm(L, axis=-1, keepdims=True)
    Ld = L / jnp.maximum(dist, 1e-6)
    ndl = jnp.clip(jnp.sum(n * Ld, -1, keepdims=True), 0.0, 1.0)
    # solid angle of the rect approximated by area / d^2
    area = 4.0 * hx * hy
    omega = area / jnp.maximum(dist * dist, 1e-4)
    diffuse = ndl * jnp.minimum(omega, math.pi) / math.pi
    # spec: Blinn-Phong-ish with roughness-widened highlight
    h = Ld + v
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-6)
    ndh = jnp.clip(jnp.sum(n * h, -1, keepdims=True), 0.0, 1.0)
    shin = 2.0 / jnp.maximum(roughness * roughness, 1e-3) - 2.0
    spec = ((shin + 2) / (2 * math.pi)) * ndh ** shin \
        * jnp.minimum(omega, 1.0) * ndl
    return (diffuse + spec) * jnp.asarray(color, _F32) * intensity


class PostConfig(NamedTuple):
    bloom_enabled: bool = False
    bloom_threshold: float = 1.0
    bloom_intensity: float = 0.5
    dof_enabled: bool = False
    dof_focus: float = 10.0
    dof_range: float = 4.0
    dof_max_coc: float = 6.0
    vignette_enabled: bool = False
    vignette_strength: float = 0.35
    sharpen_amount: float = 0.0


def apply_post_chain(color, depth=None, cfg: PostConfig = PostConfig()):
    """Fixed-order post chain: bloom -> dof -> vignette -> sharpen
    (matching the reference's pass ordering)."""
    out = jnp.asarray(color, _F32)
    if cfg.bloom_enabled:
        out = bloom(out, threshold=cfg.bloom_threshold,
                    intensity=cfg.bloom_intensity)
    if cfg.dof_enabled and depth is not None:
        out = depth_of_field(out, depth, focus_distance=cfg.dof_focus,
                             focus_range=cfg.dof_range,
                             max_coc=cfg.dof_max_coc)
    if cfg.vignette_enabled:
        out = vignette(out, strength=cfg.vignette_strength)
    if cfg.sharpen_amount > 0:
        out = sharpen(out, amount=cfg.sharpen_amount)
    return out
