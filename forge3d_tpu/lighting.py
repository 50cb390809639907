# forge3d_tpu/lighting.py
# Lighting stack: typed lights (directional/point/spot/area rect/disk/
# sphere), R2 low-discrepancy sample sequence, analytic light evaluation.
#
# Parity notes (reference behavior, not code): /root/reference/src/
# lighting/ (light.rs:11-17 PyLight types; light_buffer/ with R2 sequence
# frames; material.rs BRDF; ephemeris.rs NOAA solar). Here: lights
# are a struct-of-arrays pytree consumed by fused jnp shading; the solar
# ephemeris seam lives in sky.sun_position_at (Meeus).

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Light", "LightBuffer", "r2_sequence", "eval_lights",
           "LIGHT_TYPES"]

_F32 = jnp.float32

LIGHT_TYPES = ("directional", "point", "spot", "rect", "disk", "sphere")
_TYPE_ID = {t: i for i, t in enumerate(LIGHT_TYPES)}


@dataclass
class Light:
    """One typed light (reference: PyLight)."""

    type: str = "directional"
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)
    position: Tuple[float, float, float] = (0.0, 10.0, 0.0)
    radius: float = 1.0                 # disk/sphere radius, rect half-size
    extent: Tuple[float, float] = (1.0, 1.0)   # rect half extents
    inner_cone_deg: float = 20.0
    outer_cone_deg: float = 30.0

    def __post_init__(self):
        if self.type not in LIGHT_TYPES:
            raise ValueError(f"unknown light type {self.type!r}; "
                             f"one of {LIGHT_TYPES}")
        if self.intensity < 0:
            raise ValueError("intensity must be >= 0")
        if self.type == "spot" and not (
                0 < self.inner_cone_deg <= self.outer_cone_deg <= 90):
            raise ValueError("require 0 < inner <= outer <= 90 degrees")


class LightBuffer(NamedTuple):
    """Struct-of-arrays light set (device pytree)."""

    type_id: jax.Array      # (L,) i32
    color: jax.Array        # (L, 3) premultiplied by intensity
    direction: jax.Array    # (L, 3) normalized
    position: jax.Array     # (L, 3)
    radius: jax.Array       # (L,)
    extent: jax.Array       # (L, 2)
    cones: jax.Array        # (L, 2) cos(inner), cos(outer)

    @staticmethod
    def from_lights(lights: List[Light]) -> "LightBuffer":
        if not lights:
            raise ValueError("empty light list")
        d = np.asarray([l.direction for l in lights], np.float32)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
        return LightBuffer(
            type_id=jnp.asarray([_TYPE_ID[l.type] for l in lights],
                                jnp.int32),
            color=jnp.asarray([np.asarray(l.color) * l.intensity
                               for l in lights], _F32),
            direction=jnp.asarray(d),
            position=jnp.asarray([l.position for l in lights], _F32),
            radius=jnp.asarray([l.radius for l in lights], _F32),
            extent=jnp.asarray([l.extent for l in lights], _F32),
            cones=jnp.asarray(
                [(math.cos(math.radians(l.inner_cone_deg)),
                  math.cos(math.radians(l.outer_cone_deg)))
                 for l in lights], _F32),
        )

    @property
    def count(self) -> int:
        return int(self.type_id.shape[0])


def r2_sequence(n: int, *, frame: int = 0) -> np.ndarray:
    """(n, 2) R2 low-discrepancy sequence (the reference's light-buffer
    jitter source; generalized golden ratio)."""
    g = 1.32471795724474602596  # plastic constant
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    i = np.arange(frame * n, (frame + 1) * n, dtype=np.float64) + 1
    return np.stack([(0.5 + a1 * i) % 1.0, (0.5 + a2 * i) % 1.0],
                    axis=1).astype(np.float32)


def eval_lights(lights: LightBuffer, p, n, *, u=None):
    """Diffuse irradiance from every light at surface points.

    p, n: (..., 3) position/normal arrays. u: optional (..., 2) jitter for
    area lights (R2 samples). Returns (..., 3) RGB irradiance (no
    occlusion — shadow queries are the renderer's job).
    """
    p = jnp.asarray(p, _F32)
    n = jnp.asarray(n, _F32)
    out = jnp.zeros(p.shape[:-1] + (3,), _F32)
    L = lights.count
    for i in range(L):                    # small L: unrolled, fuses flat
        t = int(lights.type_id[i])
        col = lights.color[i]
        if t == _TYPE_ID["directional"]:
            ld = -lights.direction[i]
            ndl = jnp.maximum(jnp.sum(n * ld, -1), 0.0)
            out = out + col * ndl[..., None]
            continue
        # positional lights: direction + falloff
        lp = lights.position[i]
        if u is not None and t in (_TYPE_ID["rect"], _TYPE_ID["disk"],
                                   _TYPE_ID["sphere"]):
            uu = jnp.asarray(u, _F32)
            if t == _TYPE_ID["rect"]:
                ex, ey = lights.extent[i]
                # jitter within the rect's local frame (axis-aligned rect)
                lp = lp + jnp.stack(
                    [(uu[..., 0] * 2 - 1) * ex,
                     jnp.zeros_like(uu[..., 0]),
                     (uu[..., 1] * 2 - 1) * ey], -1)
            else:
                r = lights.radius[i]
                ang = uu[..., 0] * 2 * math.pi
                rr = jnp.sqrt(uu[..., 1]) * r
                lp = lp + jnp.stack([rr * jnp.cos(ang),
                                     jnp.zeros_like(ang),
                                     rr * jnp.sin(ang)], -1)
        to_l = lp - p
        dist2 = jnp.maximum(jnp.sum(to_l * to_l, -1), 1e-6)
        ld = to_l * jax.lax.rsqrt(dist2)[..., None]
        ndl = jnp.maximum(jnp.sum(n * ld, -1), 0.0)
        atten = 1.0 / dist2
        if t == _TYPE_ID["spot"]:
            cos_i, cos_o = lights.cones[i]
            cd = jnp.sum(-ld * lights.direction[i], -1)
            spot = jnp.clip((cd - cos_o) / jnp.maximum(cos_i - cos_o, 1e-6),
                            0.0, 1.0)
            atten = atten * spot * spot
        elif t == _TYPE_ID["sphere"]:
            # solid-angle-ish boost for large spheres up close
            r = lights.radius[i]
            atten = atten * jnp.minimum(1.0 + r * r / dist2, 4.0)
        out = out + col * (ndl * atten)[..., None]
    return out
