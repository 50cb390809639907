# forge3d_tpu/ops/lightsample.py
# Multi-light next-event estimation: alias-table light selection + typed
# light sampling.
#
# Reference behavior being matched (not copied):
#   /root/reference/src/path_tracing/alias_table.rs — O(1) importance-
#   weighted discrete light selection (Vose alias method), and
#   src/path_tracing/importance.rs + restir light sampling — one NEE
#   sample per camera sample drawn from the light set, weighted by
#   1 / selection_pdf.
#
# Here: the table is built host-side (numpy, deterministic); the
# per-pixel draw is two array lookups from (L,)-sized tables — tiny
# gathers that XLA handles fine at any batch shape. Light-point sampling
# evaluates every light TYPE's formula branchlessly and selects by the
# picked light's type id (L is small; the per-type math is elementwise).

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..lighting import _TYPE_ID, LightBuffer

_F32 = jnp.float32


class AliasTable(NamedTuple):
    prob: jax.Array    # (L,) acceptance probability of the home column
    alias: jax.Array   # (L,) alias index
    pdf: jax.Array     # (L,) selection pdf of each light

    @property
    def count(self) -> int:
        return int(self.prob.shape[0])


def alias_table_build(weights) -> AliasTable:
    """Vose's alias method over non-negative weights (host, deterministic)."""
    w = np.asarray(weights, np.float64).ravel()
    if w.size == 0:
        raise ValueError("alias table needs at least one weight")
    if (w < 0).any() or not np.isfinite(w).all():
        raise ValueError("weights must be finite and non-negative")
    total = w.sum()
    if total <= 0:
        w = np.ones_like(w)
        total = w.sum()
    n = w.size
    pdf = w / total
    scaled = pdf * n
    prob = np.zeros(n)
    alias = np.arange(n)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return AliasTable(prob=jnp.asarray(prob, _F32),
                      alias=jnp.asarray(alias, jnp.int32),
                      pdf=jnp.asarray(pdf, _F32))


def alias_sample(table: AliasTable, u) -> Tuple[jax.Array, jax.Array]:
    """Draw light indices from uniform u in [0,1): (index, selection_pdf).
    Works for any array shape of u."""
    n = table.count
    x = jnp.clip(u * n, 0.0, n - 1e-6)
    col = x.astype(jnp.int32)
    frac = x - col.astype(_F32)
    take_home = frac < jnp.take(table.prob, col)
    idx = jnp.where(take_home, col, jnp.take(table.alias, col))
    return idx, jnp.take(table.pdf, idx)


def light_power_weights(lights: LightBuffer) -> np.ndarray:
    """Importance weights ~ emitted power (the reference's alias-table
    importance): luminance x intensity x emitter area/solid factor."""
    col = np.asarray(lights.color)
    lum = 0.2126 * col[:, 0] + 0.7152 * col[:, 1] + 0.0722 * col[:, 2]
    t = np.asarray(lights.type_id)
    r = np.asarray(lights.radius)
    ex = np.asarray(lights.extent)
    area = np.ones_like(lum)
    area = np.where(t == _TYPE_ID["rect"], 4.0 * ex[:, 0] * ex[:, 1], area)
    area = np.where(t == _TYPE_ID["disk"], np.pi * r * r, area)
    area = np.where(t == _TYPE_ID["sphere"], 4.0 * np.pi * r * r, area)
    return np.maximum(lum * area, 1e-9)


def sample_light_nee(lights: LightBuffer, table: AliasTable,
                     px, py, pz, nx, ny, nz, u_pick, u1, u2):
    """One NEE light sample per lane.

    Returns (dx, dy, dz, dist, wr, wg, wb): unit shadow-ray direction, ray
    length (1e30 for directional), and the UNOCCLUDED radiance estimate
    premultiplied by cos(theta) and divided by all pdfs (multiply by the
    visibility test result and the surface albedo/pi-free diffuse BRDF
    convention used by the terrain PT: albedo * estimate).
    """
    idx, p_pick = alias_sample(table, u_pick)
    t_id = jnp.take(lights.type_id, idx)
    col = jnp.take(lights.color, idx, axis=0)
    ldir = jnp.take(lights.direction, idx, axis=0)
    lpos = jnp.take(lights.position, idx, axis=0)
    rad = jnp.take(lights.radius, idx)
    ext = jnp.take(lights.extent, idx, axis=0)
    cones = jnp.take(lights.cones, idx, axis=0)

    is_dir = t_id == _TYPE_ID["directional"]
    is_spot = t_id == _TYPE_ID["spot"]
    is_rect = t_id == _TYPE_ID["rect"]
    is_disk = t_id == _TYPE_ID["disk"]
    is_sphere = t_id == _TYPE_ID["sphere"]

    # sampled emitter point (area lights jitter; others use the center)
    two_pi = 6.2831853
    # rect: axis-aligned in x/z (reference rect lights are horizontal)
    rx = (u1 * 2.0 - 1.0) * ext[..., 0]
    rz = (u2 * 2.0 - 1.0) * ext[..., 1]
    # disk: concentric-ish polar sample in x/z
    dr = jnp.sqrt(u1) * rad
    dphi = two_pi * u2
    # sphere: uniform surface point
    sz = u1 * 2.0 - 1.0
    sphi = two_pi * u2
    sr = jnp.sqrt(jnp.maximum(1.0 - sz * sz, 0.0))
    off_x = jnp.where(is_rect, rx,
                      jnp.where(is_disk, dr * jnp.cos(dphi),
                                jnp.where(is_sphere, rad * sr * jnp.cos(sphi),
                                          0.0)))
    off_y = jnp.where(is_sphere, rad * sz, 0.0)
    off_z = jnp.where(is_rect, rz,
                      jnp.where(is_disk, dr * jnp.sin(dphi),
                                jnp.where(is_sphere, rad * sr * jnp.sin(sphi),
                                          0.0)))
    lx = lpos[..., 0] + off_x
    ly = lpos[..., 1] + off_y
    lz = lpos[..., 2] + off_z

    # direction + distance
    vx = lx - px
    vy = ly - py
    vz = lz - pz
    d2 = vx * vx + vy * vy + vz * vz
    dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
    inv = 1.0 / dist
    dx = jnp.where(is_dir, -ldir[..., 0], vx * inv)
    dy = jnp.where(is_dir, -ldir[..., 1], vy * inv)
    dz = jnp.where(is_dir, -ldir[..., 2], vz * inv)
    dist = jnp.where(is_dir, 1e30, dist)

    ndl = jnp.maximum(nx * dx + ny * dy + nz * dz, 0.0)

    # geometric factor per type:
    # directional: 1 (radiance); point/spot: 1/r^2 (intensity);
    # area: area * cos_on_light / r^2 (pdf_area = 1/area folded in)
    inv_d2 = 1.0 / jnp.maximum(d2, 1e-6)
    # emitter-side cosine (rect/disk emit downward +- normal (0,-1,0)
    # convention: horizontal emitters; both faces emit -> |cos|)
    cos_l = jnp.abs(dy)
    area_rect = 4.0 * ext[..., 0] * ext[..., 1]
    area_disk = jnp.pi * rad * rad
    # sphere: solid-angle-exact enough for tests via area form with
    # |cos| at the sampled surface point
    snx = jnp.where(rad > 0, off_x / jnp.maximum(rad, 1e-9), 0.0)
    sny = jnp.where(rad > 0, off_y / jnp.maximum(rad, 1e-9), 0.0)
    snz = jnp.where(rad > 0, off_z / jnp.maximum(rad, 1e-9), 0.0)
    cos_s = jnp.maximum(-(snx * dx + sny * dy + snz * dz), 0.0)
    area_sphere = 4.0 * jnp.pi * rad * rad

    geom = jnp.where(is_dir, 1.0, inv_d2)
    geom = jnp.where(is_rect, area_rect * cos_l * inv_d2, geom)
    geom = jnp.where(is_disk, area_disk * cos_l * inv_d2, geom)
    geom = jnp.where(is_sphere, area_sphere * cos_s * inv_d2, geom)

    # spot cone falloff
    cd = -(dx * ldir[..., 0] + dy * ldir[..., 1] + dz * ldir[..., 2])
    spot_f = jnp.clip((cd - cones[..., 1])
                      / jnp.maximum(cones[..., 0] - cones[..., 1], 1e-6),
                      0.0, 1.0)
    geom = jnp.where(is_spot, geom * spot_f * spot_f, geom)

    scale = ndl * geom / jnp.maximum(p_pick, 1e-12)
    wr = col[..., 0] * scale
    wg = col[..., 1] * scale
    wb = col[..., 2] * scale
    return dx, dy, dz, dist, wr, wg, wb
