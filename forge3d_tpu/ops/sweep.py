# forge3d_tpu/ops/sweep.py
# Directional shadow-line sweeps over a heightfield — a reformulation of
# per-ray occlusion tracing.
#
# Reference behavior being replaced (not copied): the terrain PT estimator's
# sun-shadow and env-visibility rays (/root/reference/src/shaders/
# hybrid_terrain_traversal.wgsl:318-384 — sun NEE occlusion + one
# cosine-sampled env visibility ray per camera sample). Per-ray heightfield
# marching does one data-dependent table lookup per step per ray, and
# one visibility ray per texel per direction.
#
# Redesign: for a FIXED direction w, occlusion of *every* texel
# at once is a classic shadow-line propagation — march the grid along the
# light-travel direction carrying the running shadow height
#       z[i] = max(h[i], shift(z[i-1], tau) - delta)
# where `shift` is a fractional lateral move (lerp of two static rolls) and
# `delta` the ray's vertical drop per row. No gathers anywhere: rolls,
# lerps, max — pure elementwise work, O(grid) per direction for ALL texels.
# The env-visibility integral
#       E_sky(x) = int env(w) V(x,w) max(0, n.w)/pi dw
# (exactly the expectation the reference estimates with per-pixel cosine
# sampling) is evaluated by stratifying the sphere into (azimuth x
# elevation) bins, jittered per frame, one propagation per bin, all bins
# batched into four lax.scans (one per marching axis/direction). The sun
# term needs a single extra propagation that also emits the *continuous*
# shadow-boundary height z_sun for sharp per-pixel shadow tests.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .shading import EnvMap, env_radiance

_F32 = jnp.float32
_NEG = jnp.float32(-1.0e30)

#: Rows per unrolled step of the propagation scan (the per-row body is
#: small B x U vector work, so per-iteration overhead is visible). On an
#: H100 (700 W), sweep_lighting over 4 frames of the 1920x1080 / 1025^2
#: job took 32.2 ms at 8, 36.1 ms at 16 and 105.0 ms at 1 (PERF.md).
SCAN_UNROLL = 8


# ---------------------------------------------------------------------------
# Stratification (static structure; per-frame jitter is traced)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SkyStrata:
    """Static stratification of the direction sphere in GRID frame.

    Azimuth strata are uniform in grid azimuth alpha (measured from the +v
    grid axis toward +u) with stratum EDGES placed at 45 deg + k*90 deg, so
    every stratum lies inside one marching-axis quadrant and the
    bin->lax.scan grouping stays static under jitter. Elevations are
    equal-area in sin(theta) over [sin_lo, 1].
    """

    na: int
    ne: int
    sin_lo: float

    @property
    def n_bins(self) -> int:
        return self.na * self.ne

    @property
    def solid_angle_per_bin(self) -> float:
        return 2.0 * math.pi * (1.0 - self.sin_lo) / (self.na * self.ne)

    def quadrant_of(self, stratum: int) -> int:
        """0: march +v, 1: march -v, 2: march +u, 3: march -u."""
        center = self.alpha_center(stratum)
        # light travels along -w_h; w azimuth alpha -> travel azimuth
        # alpha+pi. march +v means travel_v > 0 dominant.
        tv = -math.cos(center)
        tu = -math.sin(center)
        if abs(tv) >= abs(tu):
            return 0 if tv >= 0 else 1
        return 2 if tu >= 0 else 3

    def alpha_center(self, stratum: int) -> float:
        width = 2.0 * math.pi / self.na
        return math.pi / 4.0 + (stratum + 0.5) * width


def make_strata(na: int = 32, ne: int = 12, sin_lo: float = -0.55) -> SkyStrata:
    if na % 4 != 0:
        raise ValueError("sky azimuth strata count must be a multiple of 4")
    if ne < 1 or not (-1.0 < sin_lo < 1.0):
        raise ValueError("bad sky elevation stratification")
    return SkyStrata(na=na, ne=ne, sin_lo=sin_lo)


def jitter_bins(strata: SkyStrata, key) -> Tuple[jax.Array, jax.Array]:
    """Per-frame jittered bin directions in grid frame.

    Returns (alpha, sin_el) of shape (na, ne): grid azimuth and elevation
    sine, each uniformly jittered within its stratum.
    """
    ka, ke = jax.random.split(key)
    ua = jax.random.uniform(ka, (strata.na, strata.ne), _F32)
    ue = jax.random.uniform(ke, (strata.na, strata.ne), _F32)
    width = 2.0 * math.pi / strata.na
    a0 = math.pi / 4.0 + width * jnp.arange(strata.na, dtype=_F32)[:, None]
    alpha = a0 + ua * width
    ds = (1.0 - strata.sin_lo) / strata.ne
    s0 = strata.sin_lo + ds * jnp.arange(strata.ne, dtype=_F32)[None, :]
    sin_el = jnp.clip(s0 + ue * ds, -0.999, 0.999)
    return alpha, sin_el


# ---------------------------------------------------------------------------
# One batched propagation scan
# ---------------------------------------------------------------------------


def _propagate_group(h, du, dv, invn, tau, delta, w_u, w_v, w_y, env_w,
                     emit_z0: bool, substeps: int = 1):
    """Shadow-line propagation for B direction bins marching +rows.

    h:      (V, U) world heights (-1e30 outside the DEM: never blocks,
            never lit-emits anything that matters)
    du, dv: (V, U) surface height derivatives along grid +u / +v (world)
    invn:   (V, U) 1/sqrt(1 + du^2 + dv^2)
    tau:    (B,)   lateral cells per row along the march (|tau| <= 1)
    delta:  (B,)   shadow-line drop per row (world units; may be negative)
    w_u/v/y:(B,)   world-frame direction components in grid coords
    env_w:  (B, 3) env radiance premultiplied by the quadrature weight
            (solid angle / pi); 0 for bins excluded from the sky sum.
    substeps: sub-row propagation steps. Between rows the bilinear surface
            is exactly linear in v at each u node, so mid-row blocker
            heights are exact lerps — substeps=2 halves the sampling error
            for grazing directions at 2x scan cost.
    Returns (e_sky (V, U, 3), z_in0 (V, U)) — z_in0 is bin 0's incoming
    shadow height per texel (only meaningful when emit_z0).
    """
    V, U = h.shape
    B = tau.shape[0]
    ss = int(substeps)
    taub = tau[:, None] / ss
    tpos = jnp.maximum(taub, 0.0)
    tneg = jnp.maximum(-taub, 0.0)
    deltab = delta[:, None] / ss

    def shift_drop(z):
        zp = jnp.roll(z, 1, axis=-1)
        zp = zp.at[:, 0].set(_NEG)
        zm = jnp.roll(z, -1, axis=-1)
        zm = zm.at[:, -1].set(_NEG)
        return z * (1.0 - jnp.abs(taub)) + tpos * zp + tneg * zm - deltab

    def step(carry, xs):
        z, h_prev = carry
        h_row, du_row, dv_row, invn_row = xs
        for j in range(1, ss):
            f = j / ss
            h_mid = h_prev + f * (h_row - h_prev)
            z = jnp.maximum(h_mid[None, :], shift_drop(z))
        z_in = shift_drop(z)
        lit = (h_row[None, :] >= z_in).astype(_F32)
        cosb = (w_y[:, None]
                - w_u[:, None] * du_row[None, :]
                - w_v[:, None] * dv_row[None, :]) * invn_row[None, :]
        contrib = lit * jnp.maximum(cosb, 0.0)
        # HIGHEST: the bin sum is the sky irradiance itself; a TF32
        # product would round it to ~10 mantissa bits (B x U x 3, tiny)
        e_row = jnp.einsum("bu,bc->uc", contrib, env_w,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=_F32)
        z_new = jnp.maximum(h_row[None, :], z_in)
        return (z_new, h_row), (e_row, z_in[0])

    z0 = jnp.full((B, U), _NEG, _F32)
    _, (e_sky, z_in0) = jax.lax.scan(
        step, (z0, h[0]), (h, du, dv, invn), unroll=SCAN_UNROLL)
    return e_sky, z_in0


class SweepMaps(NamedTuple):
    """Per-frame texel-space lighting maps on the rotated grid."""

    e_sky: jax.Array   # (V, U, 3) sky irradiance term (no albedo)
    z_sun: jax.Array   # (V, U) incoming sun shadow height (world y);
                       # a point at (u, v, y) is sunlit iff y >= z_sun(u, v)


def sweep_lighting(h, du, dv, *, strata: SkyStrata, key,
                   env: EnvMap, e_u, e_v, sun_world, spacing,
                   sun_only: bool = False, substeps: int = 2,
                   sky_substeps: int = 1) -> SweepMaps:
    """Run all direction-bin propagations for one frame.

    e_u, e_v: (3,) world-frame unit vectors of the rotated grid axes
              (horizontal). sun_world: (3,) unit direction toward the sun —
    must be PYTHON floats (the sun's marching quadrant is static).
    spacing: grid cell size in world units.
    """
    e_u = tuple(float(c) for c in np.asarray(e_u))
    e_v = tuple(float(c) for c in np.asarray(e_v))
    sun_world = tuple(float(c) for c in np.asarray(sun_world))
    V, U = h.shape
    alpha, sin_el = jitter_bins(strata, key)           # (na, ne)
    cos_el = jnp.sqrt(jnp.maximum(1.0 - sin_el ** 2, 1e-12))
    # grid-frame direction -> world components
    wu = (jnp.sin(alpha) * cos_el).reshape(-1)
    wv = (jnp.cos(alpha) * cos_el).reshape(-1)
    wy = sin_el.reshape(-1)
    # world-frame xyz for env lookup
    dx = wu * e_u[0] + wv * e_v[0]
    dy = wy
    dz = wu * e_u[2] + wv * e_v[2]
    er, eg, eb = env_radiance(env, dx, dy, dz)
    w_quad = jnp.asarray(strata.solid_angle_per_bin / math.pi, _F32)
    env_w = jnp.stack([er, eg, eb], axis=-1) * w_quad  # (B, 3)

    # sun in grid frame
    su = sun_world[0] * e_u[0] + sun_world[1] * e_u[1] + sun_world[2] * e_u[2]
    sv = sun_world[0] * e_v[0] + sun_world[1] * e_v[1] + sun_world[2] * e_v[2]
    sy = sun_world[1]

    e_total = jnp.zeros((V, U, 3), _F32)
    z_sun = jnp.full((V, U), _NEG, _F32)

    # static bin->quadrant grouping (see SkyStrata docstring)
    groups = [[], [], [], []]
    for s in range(strata.na):
        groups[strata.quadrant_of(s)].append(s)
    # the sun's quadrant is static too (python floats in the descriptor)
    sun_q = _quadrant_of_dir(float(su), float(sv))

    for q in range(4):
        idx = np.array(
            [s * strata.ne + e for s in groups[q] for e in range(strata.ne)],
            np.int32)
        has_sun = q == sun_q
        if idx.size == 0 and not has_sun:
            continue
        if idx.size:
            g_wu, g_wv, g_wy = wu[idx], wv[idx], wy[idx]
            g_env = env_w[idx]
        else:
            g_wu = jnp.zeros((0,), _F32)
            g_wv = jnp.zeros((0,), _F32)
            g_wy = jnp.zeros((0,), _F32)
            g_env = jnp.zeros((0, 3), _F32)
        if has_sun:
            # sun rides as bin 0 with zero sky weight; its incoming shadow
            # line is emitted as the continuous z_sun field
            g_wu = jnp.concatenate([jnp.asarray([su], _F32), g_wu])
            g_wv = jnp.concatenate([jnp.asarray([sv], _F32), g_wv])
            g_wy = jnp.concatenate([jnp.asarray([sy], _F32), g_wy])
            g_env = jnp.concatenate([jnp.zeros((1, 3), _F32), g_env])
        if sun_only and not has_sun:
            continue
        if sun_only and has_sun:
            g_wu, g_wv, g_wy, g_env = (g_wu[:1], g_wv[:1], g_wy[:1],
                                       g_env[:1])
        # sun accuracy matters per-pixel (sharp shadow boundaries) -> full
        # substeps; sky bins are jitter-averaged over frames -> coarser
        # sampling is absorbed by the stratification noise
        grp_substeps = substeps if has_sun else sky_substeps

        # Orient the grid so the group's march is +rows. Light travels
        # along l = -(w_u, w_v, w_y); per oriented-row step (spacing world
        # units along the dominant axis):
        #   tau   = l_col / l_row_oriented     (lateral cells per row)
        #   delta = spacing * w_y / l_row_oriented  (shadow-line drop)
        # with l_row_oriented = |dominant l component| > 0 by grouping.
        # du/dv keep their ORIGINAL meaning (d h / d u_orig, d h / d v_orig)
        # under flips/transposes, so they always pair with w_u / w_v.
        if q == 0:       # l_v > 0 dominant: march +v
            hh, duu, dvv = h, du, dv
            l_row = -g_wv
            l_col = -g_wu
        elif q == 1:     # l_v < 0 dominant: march -v (flip rows)
            hh, duu, dvv = h[::-1], du[::-1], dv[::-1]
            l_row = g_wv
            l_col = -g_wu
        elif q == 2:     # l_u > 0 dominant: march +u (transpose)
            hh, duu, dvv = h.T, du.T, dv.T
            l_row = -g_wu
            l_col = -g_wv
        else:            # l_u < 0 dominant: march -u
            hh, duu, dvv = h.T[::-1], du.T[::-1], dv.T[::-1]
            l_row = g_wu
            l_col = -g_wv
        l_row = jnp.maximum(l_row, 1e-6)
        tau = jnp.clip(l_col / l_row, -1.0, 1.0)
        delta = jnp.clip(spacing * g_wy / l_row, -1e7, 1e7)
        invn_o = jax.lax.rsqrt(1.0 + duu * duu + dvv * dvv)
        e_g, z0_g = _propagate_group(hh, duu, dvv, invn_o, tau, delta,
                                     g_wu, g_wv, g_wy, g_env,
                                     emit_z0=has_sun, substeps=grp_substeps)
        # undo orientation
        if q == 1:
            e_g, z0_g = e_g[::-1], z0_g[::-1]
        elif q == 2:
            e_g = jnp.swapaxes(e_g, 0, 1)
            z0_g = z0_g.T
        elif q == 3:
            e_g = jnp.swapaxes(e_g[::-1], 0, 1)
            z0_g = z0_g[::-1].T
        e_total = e_total + e_g
        if has_sun:
            z_sun = z0_g
    return SweepMaps(e_sky=e_total, z_sun=z_sun)


def _quadrant_of_dir(wu: float, wv: float) -> int:
    tu, tv = -wu, -wv
    if abs(tv) >= abs(tu):
        return 0 if tv >= 0 else 1
    return 2 if tu >= 0 else 3


# ---------------------------------------------------------------------------
# Camera-aligned rotated grid
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RotGridStatic:
    """Static geometry of the camera-aligned grid (python floats: the
    camera and DEM bounds are static per render, so jitted programs
    specialize on them)."""

    n_v: int
    n_u: int
    spacing: float
    u0: float          # world-u of column 0 (relative to camera ground pt)
    v0: float          # world-v of row 0
    e_u: Tuple[float, float, float]
    e_v: Tuple[float, float, float]
    cam_iu: float      # camera ground position in (fractional) grid index
    cam_iv: float


def plan_rot_grid(dem_w_cells: int, dem_h_cells: int,
                  origin_xz: Tuple[float, float],
                  spacing_xz: Tuple[float, float],
                  cam_xz: Tuple[float, float],
                  fwd_xz: Tuple[float, float],
                  margin_cells: int = 2,
                  round_to: int = 8) -> RotGridStatic:
    """Lay out a rotated grid: +v along the camera's horizontal forward,
    +u along its right; covers the DEM bbox plus the camera ground point."""
    fx, fz = fwd_xz
    norm = math.hypot(fx, fz)
    if norm < 1e-9:
        raise ValueError("camera looks straight down; no horizontal forward")
    fx, fz = fx / norm, fz / norm
    # right = fwd x up (y-up): (fz, 0, -fx) x-z components
    rx, rz = -fz, fx
    e_v = (fx, 0.0, fz)
    e_u = (rx, 0.0, rz)
    sp = float(min(spacing_xz))
    ox, oz = origin_xz
    xs = (ox, ox + dem_w_cells * spacing_xz[0])
    zs = (oz, oz + dem_h_cells * spacing_xz[1])
    # cover the DEM bbox only — the camera ground point may sit outside
    # the grid (cam_iu/cam_iv just become out-of-range indices; the polar
    # scan offsets radial samples relative to them)
    us, vs = [], []
    for x in xs:
        for z in zs:
            du_ = (x - cam_xz[0]) * rx + (z - cam_xz[1]) * rz
            dv_ = (x - cam_xz[0]) * fx + (z - cam_xz[1]) * fz
            us.append(du_)
            vs.append(dv_)
    m = margin_cells * sp
    u0, u1 = min(us) - m, max(us) + m
    v0, v1 = min(vs) - m, max(vs) + m
    n_u = int(math.ceil((u1 - u0) / sp)) + 1
    n_v = int(math.ceil((v1 - v0) / sp)) + 1
    n_u = ((n_u + round_to - 1) // round_to) * round_to
    n_v = ((n_v + round_to - 1) // round_to) * round_to
    return RotGridStatic(
        n_v=n_v, n_u=n_u, spacing=sp, u0=float(u0), v0=float(v0),
        e_u=e_u, e_v=e_v,
        cam_iu=float(-u0 / sp), cam_iv=float(-v0 / sp))


def rotate_heights(heights, rg: RotGridStatic,
                   origin_xz: Tuple[float, float],
                   spacing_xz: Tuple[float, float],
                   cam_xz: Tuple[float, float],
                   exaggeration: float = 1.0,
                   with_derivatives: bool = False):
    """Sample the bilinear height surface at the rotated grid nodes.

    Evaluating the piecewise-bilinear surface at arbitrary points is exact
    (the surface IS the bilinear interpolant of the grid values), so the
    rotated grid carries true surface heights, not a filtered copy.
    Out-of-DEM nodes get -1e30 (they never block and never get hit).

    with_derivatives=True additionally returns the EXACT bilinear-patch
    slope fields (d y/d u, d y/d v) at the sample points — the same normals
    the per-ray reference shades with (bilinear patch normals, faceted at
    cell scale), so sweep renders reproduce the reference's shading
    texture rather than a smoothed version of it.

    Returns (h_rot, valid) or (h_rot, valid, du, dv).
    """
    H, W = heights.shape
    iu = jnp.arange(rg.n_u, dtype=_F32)
    iv = jnp.arange(rg.n_v, dtype=_F32)
    u = rg.u0 + iu[None, :] * rg.spacing
    v = rg.v0 + iv[:, None] * rg.spacing
    x = cam_xz[0] + u * rg.e_u[0] + v * rg.e_v[0]
    z = cam_xz[1] + u * rg.e_u[2] + v * rg.e_v[2]
    fx = (x - origin_xz[0]) / spacing_xz[0]
    fz = (z - origin_xz[1]) / spacing_xz[1]
    valid = (fx >= 0.0) & (fx <= W - 1) & (fz >= 0.0) & (fz <= H - 1)
    ix = jnp.clip(jnp.floor(fx), 0, W - 2).astype(jnp.int32)
    iz = jnp.clip(jnp.floor(fz), 0, H - 2).astype(jnp.int32)
    ax = fx - ix
    az = fz - iz
    flat = heights.reshape(-1)
    base = iz * W + ix
    h00 = jnp.take(flat, base)
    h10 = jnp.take(flat, base + 1)
    h01 = jnp.take(flat, base + W)
    h11 = jnp.take(flat, base + W + 1)
    hv = (h00 * (1 - ax) * (1 - az) + h10 * ax * (1 - az)
          + h01 * (1 - ax) * az + h11 * ax * az) * exaggeration
    h_rot = jnp.where(valid, hv, _NEG)
    if not with_derivatives:
        return h_rot, valid
    dydx = (((h10 - h00) * (1 - az) + (h11 - h01) * az)
            * (exaggeration / spacing_xz[0]))
    dydz = (((h01 - h00) * (1 - ax) + (h11 - h10) * ax)
            * (exaggeration / spacing_xz[1]))
    dydx = jnp.where(valid, dydx, 0.0)
    dydz = jnp.where(valid, dydz, 0.0)
    # chain rule onto the rotated axes
    du = dydx * rg.e_u[0] + dydz * rg.e_u[2]
    dv = dydx * rg.e_v[0] + dydz * rg.e_v[2]
    return h_rot, valid, du, dv


def grid_derivatives(h_rot, valid, spacing: float):
    """Central-difference world-frame slope components (du, dv) on the
    rotated grid, ignoring invalid neighbors (one-sided at DEM edges)."""
    def diff(a, axis):
        fwd = jnp.roll(a, -1, axis=axis)
        bwd = jnp.roll(a, 1, axis=axis)
        vf = jnp.roll(valid, -1, axis=axis)
        vb = jnp.roll(valid, 1, axis=axis)
        # exclude wrapped edges
        if axis == 0:
            vf = vf.at[-1].set(False)
            vb = vb.at[0].set(False)
        else:
            vf = vf.at[:, -1].set(False)
            vb = vb.at[:, 0].set(False)
        num = jnp.where(vf, fwd, a) - jnp.where(vb, bwd, a)
        den = (vf.astype(_F32) + vb.astype(_F32)) * spacing
        return jnp.where(valid & (den > 0), num / jnp.maximum(den, 1e-9), 0.0)

    dv = diff(h_rot, 0)
    du = diff(h_rot, 1)
    return du, dv
