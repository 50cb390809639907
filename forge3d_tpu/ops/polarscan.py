# forge3d_tpu/ops/polarscan.py
# Polar primary-visibility scan: per-pixel heightfield ray casting without
# a per-ray marching loop.
#
# Reference behavior being replaced (not copied): the primary camera-ray
# pass of the terrain PT (reference shader hybrid_terrain_traversal.wgsl:
# 193-314, quadtree descent). Instead of marching each ray, this module
# exploits that ALL primary rays share one origin:
#
#   * every ray lies in a vertical plane through the camera, indexed by its
#     horizontal azimuth tangent tan(beta) relative to the camera's forward;
#   * the intersection of that plane with the height surface is a 1D height
#     profile, sampled where the plane crosses each camera-aligned grid row
#     (a per-row 2-tap lerp);
#   * along a profile, the running maximum M(k) of the sample elevation
#     tangents is monotone, so the FIRST crossing of a ray at elevation
#     tangent q is also the first k with M(k) >= q — first-hit for a whole
#     column of rays becomes one cumulative max plus a first-crossing
#     indicator contraction, no marching loop at all;
#   * the (tan(beta), q) "polar" radiance image is warped to the screen once
#     per resolve with a per-row 2-tap azimuth resample.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_F32 = jnp.float32
_NEG = jnp.float32(-1.0e30)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class PolarStatic:
    """Static polar-scan geometry (python floats; jitted programs
    specialize on the camera, which is static per render).

    SCREEN-ALIGNED ROWS: polar elevation rows are parameterized by screen
    NDC-y (row e sits at ndc_y = 1 - (e + 0.5) * y_step), not by uniform
    elevation tangent. For a roll-free camera, cu = ndc_x * hw exactly and
    cv(y) = fv + y * uvhh, so a polar row maps 1:1 onto a (supersampled)
    screen row and the final screen resolve needs only a per-row 1D
    azimuth resample plus a vertical box average. A ray's elevation
    comparison uses the REDUCED tangent
    Q(y) = dy(y)/cv(y) = (h_hit - cam_y)/(horizontal-forward distance),
    which is azimuth-independent, so the first-crossing contraction is
    unchanged in structure.
    """

    a_count: int       # azimuth columns
    e_count: int       # elevation rows = row_ss * height + pad
    e_pad: int         # trailing pad rows (ignored by the resolve)
    row_ss: int        # vertical supersampling factor (rows per pixel row)
    k_count: int       # radial samples (camera-aligned grid rows)
    k0: int            # first rotated-grid row index used (floor(cam_iv))
    t_lo: float        # tan(beta) of azimuth column 0
    t_step: float
    y_step: float      # ndc-y per polar row (rows run top -> bottom)
    hw: float          # tan(fov_x/2)
    fy: float          # fwd . y-hat
    uyhh: float        # (up . y-hat) * tan(fov_y/2)
    fv: float          # fwd . e_v
    uvhh: float        # (up . e_v) * tan(fov_y/2)
    cam_y: float
    # world-frame unit axes of the rotated grid (horizontal)
    e_u: Tuple[float, float, float]
    e_v: Tuple[float, float, float]
    cam_iu: float      # camera ground position in grid index units
    cam_iv: float
    spacing: float

    def ndc_rows(self, je=0.0):
        """ndc-y of each polar row center (+ sub-row jitter je)."""
        e = jnp.arange(self.e_count, dtype=_F32)
        return 1.0 - (e + 0.5 + je) * self.y_step

    def q_rows(self, je=0.0):
        """Reduced elevation tangent Q = dy/cv of each polar row."""
        ndc = self.ndc_rows(je)
        cv = jnp.maximum(self.fv + ndc * self.uvhh, 0.02)
        return (self.fy + ndc * self.uyhh) / cv


def plan_polar(*, width: int, height: int, fov_y_deg: float,
               right, up, fwd, cam_y: float,
               rg_n_v: int, rg_n_u: int, rg_spacing: float,
               e_u, e_v, cam_iu: float, cam_iv: float,
               density: float = 1.3, max_axis: int = 4096,
               row_ss: int = 2) -> PolarStatic:
    """Size the polar grid from the camera frustum.

    Requires a roll-free camera whose forward has a horizontal component
    (d . e_v > 0 for every frustum ray); raises ValueError otherwise — the
    caller falls back to the per-ray traversal engines for exotic cameras.
    """
    right = np.asarray(right, np.float64)
    up_v = np.asarray(up, np.float64)
    fwd = np.asarray(fwd, np.float64)
    e_u3 = np.asarray(e_u, np.float64)
    e_v3 = np.asarray(e_v, np.float64)
    if abs(float(right[1])) > 1e-3:
        raise ValueError("polar scan requires a roll-free camera")
    hh = math.tan(math.radians(fov_y_deg) * 0.5)
    hw = hh * (width / height)
    # probe frustum directions on a dense border grid for coverage bounds
    xs = np.linspace(-1.0, 1.0, 9)
    ys = np.linspace(-1.0, 1.0, 9)
    gx, gy = np.meshgrid(xs, ys)
    d = (fwd[None, None, :]
         + gx[..., None] * hw * right[None, None, :]
         + gy[..., None] * hh * up_v[None, None, :])
    cu = d @ e_u3
    cv = d @ e_v3
    if float(cv.min()) < 0.05:
        raise ValueError(
            "frustum contains near-vertical rays; polar scan unsupported "
            "(fall back to traversal='dda')")
    tanb = cu / cv
    t_margin = 0.02 * (tanb.max() - tanb.min() + 1e-6)
    t_lo, t_hi = float(tanb.min() - t_margin), float(tanb.max() + t_margin)

    # azimuth density: a touch denser than the densest screen mapping so
    # the horizontal resolve never undersamples
    dt_pix = (2.0 * hw / width) / float(cv.max())
    a_count = _round_up(int(math.ceil((t_hi - t_lo) / (dt_pix / density))), 128)
    a_count = min(a_count, max_axis)

    # screen-aligned elevation rows: row_ss rows per output pixel row
    rows = int(row_ss) * int(height)
    e_count = _round_up(rows, 8)

    # first radial row: just past the camera when it sits inside the grid,
    # else the grid start (the grid covers only the DEM bbox; the camera
    # may be far outside it)
    k0 = min(max(int(math.floor(cam_iv)), 0), max(rg_n_v - 12, 0))
    k_count = max(rg_n_v - k0 - 3, 8)
    return PolarStatic(
        a_count=a_count, e_count=e_count, e_pad=e_count - rows,
        row_ss=int(row_ss), k_count=k_count, k0=k0,
        t_lo=t_lo, t_step=(t_hi - t_lo) / a_count,
        y_step=2.0 / rows, hw=float(hw),
        fy=float(fwd[1]), uyhh=float(hh * up_v[1]),
        fv=float(fwd @ e_v3), uvhh=float(hh * (up_v @ e_v3)),
        cam_y=float(cam_y), e_u=tuple(map(float, e_u3)),
        e_v=tuple(map(float, e_v3)), cam_iu=float(cam_iu),
        cam_iv=float(cam_iv), spacing=float(rg_spacing))


def polar_directions(ps: PolarStatic, ja=0.0, je=0.0):
    """World-frame unit direction for each (elevation, azimuth) polar texel
    center (+ sub-texel jitter). The true elevation tangent of texel (e, a)
    is q = Q(e) / sec(beta_a) (screen-aligned rows; see PolarStatic)."""
    t = ps.t_lo + (jnp.arange(ps.a_count, dtype=_F32) + 0.5 + ja) * ps.t_step
    qr = ps.q_rows(je)                                    # (E,) reduced
    inv_sec = jax.lax.rsqrt(1.0 + t * t)
    q = qr[:, None] * inv_sec[None, :]                    # (E, A) true tan
    inv_h = inv_sec
    hx = (ps.e_v[0] + t * ps.e_u[0]) * inv_h
    hz = (ps.e_v[2] + t * ps.e_u[2]) * inv_h
    inv = jax.lax.rsqrt(1.0 + q * q)
    dx = hx[None, :] * inv
    dz = hz[None, :] * inv
    dy = q * inv
    return dx, dy, dz, t, qr


def extract_profiles(rotbuf, ps: PolarStatic, *, xi=0.0, ja=0.0):
    """Sample per-azimuth profiles from the rotated channel buffer.

    rotbuf: (n_v, n_u, C) — channel 0 MUST be world height (used for the
    out-of-range mask). xi in [0, 1): radial phase jitter (fraction of a
    row); ja in [-0.5, 0.5): azimuth grid jitter (sub-texel).
    Radial sample k lives at grid row k0 + k + 1 + xi, i.e. at horizontal
    offset (k0 + k + 1 + xi - cam_iv) rows past the camera; its column
    position p is read as a 2-tap gather + lerp (the hat-weight
    interpolant restricted to its two non-zero taps, so a tap outside the
    grid contributes nothing). Pure elementwise f32: no matrix product,
    so heights keep full precision on every backend.
    Returns profiles (K, A, C).
    """
    n_v, n_u, C = rotbuf.shape
    K, A = ps.k_count, ps.a_count
    t = ps.t_lo + (jnp.arange(A, dtype=_F32) + 0.5 + ja) * ps.t_step
    # radial row lerp commutes with the column interpolation
    src = (1.0 - xi) * jax.lax.dynamic_slice_in_dim(rotbuf, ps.k0 + 1, K, 0) \
        + xi * jax.lax.dynamic_slice_in_dim(rotbuf, ps.k0 + 2, K, 0)
    koff = jnp.arange(K, dtype=_F32) + (ps.k0 + 1.0 - ps.cam_iv) + xi
    p = ps.cam_iu + koff[:, None] * t[None, :]               # (K, A)
    prof = _lerp_taps(src, jnp.clip(p, -1.0, float(n_u)), n_u)
    # out-of-grid samples must read as "no terrain": mask the height
    # channel to -1e30 (other channels are only consumed where hit)
    oob = (p < 0.0) | (p > n_u - 1)
    h = jnp.where(oob, _NEG, prof[..., 0])
    return jnp.concatenate([h[..., None], prof[..., 1:]], axis=-1)


def _lerp_taps(src, pos, n: int):
    """Linear interpolation of src (R, n, C) at positions pos (R, P)
    along axis 1: taps floor(pos) and floor(pos) + 1 with weights 1 - f
    and f; taps outside [0, n) get weight 0. Returns (R, P, C)."""
    j0f = jnp.floor(pos)
    f = pos - j0f
    j0 = j0f.astype(jnp.int32)
    j1 = j0 + 1
    w0 = jnp.where((j0 >= 0) & (j0 < n), 1.0 - f, 0.0)
    w1 = jnp.where((j1 >= 0) & (j1 < n), f, 0.0)
    g0 = jnp.take_along_axis(src, jnp.clip(j0, 0, n - 1)[..., None], axis=1)
    g1 = jnp.take_along_axis(src, jnp.clip(j1, 0, n - 1)[..., None], axis=1)
    return w0[..., None] * g0 + w1[..., None] * g1


def profile_hit_tangents(h_prof, ps: PolarStatic, xi=0.0, ja=0.0):
    """REDUCED elevation tangent of each profile sample as seen from the
    camera (rise over horizontal-FORWARD distance — azimuth-independent,
    comparable directly against PolarStatic.q_rows), plus the true ray
    distance to the sample. Returns (q_red, t_dist)."""
    K, A = h_prof.shape
    t = ps.t_lo + (jnp.arange(A, dtype=_F32) + 0.5 + ja) * ps.t_step
    sec2 = (1.0 + t * t)[None, :]
    base = ps.k0 + 1.0 - ps.cam_iv                        # static offset
    koff = jnp.arange(K, dtype=_F32) + base + xi
    s_f = koff[:, None] * ps.spacing                      # (K, 1) forward
    rise = h_prof - ps.cam_y
    q_red = rise / jnp.maximum(s_f, 1e-6)
    # out-of-DEM samples carry h = -1e30; clamp the tangent to a finite
    # sentinel (still far below any real ray tangent) so downstream
    # squaring can't overflow to inf and poison 0*inf = NaN in the
    # first-crossing contraction. Rows at/behind the camera (possible when
    # the camera ground point is past the grid) can never be hit.
    q_red = jnp.clip(q_red, -1e4, 1e4)
    q_red = jnp.where(koff[:, None] > 0.25, q_red, -1e4)
    t_dist = jnp.maximum(s_f, 1e-6) * jnp.sqrt(sec2 + q_red * q_red)
    return q_red, t_dist


def synthesize_polar(values, q_prof, miss_values, ps: PolarStatic,
                     je=0.0, a_chunk: int = 128):
    """First-hit contraction: polar(e, a, c) = values at the first profile
    sample whose running-max REDUCED tangent crosses the row tangent Q(e);
    rays with no crossing get miss_values.

    values:      (K, A, C) per-profile-sample shaded values
    q_prof:      (K, A) sample reduced elevation tangents
    miss_values: (E, A, C) environment values
    Returns (E, A, C).
    """
    K, A, C = values.shape
    E = ps.e_count
    M = jax.lax.cummax(q_prof, axis=0)                    # (K, A) monotone
    q_e = ps.q_rows(je)                                   # (E,) reduced

    # Sub-row crossing interpolation via a SOFT cumulative indicator: the
    # true intersection lies between radial rows k and k+1 when
    # M[k] < Q <= M[k+1]; snapping values to the first row past the
    # crossing quantizes silhouettes and the heightfield front boundary
    # to the radial row pitch (a systematic ~half-row bias — the dominant
    # sweep<->per-ray residual). The cumulative
    #   alpha[k] = clip((M[k+1] - Q) / (M[k+1] - M[k]), 0, 1)
    # rises from 0 to 1 ACROSS the crossing, so its difference spreads
    # the one-hot into lerp weights (1-f, f) on the two straddling rows
    # with f = (Q - M[k]) / (M[k+1] - M[k]) — the exact crossing
    # fraction. Same single C-channel contraction as the hard one-hot:
    # the anti-aliasing is purely elementwise on the (E, K, A) indicator.
    # last row repeats itself: alpha[K-1] degenerates to the HARD test
    # M[K-1] >= Q, so hit_any (read from the last row) stays exact
    m_next = jnp.concatenate([M[1:], M[-1:]], axis=0)
    m_rden = 1.0 / jnp.maximum(m_next - M, 1e-9)    # reciprocal: the
    # (E, K, A) indicator then needs one multiply, not a divide

    def do_chunk(args):
        m_c, dn_c, v_c = args                 # (K, Ac), (K, Ac), (K, Ac, C)
        alpha = jnp.clip((m_c[None, :, :] - q_e[:, None, None])
                         * dn_c[None, :, :], 0.0, 1.0)    # (E, K, Ac)
        cross = alpha - jnp.concatenate(
            [jnp.zeros((E, 1, alpha.shape[2]), _F32), alpha[:, :-1]],
            axis=1)
        # HIGHEST: the values carry hit distance and normals, which a TF32
        # product (~10 mantissa bits) would round visibly. (bf16 storage
        # of both operands ran the stage 1.55x faster on an H100 and
        # rounds depth to 8 bits — PERF.md.)
        out = jnp.einsum("eka,kac->eac", cross, v_c,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=_F32)
        hit_any = alpha[:, -1, :]                         # (E, Ac)
        return out, hit_any

    n_chunks = (A + a_chunk - 1) // a_chunk
    Ap = n_chunks * a_chunk
    m_p = jnp.pad(m_next, ((0, 0), (0, Ap - A)))
    dn_p = jnp.pad(m_rden, ((0, 0), (0, Ap - A)), constant_values=1.0)
    v_p = jnp.pad(values, ((0, 0), (0, Ap - A), (0, 0)))
    out, hit_any = jax.lax.map(
        do_chunk,
        (m_p.reshape(K, n_chunks, a_chunk).transpose(1, 0, 2),
         dn_p.reshape(K, n_chunks, a_chunk).transpose(1, 0, 2),
         v_p.reshape(K, n_chunks, a_chunk, C).transpose(1, 0, 2, 3)))
    out = out.transpose(1, 0, 2, 3).reshape(E, Ap, C)[:, :A]
    hit_any = hit_any.transpose(1, 0, 2).reshape(E, Ap)[:, :A]
    return out + (1.0 - hit_any[..., None]) * miss_values


def warp_to_screen(polar, ps: PolarStatic, *, width: int, height: int,
                   supersample: int = 2):
    """Resolve the screen-aligned polar image to the screen.

    polar: (E, A, C) -> (height, width, C). Vertical: polar rows ARE
    supersampled screen rows (ps.row_ss per pixel row) — a box average.
    Horizontal: per-row 1D azimuth resample at `supersample` box-filtered
    sub-positions, each a 2-tap gather + lerp along the azimuth axis.
    """
    E, A, C = polar.shape
    if height * ps.row_ss != E - ps.e_pad:
        raise ValueError(
            f"polar rows {E}-{ps.e_pad} do not match height {height} * "
            f"row_ss {ps.row_ss}")
    ss = max(int(supersample), 1)
    ndc_rows = 1.0 - (np.arange(E, dtype=np.float64) + 0.5) * ps.y_step
    cv_rows = jnp.asarray(np.maximum(ps.fv + ndc_rows * ps.uvhh, 0.02), _F32)
    # sub-pixel ndc-x positions (box filter over `ss` sub-positions)
    sub = (np.arange(ss, dtype=np.float64) + 0.5) / ss
    ndc_x = ((np.arange(width, dtype=np.float64)[:, None] + sub[None, :])
             / width) * 2.0 - 1.0                          # (W, ss)
    ndc_x = jnp.asarray(ndc_x, _F32)
    # a_f(row, x, sub): azimuth position of the sub-pixel ray
    tanb = ndc_x[None, :, :] * (ps.hw / cv_rows)[:, None, None]
    a_f = jnp.clip((tanb - ps.t_lo) / ps.t_step - 0.5, 0.0, A - 1.0)
    out = _lerp_taps(polar, a_f.reshape(E, width * ss), A)
    out = out.reshape(E, width, ss, C).sum(axis=2) * (1.0 / ss)
    out = out[:E - ps.e_pad]
    return out.reshape(height, ps.row_ss, width, C).mean(axis=1)
