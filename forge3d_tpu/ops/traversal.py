# forge3d_tpu/ops/traversal.py
# Heightfield ray traversal over the min-max pyramid — the PROMETHEUS hot
# kernel, rebuilt in JAX.
#
# Reference behavior being matched (not copied):
#   /root/reference/src/shaders/hybrid_terrain_traversal.wgsl:193-314
#   - skip any node whose ray segment lies outside the node's [min, max]
#     height band; refine where the ray brackets the band; exact
#     ray/bilinear-patch solve at leaf cells (the vertical deviation along
#     the ray is exactly quadratic in t); front-to-back ⇒ first leaf hit is
#     the nearest; primary and shadow rays share the identical descent.
#
# Redesign: the reference walks the quadtree with a 64-entry
# per-thread stack and sorted child pushes — divergent pointer-chasing that
# is hostile to lockstep vector lanes. We instead run a *stackless front-to-back
# maxmip DDA*: every ray carries (t, level); at each step it looks up the
# pyramid node containing its current point, tests the height band over the
# node's ray span, then either descends one level (band overlap), advances
# past the node and coarsens (no overlap), or solves the leaf patch. All
# lanes execute the same uniform step inside one lax.while_loop, the pyramid
# is a single flat array accessed by one dynamic gather per step, and the
# whole loop fuses under XLA/Mosaic. Visit order remains strictly
# front-to-back, so results match the reference's sorted-stack descent: the
# same leaves get the same exact quadratic solve.

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pyramid import MinMaxPyramid

_F32 = jnp.float32
_I32 = jnp.int32

#: Fraction of a cell the probe point is nudged forward to land strictly
#: inside the next node after an advance (resolves floor() boundary ties).
_EPS_CELL = 2.0 ** -12


class TerrainScene(NamedTuple):
    """Device-resident heightfield scene (a pytree of arrays).

    Static geometry (cell counts, mip count, DEM dims) lives in
    :class:`TerrainSceneStatic` so jitted traversal specializes on it.

    Gather-packing: paired values ride single row gathers — `mm_pack`
    packs (min, max) per pyramid texel and `h_pair` packs (h[i], h[i+1])
    per DEM texel as (n, 2) f32 tables, halving the per-step gather count
    vs separate float tables.
    """

    heights_flat: jax.Array    # (h*w,) f32, exaggeration NOT applied
    h_pair: jax.Array          # (h*w, 2) f32: (h[i], h[i+1 in row])
    mm_pack: jax.Array         # (total, 2) f32: (min, max)
    level_offset: jax.Array    # (mips,) i32
    level_w: jax.Array         # (mips,) i32
    origin_xz: jax.Array       # (2,) f32
    spacing_xz: jax.Array      # (2,) f32
    exaggeration: jax.Array    # () f32


@dataclass(frozen=True)
class TerrainSceneStatic:
    dem_w: int
    dem_h: int
    cell_w: int
    cell_h: int
    mip_count: int
    max_iters: int


def scene_from_pyramid(
    pyr: MinMaxPyramid,
    origin_xz=(0.0, 0.0),
    spacing_xz=(1.0, 1.0),
    exaggeration: float = 1.0,
    max_iters: int | None = None,
) -> Tuple[TerrainScene, TerrainSceneStatic]:
    h, w = pyr.heights.shape
    if max_iters is None:
        # A ray crossing the whole grid visits O(perimeter) leaf cells, each
        # costing an advance plus bounded level moves; 4x is generous slack.
        max_iters = 4 * (pyr.cell_w + pyr.cell_h) + 16 * pyr.mip_count + 64
    hf = pyr.heights.ravel()
    h_next = np.concatenate([hf[1:], hf[-1:]])
    scene = TerrainScene(
        heights_flat=jnp.asarray(hf, _F32),
        h_pair=jnp.asarray(np.stack([hf, h_next], axis=1), _F32),
        mm_pack=jnp.asarray(np.stack([pyr.mm_min, pyr.mm_max], axis=1),
                            _F32),
        level_offset=jnp.asarray(pyr.level_offset, _I32),
        level_w=jnp.asarray(pyr.level_w, _I32),
        origin_xz=jnp.asarray(origin_xz, _F32),
        spacing_xz=jnp.asarray(spacing_xz, _F32),
        exaggeration=jnp.asarray(exaggeration, _F32),
    )
    static = TerrainSceneStatic(
        dem_w=w, dem_h=h, cell_w=pyr.cell_w, cell_h=pyr.cell_h,
        mip_count=pyr.mip_count, max_iters=int(max_iters),
    )
    return scene, static


class HitResult(NamedTuple):
    hit: jax.Array      # bool
    t: jax.Array        # f32 (tmax where missed)
    cell_x: jax.Array   # i32 (leaf cell of the hit; 0 where missed)
    cell_z: jax.Array   # i32


def _safe_inv(d):
    """Sign-preserving reciprocal with |d| clamped away from zero
    (reference: terrain_safe_inv, hybrid_terrain_traversal.wgsl:79-82)."""
    ad = jnp.maximum(jnp.abs(d), 1e-12)
    return jnp.where(d < 0.0, -1.0 / ad, 1.0 / ad)


def _slab_xz(rox, roz, inv_dx, inv_dz, x0, x1, z0, z1):
    tx0 = (x0 - rox) * inv_dx
    tx1 = (x1 - rox) * inv_dx
    tz0 = (z0 - roz) * inv_dz
    tz1 = (z1 - roz) * inv_dz
    t_enter = jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(tz0, tz1))
    t_exit = jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(tz0, tz1))
    return t_enter, t_exit


def _bilinear_h(h00, h10, h01, h11, u, v):
    return (h00 * (1 - u) + h10 * u) * (1 - v) + (h01 * (1 - u) + h11 * u) * v


def _cell_heights(scene: TerrainScene, static: TerrainSceneStatic, cx, cz):
    """Exaggerated corner heights (h00, h10, h01, h11) of DEM cell (cx, cz).

    Two row gathers fetch all four corners: h_pair[i] packs the
    row-adjacent pair (h[i], h[i+1])."""
    w = static.dem_w
    base = cz * w + cx
    ex = scene.exaggeration
    p0 = jnp.take(scene.h_pair, base, axis=0)
    p1 = jnp.take(scene.h_pair, base + w, axis=0)
    return (p0[..., 0] * ex, p0[..., 1] * ex,
            p1[..., 0] * ex, p1[..., 1] * ex)


def _leaf_intersect(scene, static, ro, rd, cx, cz, t0, t1, tmin, tmax):
    """Exact ray vs bilinear patch over [t0, t1]; d(t) is quadratic in t.

    Same quadratic-through-3-points construction and Citardauq root form as
    the reference leaf test (wgsl:122-177), so hits agree bit-for-bit up to
    f32 evaluation-order effects.
    """
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    h00, h10, h01, h11 = _cell_heights(scene, static, cx, cz)
    ox = scene.origin_xz[0]
    oz = scene.origin_xz[1]
    sx = scene.spacing_xz[0]
    sz = scene.spacing_xz[1]
    cxf = cx.astype(_F32)
    czf = cz.astype(_F32)

    def dev(t):
        px = rox + t * rdx
        pz = roz + t * rdz
        u = jnp.clip((px - ox) / sx - cxf, 0.0, 1.0)
        v = jnp.clip((pz - oz) / sz - czf, 0.0, 1.0)
        return (roy + t * rdy) - _bilinear_h(h00, h10, h01, h11, u, v)

    tm = 0.5 * (t0 + t1)
    d0 = dev(t0)
    dm = dev(tm)
    d1 = dev(t1)

    c = d0
    a = 2.0 * d1 + 2.0 * d0 - 4.0 * dm
    b = d1 - d0 - a

    # Linear fallback when a ~ 0.
    s_lin = -c / jnp.where(jnp.abs(b) > 1e-12, b, 1.0)
    lin_ok = (jnp.abs(b) > 1e-12) & (s_lin >= 0.0) & (s_lin <= 1.0)

    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.where(b >= 0.0, sq, -sq))
    safe_a = jnp.where(jnp.abs(a) < 1e-12, 1.0, a)
    r0 = q / safe_a
    r1 = jnp.where(jnp.abs(q) < 1e-30, 1e30, c / jnp.where(jnp.abs(q) < 1e-30, 1.0, q))
    rlo = jnp.minimum(r0, r1)
    rhi = jnp.maximum(r0, r1)
    s_quad = jnp.where(
        (rlo >= 0.0) & (rlo <= 1.0), rlo,
        jnp.where((rhi >= 0.0) & (rhi <= 1.0), rhi, 1e30),
    )
    quad_ok = (disc >= 0.0) & (s_quad <= 1.0)

    is_lin = jnp.abs(a) < 1e-12
    s_hit = jnp.where(is_lin, jnp.where(lin_ok, s_lin, 1e30), jnp.where(quad_ok, s_quad, 1e30))
    t_hit = t0 + s_hit * (t1 - t0)
    ok = (s_hit <= 1.0) & (t_hit > tmin) & (t_hit < tmax)
    return ok, t_hit


def trace(
    scene: TerrainScene,
    static: TerrainSceneStatic,
    ro: Tuple[jax.Array, jax.Array, jax.Array],
    rd: Tuple[jax.Array, jax.Array, jax.Array],
    tmin=1e-3,
    tmax=1e30,
) -> HitResult:
    """Trace a batch of rays against the heightfield. Any array shape.

    `ro`/`rd` are (x, y, z) component arrays of identical shape. Returns the
    nearest hit per ray. Shadow (any-hit) queries use the same function —
    front-to-back order makes first hit == nearest hit.
    """
    rox, roy, roz = (x.astype(_F32) for x in ro)
    rdx, rdy, rdz = (x.astype(_F32) for x in rd)
    shape = jnp.broadcast_shapes(rox.shape, rdx.shape)
    rox, roy, roz, rdx, rdy, rdz = (
        jnp.broadcast_to(x, shape) for x in (rox, roy, roz, rdx, rdy, rdz)
    )

    tmin = jnp.asarray(tmin, _F32)
    tmax = jnp.asarray(tmax, _F32)

    ox = scene.origin_xz[0]
    oz = scene.origin_xz[1]
    sx = scene.spacing_xz[0]
    sz = scene.spacing_xz[1]
    cw = static.cell_w
    ch = static.cell_h
    top = static.mip_count - 1

    inv_dx = _safe_inv(rdx)
    inv_dz = _safe_inv(rdz)

    # Root-domain span: the logical (unpadded) cell rectangle in world space.
    dom_enter, dom_exit = _slab_xz(
        rox, roz, inv_dx, inv_dz,
        ox, ox + _F32(cw) * sx, oz, oz + _F32(ch) * sz,
    )
    t0 = jnp.maximum(dom_enter, tmin)
    t_exit = jnp.minimum(dom_exit, tmax)

    # Progress epsilon: a fixed fraction of a cell along the dominant lateral
    # axis, in ray-parameter units.
    lat = jnp.maximum(jnp.abs(rdx) / sx, jnp.abs(rdz) / sz)
    eps_t = _F32(_EPS_CELL) / jnp.maximum(lat, 1e-8)

    done0 = t0 > t_exit
    state = dict(
        t=t0,
        level=jnp.full(shape, top, _I32),
        done=done0,
        hit=jnp.zeros(shape, jnp.bool_),
        hit_t=jnp.full(shape, 1e30, _F32),
        cell_x=jnp.zeros(shape, _I32),
        cell_z=jnp.zeros(shape, _I32),
        iters=jnp.asarray(0, _I32),
    )

    def cond(s):
        return (~jnp.all(s["done"])) & (s["iters"] < static.max_iters)

    def body(s):
        t = s["t"]
        level = s["level"]

        # Probe point strictly inside the node being visited.
        pt = t + eps_t
        px = rox + pt * rdx
        pz = roz + pt * rdz
        cx = jnp.clip(jnp.floor((px - ox) / sx).astype(_I32), 0, cw - 1)
        cz = jnp.clip(jnp.floor((pz - oz) / sz).astype(_I32), 0, ch - 1)
        nx = cx >> level
        nz = cz >> level

        # Node world bounds, clamped to the logical domain at ragged edges
        # (reference wgsl:221-233).
        bx0 = (nx << level).astype(_F32)
        bx1 = jnp.minimum((nx + 1) << level, cw).astype(_F32)
        bz0 = (nz << level).astype(_F32)
        bz1 = jnp.minimum((nz + 1) << level, ch).astype(_F32)
        nt0, nt1 = _slab_xz(
            rox, roz, inv_dx, inv_dz,
            ox + bx0 * sx, ox + bx1 * sx, oz + bz0 * sz, oz + bz1 * sz,
        )
        nt0 = jnp.maximum(nt0, jnp.maximum(t, tmin))
        nt1 = jnp.minimum(nt1, t_exit)

        # Height-band test over this node's ray span.
        lvl_off = jnp.take(scene.level_offset, level)
        lvl_w = jnp.take(scene.level_w, level)
        flat = lvl_off + nz * lvl_w + nx
        mm = jnp.take(scene.mm_pack, flat, axis=0)
        bmin = mm[..., 0] * scene.exaggeration
        bmax = mm[..., 1] * scene.exaggeration
        ya = roy + nt0 * rdy
        yb = roy + nt1 * rdy
        band = (
            (nt0 <= nt1)
            & ~(jnp.minimum(ya, yb) > bmax)
            & ~(jnp.maximum(ya, yb) < bmin)
        )

        is_leaf = level == 0
        # Skip the leaf gathers entirely on iterations where no live lane is
        # at a banded leaf (a scalar cond, cheap vs two row gathers).
        any_leaf = jnp.any((~s["done"]) & band & is_leaf)
        leaf_ok, leaf_t = jax.lax.cond(
            any_leaf,
            lambda: _leaf_intersect(
                scene, static, (rox, roy, roz), (rdx, rdy, rdz),
                cx, cz, nt0, nt1, tmin, tmax,
            ),
            lambda: (jnp.zeros(shape, jnp.bool_), jnp.full(shape, 1e30, _F32)),
        )
        got_hit = (~s["done"]) & band & is_leaf & leaf_ok

        descend = (~s["done"]) & band & ~is_leaf
        advance = (~s["done"]) & ~got_hit & ~descend

        new_level = jnp.where(
            descend, level - 1, jnp.where(advance, jnp.minimum(level + 1, top), level)
        )
        # Monotone progress: step at least eps_t past the current point.
        new_t = jnp.where(advance, jnp.maximum(nt1, t + eps_t), t)
        exhausted = advance & (new_t >= t_exit)

        return dict(
            t=new_t,
            level=new_level,
            done=s["done"] | got_hit | exhausted,
            hit=s["hit"] | got_hit,
            hit_t=jnp.where(got_hit, leaf_t, s["hit_t"]),
            cell_x=jnp.where(got_hit, cx, s["cell_x"]),
            cell_z=jnp.where(got_hit, cz, s["cell_z"]),
            iters=s["iters"] + 1,
        )

    out = jax.lax.while_loop(cond, body, state)
    return HitResult(hit=out["hit"], t=jnp.where(out["hit"], out["hit_t"], tmax),
                     cell_x=out["cell_x"], cell_z=out["cell_z"])


def normal_at(scene: TerrainScene, static: TerrainSceneStatic, p, cell_x, cell_z):
    """Geometric normal from the analytic bilinear gradient at world point p
    inside cell (cell_x, cell_z) (reference wgsl:181-190)."""
    px, _, pz = p
    h00, h10, h01, h11 = _cell_heights(scene, static, cell_x, cell_z)
    ox = scene.origin_xz[0]
    oz = scene.origin_xz[1]
    sx = scene.spacing_xz[0]
    sz = scene.spacing_xz[1]
    u = jnp.clip((px - ox) / sx - cell_x.astype(_F32), 0.0, 1.0)
    v = jnp.clip((pz - oz) / sz - cell_z.astype(_F32), 0.0, 1.0)
    dh_du = (h10 - h00) * (1 - v) + (h11 - h01) * v
    dh_dv = (h01 - h00) * (1 - u) + (h11 - h10) * u
    nx = -dh_du / sx
    ny = jnp.ones_like(nx)
    nz = -dh_dv / sz
    inv = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv


def occluded(scene, static, ro, rd, max_distance=1e30, tmin=1e-3) -> jax.Array:
    """Shadow query: True where the segment [tmin, max_distance] is blocked
    (reference: terrain_occluded, wgsl:318-323)."""
    res = trace(scene, static, ro, rd, tmin=tmin, tmax=max_distance)
    return res.hit


# ---------------------------------------------------------------------------
# Brute-force oracle (tests only): exhaustive per-cell intersection in numpy.
# ---------------------------------------------------------------------------

def trace_bruteforce_numpy(
    heights: np.ndarray, origin_xz, spacing_xz, exaggeration,
    ro: np.ndarray, rd: np.ndarray, tmin=1e-3, tmax=1e30,
):
    """O(cells) per ray; the correctness oracle for `trace` in unit tests."""
    heights = np.asarray(heights, np.float64) * float(exaggeration)
    h, w = heights.shape
    ox, oz = float(origin_xz[0]), float(origin_xz[1])
    sx, sz = float(spacing_xz[0]), float(spacing_xz[1])
    ro = np.asarray(ro, np.float64).reshape(-1, 3)
    rd = np.asarray(rd, np.float64).reshape(-1, 3)
    n = ro.shape[0]
    out_t = np.full(n, tmax)
    out_hit = np.zeros(n, bool)

    def safe_inv(d):
        ad = max(abs(d), 1e-12)
        return -1.0 / ad if d < 0 else 1.0 / ad

    for i in range(n):
        o, d = ro[i], rd[i]
        ix, iz = safe_inv(d[0]), safe_inv(d[2])
        best = tmax
        for cz in range(h - 1):
            for cx in range(w - 1):
                x0, x1 = ox + cx * sx, ox + (cx + 1) * sx
                z0, z1 = oz + cz * sz, oz + (cz + 1) * sz
                tx0, tx1 = sorted(((x0 - o[0]) * ix, (x1 - o[0]) * ix))
                tz0, tz1 = sorted(((z0 - o[2]) * iz, (z1 - o[2]) * iz))
                t0 = max(tx0, tz0, tmin)
                t1 = min(tx1, tz1, best)
                if t0 > t1:
                    continue
                h00, h10 = heights[cz, cx], heights[cz, cx + 1]
                h01, h11 = heights[cz + 1, cx], heights[cz + 1, cx + 1]

                def dev(t):
                    px, pz = o[0] + t * d[0], o[2] + t * d[2]
                    u = min(max((px - ox) / sx - cx, 0.0), 1.0)
                    v = min(max((pz - oz) / sz - cz, 0.0), 1.0)
                    hh = (h00 * (1 - u) + h10 * u) * (1 - v) + (h01 * (1 - u) + h11 * u) * v
                    return (o[1] + t * d[1]) - hh

                tmid = 0.5 * (t0 + t1)
                d0, dm, d1 = dev(t0), dev(tmid), dev(t1)
                c = d0
                a = 2 * d1 + 2 * d0 - 4 * dm
                b = d1 - d0 - a
                s_hit = None
                if abs(a) < 1e-12:
                    if abs(b) > 1e-12:
                        s = -c / b
                        if 0.0 <= s <= 1.0:
                            s_hit = s
                else:
                    disc = b * b - 4 * a * c
                    if disc >= 0:
                        sq = np.sqrt(disc)
                        q = -0.5 * (b + (sq if b >= 0 else -sq))
                        r0 = q / a
                        r1 = c / q if abs(q) > 1e-30 else np.inf
                        r0, r1 = min(r0, r1), max(r0, r1)
                        if 0.0 <= r0 <= 1.0:
                            s_hit = r0
                        elif 0.0 <= r1 <= 1.0:
                            s_hit = r1
                if s_hit is not None:
                    t = t0 + s_hit * (t1 - t0)
                    if tmin < t < best:
                        best = t
        if best < tmax:
            out_t[i] = best
            out_hit[i] = True
    return out_hit, out_t
