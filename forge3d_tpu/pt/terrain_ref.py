# forge3d_tpu/pt/terrain_ref.py
# PROMETHEUS: converged path-traced terrain reference — the north-star
# workload, rebuilt in JAX.
#
# Reference behavior being matched (not copied):
#   - Entry + defaults: /root/reference/src/py_functions/path_tracing/
#     terrain_reference.rs:55-110 (signature, camera dict, sun defaults,
#     dict return with rgba/albedo/normal/depth/frames/variance/converged
#     and memory diagnostics).
#   - Estimator: src/shaders/hybrid_terrain_traversal.wgsl:385-550
#     (spp jittered tent samples, sun NEE through the merged ReSTIR
#     reservoir, one cosine env sample per camera sample, Reinhard on the
#     running mean, AOVs from the unjittered center ray on frame 0).
#   - Driver loop: src/path_tracing/hybrid_compute/render_terrain.rs
#     (WELFORD_WINDOW=32 windowed variance of the running-mean luminance,
#     convergence checks at window boundaries, fail-closed on
#     non-convergence, ReSTIR temporal+spatial reuse between frames,
#     runtime-contract range checks on readback).
#
# Design: the per-frame wgpu dispatch chain becomes ONE jitted
# function with donated accumulator/welford/reservoir buffers — XLA fuses
# the sample loop (lax.fori_loop over spp) with shading and accumulation, so
# a frame is a single device program. The host loop only reads back one
# scalar (max windowed variance) every 32 frames. Multi-chip scaling
# tile-shards the pixel grid (forge3d_tpu.parallel).

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import camera_basis
from ..errors import ContractViolation, ConvergenceError, RenderError, UploadError
from ..mem import global_tracker
from ..ops import restir as rst
from ..ops import tonemap as tm
from ..ops.pyramid import build_pyramid
from ..ops.rng import derive_seed_lo, seed_state, tent_offset, xorshift32
from ..ops.shading import EnvMap, cosine_dir, env_radiance, luminance, sun_direction
from ..ops.traversal import (
    TerrainScene,
    TerrainSceneStatic,
    normal_at,
    scene_from_pyramid,
    trace,
)

_F32 = jnp.float32

WELFORD_WINDOW = 32


@dataclass(frozen=True)
class TerrainRefDesc:
    """Full scene description (mirrors TerrainReferenceDesc semantics)."""

    heights: np.ndarray
    spacing: Tuple[float, float] = (1.0, 1.0)
    exaggeration: float = 1.0
    albedo: Tuple[float, float, float] = (0.6, 0.6, 0.6)
    cam_origin: Tuple[float, float, float] = (0.0, 50.0, 120.0)
    cam_look_at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cam_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_deg: float = 45.0
    exposure: float = 1.0
    sun_azimuth_deg: float = 315.0
    sun_elevation_deg: float = 45.0
    sun_intensity: float = 2.5
    sun_color: Tuple[float, float, float] = (1.0, 0.97, 0.92)
    env_map: Optional[np.ndarray] = None
    env_intensity: float = 0.35
    width: int = 512
    height: int = 512
    seed: int = 7
    spp: int = 1
    max_frames: int = 512
    min_frames: int = 32
    variance_threshold: float = 1e-3
    shadows_enabled: bool = True
    #: "dda" = stackless maxmip DDA (ops/traversal), the per-ray engine;
    #: "sweep" = the sweep estimator (pt/terrain_sweep).
    traversal: str = "dda"
    #: Shade the sun through the ReSTIR temporal+spatial reuse chain
    #: (reference behavior — note the reference's spatial pass mixes
    #: selection-pdf and luminance units for directional lights, so the
    #: converged reuse weight is NOT 1; we reproduce that faithfully).
    #: False = plain sun NEE with unit weight — the mathematically exact
    #: single-directional-light estimator, and the integral the sweep
    #: renderer (pt/terrain_sweep.py) computes.
    restir: bool = True
    #: Additional typed lights (lighting.Light tuple) integrated by
    #: alias-table NEE — one light sample per camera sample, selection
    #: weighted by emitted power (ref: src/path_tracing/alias_table.rs,
    #: importance.rs). None = sun + env only (reference default).
    lights: Optional[tuple] = None
    #: Optional triangle mesh mixed into the scene ((N,3) f32 vertices,
    #: (M,3) u32 indices) — the reference's HybridScene seam
    #: (render_terrain.rs:239-241, hybrid_traversal.wgsl:175-201:
    #: closest-of(mesh BVH, terrain) for primary AND shadow rays, shaded
    #: with the same albedo/NEE contract).
    mesh: Optional[tuple] = None


def _validate(desc: TerrainRefDesc) -> None:
    """Trust-boundary validation before any device work
    (reference: validate_desc, render_terrain.rs:447-505)."""
    if desc.width <= 0 or desc.height <= 0 or desc.max_frames <= 0:
        raise RenderError("terrain reference requires non-zero width/height/max_frames")
    if desc.spp <= 0:
        raise RenderError("spp must be >= 1")
    hm = np.asarray(desc.heights)
    if hm.ndim != 2 or hm.shape[0] < 2 or hm.shape[1] < 2:
        raise UploadError("heightmap must be a 2D array of at least 2x2 texels")
    if not np.isfinite(hm).all():
        raise UploadError("terrain heightfield contains non-finite samples")
    if not (desc.spacing[0] > 0 and desc.spacing[1] > 0):
        raise RenderError("spacing must be positive")
    if not math.isfinite(desc.exaggeration) or desc.exaggeration <= 0:
        raise RenderError("exaggeration must be finite and > 0")
    if not (math.isfinite(desc.sun_azimuth_deg) and math.isfinite(desc.sun_elevation_deg)):
        raise RenderError("sun azimuth/elevation must be finite")
    for name, vec in (("cam_origin", desc.cam_origin),
                      ("cam_look_at", desc.cam_look_at),
                      ("cam_up", desc.cam_up)):
        if len(vec) != 3 or not all(math.isfinite(float(c)) for c in vec):
            raise RenderError(f"{name} must be a finite 3-vector")
    fwd = tuple(float(b) - float(a)
                for a, b in zip(desc.cam_origin, desc.cam_look_at))
    if sum(c * c for c in fwd) <= 1e-20:
        raise RenderError("camera origin and look_at coincide")
    if not (math.isfinite(desc.fov_y_deg) and 0.0 < desc.fov_y_deg < 180.0):
        raise RenderError("fov_y must be finite and in (0, 180)")
    if not (math.isfinite(desc.variance_threshold) and desc.variance_threshold > 0):
        raise RenderError("variance threshold must be finite and > 0")
    if desc.env_map is not None:
        em = np.asarray(desc.env_map)
        if em.ndim != 3 or em.shape[2] != 3:
            raise UploadError("env_map must have shape (H, W, 3)")
    for c in desc.sun_color:
        if not math.isfinite(c) or c < 0:
            raise RenderError("sun_color must be finite and non-negative")


def _camera_rays(desc: TerrainRefDesc, jx, jy):
    """Primary ray directions for pixel jitters (jx, jy) of shape (H, W)."""
    W, H = desc.width, desc.height
    right, up, fwd = camera_basis(desc.cam_origin, desc.cam_look_at, desc.cam_up)
    half_h = math.tan(math.radians(desc.fov_y_deg) * 0.5)
    half_w = (W / H) * half_h
    xs = jax.lax.broadcasted_iota(_F32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(_F32, (H, W), 0)
    ndc_x = ((xs + 0.5 + jx) / W) * 2.0 - 1.0
    ndc_y = (1.0 - (ys + 0.5 + jy) / H) * 2.0 - 1.0
    cx = ndc_x * half_w
    cy = ndc_y * half_h
    cz = -1.0
    inv = jax.lax.rsqrt(cx * cx + cy * cy + 1.0)
    cx, cy, cz = cx * inv, cy * inv, cz * inv
    # world = cx*right + cy*up + cz*(-forward); cz = -1 so this adds +forward
    dx = cx * right[0] + cy * up[0] + (-cz) * fwd[0]
    dy = cx * right[1] + cy * up[1] + (-cz) * fwd[1]
    dz = cx * right[2] + cy * up[2] + (-cz) * fwd[2]
    inv2 = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv2, dy * inv2, dz * inv2


def _make_frame_step(
    desc: TerrainRefDesc,
    static: TerrainSceneStatic,
    mesh_nodes: int = 0,
):
    """Build the per-frame device program. The scene tables and env map are
    RUNTIME ARGUMENTS of the returned function, not closure constants —
    closed-over arrays become jaxpr constants, which both explodes compile
    time and re-ships the tables through the runtime on every call."""
    W, H = desc.width, desc.height
    n_pix = W * H
    spp = int(desc.spp)
    seed_hi = int(desc.seed) & 0xFFFFFFFF
    seed_lo = derive_seed_lo(desc.seed)
    lc = tuple(desc.sun_intensity * c for c in desc.sun_color)
    albedo = desc.albedo
    shadows = bool(desc.shadows_enabled)

    sun = sun_direction(desc.sun_azimuth_deg, desc.sun_elevation_deg)
    sun = tuple(jnp.asarray(s, _F32) for s in sun)

    light_buf = None
    alias = None
    if desc.lights:
        from ..lighting import LightBuffer
        from ..ops.lightsample import alias_table_build, light_power_weights

        light_buf = LightBuffer.from_lights(list(desc.lights))
        alias = alias_table_build(light_power_weights(light_buf))

    ox = jnp.full((H, W), desc.cam_origin[0], _F32)
    oy = jnp.full((H, W), desc.cam_origin[1], _F32)
    oz = jnp.full((H, W), desc.cam_origin[2], _F32)

    def _tr(scene, ro, rd):
        return trace(scene, static, ro, rd)

    if mesh_nodes:
        from ..ops.bvh import trace_mesh

        def _hyb_primary(scene, mesh, ro, rd):
            """closest-of(mesh BVH, terrain), merged normal
            (hybrid_traversal.wgsl:175-201)."""
            th = _tr(scene, ro, rd)
            msc, fnorm = mesh
            mh = trace_mesh(msc, mesh_nodes, ro, rd)
            tt = jnp.where(th.hit, th.t, jnp.float32(3.0e38))
            mesh_won = mh.hit & (mh.t < tt)
            t = jnp.where(mesh_won, mh.t, th.t)
            hitmask = th.hit | mh.hit
            hx = ro[0] + t * rd[0]
            hy = ro[1] + t * rd[1]
            hz = ro[2] + t * rd[2]
            nx, ny, nz = normal_at(scene, static, (hx, hy, hz),
                                   th.cell_x, th.cell_z)
            pid = jnp.maximum(mh.prim, 0)
            mnx = jnp.take(fnorm[:, 0], pid)
            mny = jnp.take(fnorm[:, 1], pid)
            mnz = jnp.take(fnorm[:, 2], pid)
            # two-sided: orient the face normal against the ray
            flip = (mnx * rd[0] + mny * rd[1] + mnz * rd[2]) > 0
            mnx = jnp.where(flip, -mnx, mnx)
            mny = jnp.where(flip, -mny, mny)
            mnz = jnp.where(flip, -mnz, mnz)
            nx = jnp.where(mesh_won, mnx, nx)
            ny = jnp.where(mesh_won, mny, ny)
            nz = jnp.where(mesh_won, mnz, nz)
            return t, hitmask, (hx, hy, hz), (nx, ny, nz), mesh_won

        def _occl_any(scene, mesh, ro, rd):
            """any-hit (intersect_shadow_ray tests both primitives)."""
            th = _tr(scene, ro, rd)
            mh = trace_mesh(mesh[0], mesh_nodes, ro, rd)
            tmin = jnp.minimum(jnp.where(th.hit, th.t, jnp.float32(3.0e38)),
                               jnp.where(mh.hit, mh.t, jnp.float32(3.0e38)))
            return th.hit | mh.hit, tmin
    else:
        def _hyb_primary(scene, mesh, ro, rd):
            th = _tr(scene, ro, rd)
            t = th.t
            hx = ro[0] + t * rd[0]
            hy = ro[1] + t * rd[1]
            hz = ro[2] + t * rd[2]
            n = normal_at(scene, static, (hx, hy, hz),
                          th.cell_x, th.cell_z)
            return t, th.hit, (hx, hy, hz), n, None

        def _occl_any(scene, mesh, ro, rd):
            th = _tr(scene, ro, rd)
            return th.hit, jnp.where(th.hit, th.t, jnp.float32(3.0e38))

    def sample_radiance(scene, mesh, env, st, prev_dir, prev_w, prev_ok):
        """One jittered camera sample; returns (st, rgb, cand_pdf)."""
        st, u1 = xorshift32(st)
        st, u2 = xorshift32(st)
        jx = tent_offset(u1) * 0.5
        jy = tent_offset(u2) * 0.5
        dx, dy, dz = _camera_rays(desc, jx, jy)
        t, hitmask, (hx, hy, hz), (nx, ny, nz), mesh_won = _hyb_primary(
            scene, mesh, (ox, oy, oz), (dx, dy, dz))
        if mesh_won is not None:
            # mesh hits keep the legacy constant albedo
            # (hybrid_traversal.wgsl:233-241 get_surface_properties)
            ar = jnp.where(mesh_won, _F32(0.7), _F32(albedo[0]))
            ag = jnp.where(mesh_won, _F32(0.7), _F32(albedo[1]))
            ab = jnp.where(mesh_won, _F32(0.8), _F32(albedo[2]))
        else:
            ar, ag, ab = albedo

        # miss -> environment radiance along the primary ray
        mr, mg, mb = env_radiance(env, dx, dy, dz)

        # sun candidate target pdf (streaming RIS with a single directional
        # light: w = target_pdf, selection pdf 1; wgsl:440-452)
        ndotl = jnp.maximum(nx * sun[0] + ny * sun[1] + nz * sun[2], 0.0)
        tpdf = luminance(ar * lc[0] * ndotl, ag * lc[1] * ndotl,
                         ab * lc[2] * ndotl)
        cand_pdf = jnp.where(hitmask, tpdf, 0.0)

        # sun shading through the merged reservoir from the previous frame
        sdx = jnp.where(prev_ok, prev_dir[0], sun[0])
        sdy = jnp.where(prev_ok, prev_dir[1], sun[1])
        sdz = jnp.where(prev_ok, prev_dir[2], sun[2])
        rw = jnp.where(prev_ok, jnp.clip(prev_w, 0.0, 4.0), 1.0)
        nd = jnp.maximum(nx * sdx + ny * sdy + nz * sdz, 0.0)

        # env-sample RNG draws happen before the occlusion queries so the
        # stream consumption matches the reference exactly
        st2, u3 = xorshift32(st)
        st2, u4 = xorshift32(st2)
        # misses do not consume u3/u4 (reference `continue`)
        st = jnp.where(hitmask, st2, st)
        ex, ey, ez = cosine_dir(nx, ny, nz, u3, u4)

        # ONE batched occlusion trace for sun + env rays: per-ray results
        # are independent, so stacking is bitwise-identical to two calls
        # while halving the while_loop executions.
        oro = (hx + nx * 1e-3, hy + ny * 1e-3, hz + nz * 1e-3)
        if shadows:
            occ2, _ = _occl_any(
                scene, mesh,
                tuple(jnp.stack([c, c]) for c in oro),
                (jnp.stack([jnp.broadcast_to(sdx, ex.shape), ex]),
                 jnp.stack([jnp.broadcast_to(sdy, ey.shape), ey]),
                 jnp.stack([jnp.broadcast_to(sdz, ez.shape), ez])))
            occ = occ2[0]
            eocc = occ2[1]
            vis = jnp.where(occ, 0.0, 1.0)
        else:
            eocc, _ = _occl_any(scene, mesh, oro, (ex, ey, ez))
            vis = jnp.ones_like(nd)
        lit = nd * vis * rw
        sun_r = ar * lc[0] * lit
        sun_g = ag * lc[1] * lit
        sun_b = ab * lc[2] * lit

        er, eg, eb = env_radiance(env, ex, ey, ez)
        evis = jnp.where(eocc, 0.0, 1.0)
        ibl_r = ar * er * evis
        ibl_g = ag * eg * evis
        ibl_b = ab * eb * evis

        lr = lg = lb = 0.0
        if light_buf is not None:
            from ..ops.lightsample import sample_light_nee

            st, u5 = xorshift32(st)
            st, u6 = xorshift32(st)
            st, u7 = xorshift32(st)
            ldx, ldy, ldz, ldist, wr, wg, wb = sample_light_nee(
                light_buf, alias, hx, hy, hz, nx, ny, nz, u5, u6, u7)
            _, lt = _occl_any(scene, mesh, oro, (ldx, ldy, ldz))
            locc = lt < ldist * 0.999
            lvis = jnp.where(locc, 0.0, 1.0)
            lr = ar * wr * lvis
            lg = ag * wg * lvis
            lb = ab * wb * lvis

        r = jnp.where(hitmask, sun_r + ibl_r + lr, mr)
        g = jnp.where(hitmask, sun_g + ibl_g + lg, mg)
        b = jnp.where(hitmask, sun_b + ibl_b + lb, mb)
        return st, (r, g, b), cand_pdf, hitmask

    def frame_step(scene, env, mesh, accum, welford,
                   res_prev: rst.Reservoirs, frame_index):
        """One accumulation frame. accum: (H, W, 4); welford: (H, W, 2)."""
        xs = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 1)
        ys = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 0)
        st = seed_state(seed_hi, seed_lo, xs, ys, 0) ^ (
            jnp.uint32(frame_index) * jnp.uint32(92837111)
        )

        # --- ReSTIR history M-clamp + shading fetch (wgsl:393-405) ---
        res_prev = rst.m_clamp(res_prev)
        pv_flat = (
            (frame_index > 0)
            & (res_prev.m > 0)
            & (res_prev.weight > 0.0)
            & (res_prev.target_pdf > 0.0)
            & (res_prev.light_type == 1)
        )
        if not desc.restir:
            # plain sun NEE: unit reuse weight, sun direction as-is
            pv_flat = jnp.zeros_like(pv_flat)
        prev_ok = pv_flat.reshape(H, W)
        pdir = (
            res_prev.dir_x.reshape(H, W),
            res_prev.dir_y.reshape(H, W),
            res_prev.dir_z.reshape(H, W),
        )
        # normalize like the reference shading path
        pinv = jax.lax.rsqrt(pdir[0] ** 2 + pdir[1] ** 2 + pdir[2] ** 2 + 1e-30)
        pdir = (pdir[0] * pinv, pdir[1] * pinv, pdir[2] * pinv)
        pw = res_prev.weight.reshape(H, W)

        def body(i, carry):
            st, fr, fg, fb, c_wsum, c_m, c_pdf = carry
            st, (r, g, b), cand_pdf, was_hit = sample_radiance(
                scene, mesh, env, st, pdir, pw, prev_ok)
            good = cand_pdf > 0.0
            c_wsum = c_wsum + jnp.where(good, cand_pdf, 0.0)
            c_m = c_m + jnp.where(good, 1, 0).astype(jnp.uint32)
            c_pdf = jnp.where(good, cand_pdf, c_pdf)
            return (st, fr + r, fg + g, fb + b, c_wsum, c_m, c_pdf)

        z = jnp.zeros((H, W), _F32)
        zu = jnp.zeros((H, W), jnp.uint32)
        st, fr, fg, fb, c_wsum, c_m, c_pdf = jax.lax.fori_loop(
            0, spp, body, (st, z, z, z, z, zu, z)
        )
        inv_spp = _F32(1.0 / spp)
        fr, fg, fb = fr * inv_spp, fg * inv_spp, fb * inv_spp

        # --- fresh candidate reservoir (wgsl:492-495) ---
        fin = (c_m > 0) & (c_wsum > 0.0) & (c_pdf > 0.0)
        c_weight = jnp.where(
            fin, c_wsum / (c_m.astype(_F32) * jnp.maximum(c_pdf, 1e-30)), 0.0
        )
        flat = lambda a: a.reshape(-1)
        curr = rst.Reservoirs(
            dir_x=flat(jnp.broadcast_to(sun[0], (H, W)) * (c_m > 0)),
            dir_y=flat(jnp.broadcast_to(sun[1], (H, W)) * (c_m > 0)),
            dir_z=flat(jnp.broadcast_to(sun[2], (H, W)) * (c_m > 0)),
            intensity=flat(jnp.where(c_m > 0, luminance(*(jnp.asarray(v, _F32) for v in lc)), 0.0) * jnp.ones((H, W))),
            light_type=flat(jnp.where(c_m > 0, 1, 0).astype(jnp.uint32)),
            light_index=flat(zu),
            w_sum=flat(c_wsum),
            m=flat(c_m),
            weight=flat(c_weight),
            target_pdf=flat(c_pdf),
        )

        # --- accumulate the per-frame mean radiance (wgsl:497-500) ---
        acc = accum + jnp.stack([fr, fg, fb, jnp.ones_like(fr)], axis=-1)

        # --- windowed Welford over the running-mean luminance (wgsl:505-514)
        in_window = jnp.mod(frame_index, WELFORD_WINDOW)
        wf = jnp.where(in_window == 0, jnp.zeros_like(welford), welford)
        mean_lum = luminance(acc[..., 0], acc[..., 1], acc[..., 2]) / acc[..., 3]
        k = in_window.astype(_F32) + 1.0
        delta = mean_lum - wf[..., 0]
        mean = wf[..., 0] + delta / k
        m2 = wf[..., 1] + delta * (mean_lum - mean)
        wf = jnp.stack([mean, m2], axis=-1)

        return acc, wf, curr, res_prev

    return frame_step


def _make_reuse_step(desc: TerrainRefDesc):
    W, H = desc.width, desc.height
    seed_hi = int(desc.seed) & 0xFFFFFFFF

    def reuse(res_prev, curr, gb_n, frame_index):
        merged = rst.temporal_merge(res_prev, curr)
        out = rst.spatial_reuse(
            merged, gb_n[0], gb_n[1], gb_n[2], W, H, frame_index, seed_hi
        )
        return out

    return reuse


def _center_gbuffer(desc, scene, static, mesh=None, mesh_nodes=0):
    """Unjittered center-ray hit record: AOVs + ReSTIR receiver normals
    (wgsl:523-549 and main_terrain_gbuffer); with a mesh, the hybrid
    closest-of merge (hybrid_traversal.wgsl:175-201)."""
    W, H = desc.width, desc.height
    z = jnp.zeros((H, W), _F32)
    dx, dy, dz = _camera_rays(desc, z, z)
    ox = jnp.full((H, W), desc.cam_origin[0], _F32)
    oy = jnp.full((H, W), desc.cam_origin[1], _F32)
    oz = jnp.full((H, W), desc.cam_origin[2], _F32)
    th = trace(scene, static, (ox, oy, oz), (dx, dy, dz))
    t = th.t
    hitmask = th.hit
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    nx, ny, nz = normal_at(scene, static, (hx, hy, hz), th.cell_x, th.cell_z)
    if mesh_nodes:
        from ..ops.bvh import trace_mesh

        msc, fnorm = mesh
        mh = trace_mesh(msc, mesh_nodes, (ox, oy, oz), (dx, dy, dz))
        tt = jnp.where(th.hit, th.t, jnp.float32(3.0e38))
        mesh_won = mh.hit & (mh.t < tt)
        t = jnp.where(mesh_won, mh.t, th.t)
        hitmask = th.hit | mh.hit
        pid = jnp.maximum(mh.prim, 0)
        mnx = jnp.take(fnorm[:, 0], pid)
        mny = jnp.take(fnorm[:, 1], pid)
        mnz = jnp.take(fnorm[:, 2], pid)
        flip = (mnx * dx + mny * dy + mnz * dz) > 0
        nx = jnp.where(mesh_won, jnp.where(flip, -mnx, mnx), nx)
        ny = jnp.where(mesh_won, jnp.where(flip, -mny, mny), ny)
        nz = jnp.where(mesh_won, jnp.where(flip, -mnz, mnz), nz)
    nx = jnp.where(hitmask, nx, 0.0)
    ny = jnp.where(hitmask, ny, 0.0)
    nz = jnp.where(hitmask, nz, 1.0)  # sky record kept finite (wgsl:579-582)
    alb = jnp.broadcast_to(jnp.asarray(desc.albedo, _F32), (H, W, 3))
    if mesh_nodes:
        # mesh hits carry the legacy constant albedo through the AOVs
        # (hybrid_traversal.wgsl:233-241; test_hybrid_terrain_pt.py:745-748)
        alb = jnp.where(mesh_won[..., None],
                        jnp.asarray((0.7, 0.7, 0.8), _F32), alb)
    albedo = jnp.where(hitmask[..., None], alb, jnp.zeros((3,), _F32))
    depth = jnp.where(hitmask, t, jnp.nan)
    vis = jnp.where(hitmask, 1.0, 0.0)
    normal = jnp.where(
        hitmask[..., None],
        jnp.stack([nx, ny, nz], axis=-1),
        jnp.zeros((3,), _F32),
    )
    return {
        "albedo": albedo,
        "normal": normal,
        "depth": depth,
        "visibility": vis,
        "gb_n": (nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)),
    }


def render_terrain_reference(desc: TerrainRefDesc) -> dict:
    """Render the converged terrain reference; raises ConvergenceError
    rather than returning a non-converged image."""
    if desc.traversal == "sweep":
        # production path: sweep estimator (pt/terrain_sweep.py) — same
        # converged integral as restir=False per-ray NEE, without per-ray
        # marching
        if desc.lights:
            # typed point/area lights need per-ray NEE occlusion; refusing
            # beats silently dropping scene lighting (fail-closed)
            raise RenderError(
                "traversal='sweep' integrates sun+env only; typed lights "
                "need traversal='dda' (alias-table NEE)")
        if desc.mesh is not None:
            # the sweep propagates sun occlusion along heightfield rows;
            # mesh BVH occlusion needs per-ray traversal (fail-closed —
            # the public entry already falls back to 'dda')
            raise RenderError(
                "traversal='sweep' cannot trace mesh geometry; use "
                "traversal='dda' for hybrid terrain+mesh scenes")
        from .terrain_sweep import render_terrain_sweep

        return render_terrain_sweep(desc)
    _validate(desc)
    tracker = global_tracker()
    W, H = desc.width, desc.height
    n_pix = W * H

    pyr = build_pyramid(np.asarray(desc.heights, np.float32))
    scene, static = scene_from_pyramid(
        pyr, origin_xz=(0.0, 0.0), spacing_xz=desc.spacing,
        exaggeration=desc.exaggeration,
    )
    if desc.traversal != "dda":  # (sweep dispatched above)
        raise ValueError(f"unknown traversal {desc.traversal!r}")

    env = EnvMap(
        rgb=None if desc.env_map is None else jnp.asarray(desc.env_map, _F32),
        intensity=jnp.asarray(desc.env_intensity, _F32),
    )

    # Optional mesh: SAH BVH + face normals, mixed in through the hybrid
    # closest-of seam (render_terrain.rs:563-570, hybrid_traversal.wgsl).
    mesh_arg = None
    mesh_nodes = 0
    mesh_bytes = 0
    if desc.mesh is not None:
        from .mesh_render import MeshTracerScene

        mts = MeshTracerScene(desc.mesh[0], desc.mesh[1])
        mesh_arg = (mts.scene, mts.face_normals)
        mesh_nodes = mts.n_nodes
        mesh_bytes = int(mts.bvh.nbytes)

    # Resource ledger (reference reports these diagnostics per render).
    pyramid_bytes = pyr.nbytes
    accum_bytes = n_pix * 16
    welford_bytes = n_pix * 8
    reservoir_bytes = 3 * n_pix * 40
    env_bytes = 0 if desc.env_map is None else int(np.asarray(desc.env_map).nbytes)
    rids = [
        tracker.track("terrain-pt.pyramid", pyramid_bytes, "pyramid"),
        tracker.track("terrain-pt.accum", accum_bytes, "buffer"),
        tracker.track("terrain-pt.welford", welford_bytes, "buffer"),
        tracker.track("terrain-pt.reservoirs", reservoir_bytes, "buffer"),
        tracker.track("terrain-pt.env", env_bytes, "texture"),
    ]
    if mesh_bytes:
        rids.append(tracker.track("terrain-pt.mesh-bvh", mesh_bytes,
                                  "buffer"))
    gpu_resource_bytes = (pyramid_bytes + accum_bytes + welford_bytes
                          + reservoir_bytes + env_bytes + mesh_bytes)

    try:
        frame_step = jax.jit(
            _make_frame_step(desc, static, mesh_nodes),
            donate_argnums=(3, 4)
        )
        reuse_step = jax.jit(_make_reuse_step(desc), donate_argnums=(0,))
        gbuf_fn = jax.jit(
            lambda scene, mesh: _center_gbuffer(desc, scene, static,
                                                mesh, mesh_nodes)
        )

        gbuf = gbuf_fn(scene, mesh_arg)
        gb_n = gbuf["gb_n"]

        accum = jnp.zeros((H, W, 4), _F32)
        welford = jnp.zeros((H, W, 2), _F32)
        res_prev = rst.Reservoirs.zeros(n_pix)

        frames = 0
        variance = float("inf")
        converged = False
        while frames < desc.max_frames:
            accum, welford, curr, res_prev_c = frame_step(
                scene, env, mesh_arg, accum, welford, res_prev,
                jnp.uint32(frames)
            )
            res_prev = reuse_step(res_prev_c, curr, gb_n, jnp.uint32(frames))
            frames += 1

            window_full = frames % WELFORD_WINDOW == 0
            if window_full or frames == desc.max_frames:
                n_window = ((frames - 1) % WELFORD_WINDOW) + 1
                if n_window >= 2:
                    m2max = float(jnp.max(welford[..., 1]))
                    if not math.isfinite(m2max):
                        raise RenderError(
                            "terrain PT produced non-finite variance (NaN in accumulation)"
                        )
                    variance = m2max / (n_window - 1)
                    if frames >= desc.min_frames and variance < desc.variance_threshold:
                        converged = True
                        break

        if not converged:
            raise ConvergenceError(
                f"terrain PT did not converge: per-pixel luminance variance "
                f"{variance:.3e} over the last {WELFORD_WINDOW}-frame window after "
                f"{frames} frames (threshold {desc.variance_threshold:.1e}); raise "
                f"max_frames or simplify the scene — refusing to return a fake "
                f"reference",
                frames=frames,
                variance=variance,
            )

        # --- resolve running mean -> Reinhard -> f16 roundtrip -> u8 ---
        mean = accum[..., :3] / accum[..., 3:4]
        ldr = tm.f16_round(tm.reinhard(mean, desc.exposure))
        rgba = np.asarray(tm.to_u8(ldr)).astype(np.uint8)
        rgba = np.concatenate([rgba, np.full((H, W, 1), 255, np.uint8)], axis=-1)

        accum_np = np.asarray(accum)
        welford_np = np.asarray(welford)
        ldr_np = np.asarray(ldr)

        # --- runtime contracts (render_terrain.rs:30-140 flavor) ---
        _contract("accum.samples", accum_np[..., 3], 0.0, 131026.0)
        _contract("out_tex.samples", ldr_np, 0.0, 1.0)
        if not np.isfinite(welford_np).all():
            raise ContractViolation("terrain_welford contains non-finite values")

        mm = tracker.metrics()
        return {
            "rgba": rgba,
            "albedo": np.asarray(gbuf["albedo"], np.float32),
            "normal": np.asarray(gbuf["normal"], np.float32),
            "depth": np.asarray(gbuf["depth"], np.float32),
            "frames": frames,
            "variance": variance,
            "converged": True,
            "peak_host_visible_bytes": int(mm["peak_tracked_bytes"]),
            "minmax_pyramid_bytes": int(pyramid_bytes),
            "gpu_resource_bytes": int(gpu_resource_bytes),
            "hdr": np.asarray(mean, np.float32),
        }
    finally:
        for rid in rids:
            tracker.free(rid)


def _contract(name: str, arr: np.ndarray, lo: float, hi: float) -> None:
    finite = arr[np.isfinite(arr)]
    if finite.size == 0:
        return
    amin, amax = float(finite.min()), float(finite.max())
    if amin < lo or amax > hi:
        raise ContractViolation(
            f"runtime contract violated: {name} range [{amin:.6g}, {amax:.6g}] "
            f"outside [{lo:.6g}, {hi:.6g}]"
        )


def hybrid_render_terrain_reference(
    heightmap,
    width: int,
    height: int,
    cam: dict,
    spacing=(1.0, 1.0),
    exaggeration: float = 1.0,
    albedo=(0.6, 0.6, 0.6),
    sun_azimuth_deg: float = 315.0,
    sun_elevation_deg: float = 45.0,
    sun_intensity: float = 2.5,
    env_map=None,
    env_intensity: float = 0.35,
    mesh_vertices=None,
    mesh_indices=None,
    spp: int = 1,
    max_frames: int = 512,
    min_frames: int = 32,
    variance_threshold: float = 1e-3,
    seed: int = 7,
    certificate=None,
    sun_color=None,
    cache=None,
    traversal: str = "dda",
) -> dict:
    """Public entry; same signature/defaults as the reference pyfunction
    (terrain_reference.rs:57-105).  `mesh_vertices`/`mesh_indices` mix a
    triangle mesh into the scene through the hybrid closest-of seam
    (terrain_reference.rs:160-203, hybrid_traversal.wgsl:175-201): the
    SAH BVH is traced for primary AND shadow rays alongside the terrain
    DDA.  The sweep estimator cannot express mesh occlusion, so hybrid
    scenes dispatch to the per-ray engine (traversal='sweep' with a mesh
    falls back to 'dda')."""
    if (mesh_vertices is None) != (mesh_indices is None):
        raise ValueError("mesh_vertices and mesh_indices must be provided together")
    mesh = None
    if mesh_vertices is not None:
        mv = np.asarray(mesh_vertices, np.float32)
        mi = np.asarray(mesh_indices)
        if mv.ndim != 2 or mv.shape[1] != 3 or mv.shape[0] == 0:
            raise ValueError("mesh_vertices must have shape (N, 3)")
        if mi.ndim != 2 or mi.shape[1] != 3 or mi.shape[0] == 0:
            raise ValueError("mesh_indices must have shape (M, 3)")
        if not np.isfinite(mv).all():
            raise ValueError("mesh vertices contain non-finite values")
        if mi.min() < 0 or int(mi.max()) >= mv.shape[0]:
            raise ValueError("mesh indices reference out-of-bounds vertices")
        mesh = (mv, mi.astype(np.uint32))
        if traversal == "sweep":
            traversal = "dda"
    if sun_color is None:
        sun_color = (1.0, 0.97, 0.92)
    else:
        sc = [float(c) for c in sun_color]
        if len(sc) != 3 or any((not math.isfinite(c)) or c < 0 for c in sc):
            raise ValueError("sun_color must be exactly three finite, non-negative numbers")
        sun_color = tuple(sc)

    desc = TerrainRefDesc(
        heights=np.asarray(heightmap, np.float32),
        spacing=(float(spacing[0]), float(spacing[1])),
        exaggeration=float(exaggeration),
        albedo=tuple(float(a) for a in albedo),
        cam_origin=tuple(float(v) for v in cam.get("origin", (0.0, 50.0, 120.0))),
        cam_look_at=tuple(float(v) for v in cam.get("look_at", (0.0, 0.0, 0.0))),
        cam_up=tuple(float(v) for v in cam.get("up", (0.0, 1.0, 0.0))),
        fov_y_deg=float(cam.get("fov_y", 45.0)),
        exposure=float(cam.get("exposure", 1.0)),
        sun_azimuth_deg=float(sun_azimuth_deg),
        sun_elevation_deg=float(sun_elevation_deg),
        sun_intensity=float(sun_intensity),
        sun_color=sun_color,
        env_map=None if env_map is None else np.asarray(env_map, np.float32),
        env_intensity=float(env_intensity),
        width=int(width),
        height=int(height),
        seed=int(seed) & 0xFFFFFFFF,
        spp=int(spp),
        max_frames=int(max_frames),
        min_frames=int(min_frames),
        variance_threshold=float(variance_threshold),
        traversal=str(traversal),
        mesh=mesh,
    )
    out = render_terrain_reference(desc)
    if certificate is not None:
        from ..assurance.certificate import emit_certificate

        emit_certificate(certificate, "hybrid_render_terrain_reference", out)
    return out


def hybrid_render_terrain_sequence(
    heightmap,
    width: int,
    height: int,
    cam: dict,
    seeds,
    **kwargs,
) -> "list[dict]":
    """Render a sequence of converged frames (one per seed) with
    pipelined dispatch — device compute overlaps host readback, the
    steady-state regime of animation/batch jobs. Sweep estimator only
    (the camera is baked into the compiled pipeline). Accepts the same
    keyword arguments as hybrid_render_terrain_reference; each output
    dict is bit-identical to the corresponding single-frame call."""
    kwargs.pop("traversal", None)
    sun_color = kwargs.pop("sun_color", None) or (1.0, 0.97, 0.92)
    spacing = kwargs.pop("spacing", (1.0, 1.0))
    desc = TerrainRefDesc(
        heights=np.asarray(heightmap, np.float32),
        spacing=(float(spacing[0]), float(spacing[1])),
        exaggeration=float(kwargs.pop("exaggeration", 1.0)),
        albedo=tuple(float(a)
                     for a in kwargs.pop("albedo", (0.6, 0.6, 0.6))),
        cam_origin=tuple(float(v)
                         for v in cam.get("origin", (0.0, 50.0, 120.0))),
        cam_look_at=tuple(float(v)
                          for v in cam.get("look_at", (0.0, 0.0, 0.0))),
        cam_up=tuple(float(v) for v in cam.get("up", (0.0, 1.0, 0.0))),
        fov_y_deg=float(cam.get("fov_y", 45.0)),
        exposure=float(cam.get("exposure", 1.0)),
        sun_azimuth_deg=float(kwargs.pop("sun_azimuth_deg", 315.0)),
        sun_elevation_deg=float(kwargs.pop("sun_elevation_deg", 45.0)),
        sun_intensity=float(kwargs.pop("sun_intensity", 2.5)),
        sun_color=tuple(float(c) for c in sun_color),
        env_map=None,
        env_intensity=float(kwargs.pop("env_intensity", 0.35)),
        width=int(width),
        height=int(height),
        seed=int(seeds[0]) & 0xFFFFFFFF if len(seeds) else 7,
        spp=int(kwargs.pop("spp", 1)),
        traversal="sweep",
    )
    if kwargs:
        raise TypeError(f"unsupported sequence kwargs: {sorted(kwargs)}")
    from .terrain_sweep import render_terrain_sweep_sequence

    return render_terrain_sweep_sequence(desc, list(seeds))
