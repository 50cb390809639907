# forge3d_tpu/pt/hybrid.py
# Hybrid tracer: SDF raymarch + mesh BVH + terrain heightfield in one
# render, with traversal-mode selection; plus the PT-vs-raster
# adjudication pair (AEQUITAS).
#
# Parity notes (reference behavior, not code):
#   /root/reference/src/path_tracing/hybrid_compute/mod.rs:19-71 —
#   HybridPathTracer with TraversalMode Hybrid/SdfOnly/MeshOnly/
#   TerrainOnly; nearest hit across the enabled geometry kinds, shared
#   shading. src/py_functions/adjudication.rs renders a PT + raster pair
#   of the same scene for cross-validation (test_adjudication_gate.py).
# Here: each geometry kind is its own fused trace (sphere-traced
# SDF tape, stackless BVH, min-max pyramid DDA); the nearest-hit merge and
# the shading are plain fused jnp; one sun shadow ray re-queries every
# enabled geometry (union occlusion).

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import camera_basis
from ..ops.shading import sun_direction

_F32 = jnp.float32

TRAVERSAL_MODES = ("hybrid", "sdf_only", "mesh_only", "terrain_only")


class HybridScene(NamedTuple):
    terrain_scene: Optional[object]
    terrain_static: Optional[object]
    mesh_scene: Optional[object]
    mesh_nodes: int
    mesh_normals: Optional[jax.Array]
    sdf_scene: Optional[object]


def build_hybrid_scene(*, heightmap: Optional[np.ndarray] = None,
                       terrain_spacing=(1.0, 1.0),
                       terrain_exaggeration: float = 1.0,
                       mesh_vertices=None, mesh_indices=None,
                       sdf_scene=None) -> HybridScene:
    """Assemble any subset of {terrain, mesh, sdf} into one scene."""
    tscene = tstatic = None
    if heightmap is not None:
        from ..ops.pyramid import build_pyramid
        from ..ops.traversal import scene_from_pyramid

        pyr = build_pyramid(np.asarray(heightmap, np.float32))
        tscene, tstatic = scene_from_pyramid(
            pyr, spacing_xz=terrain_spacing,
            exaggeration=terrain_exaggeration)
    mscene = None
    nnodes = 0
    mnormals = None
    if mesh_vertices is not None:
        from ..ops.bvh import build_sah_bvh, mesh_scene

        bvh = build_sah_bvh(np.asarray(mesh_vertices, np.float32),
                            np.asarray(mesh_indices, np.uint32))
        mscene, nnodes = mesh_scene(bvh)
        e1 = np.asarray(mscene.tri_e1)
        e2 = np.asarray(mscene.tri_e2)
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
        mnormals = jnp.asarray(fn, _F32)
    return HybridScene(terrain_scene=tscene, terrain_static=tstatic,
                       mesh_scene=mscene, mesh_nodes=nnodes,
                       mesh_normals=mnormals, sdf_scene=sdf_scene)


def _trace_all(hs: HybridScene, mode: str, ro3, rd3, tmin, tmax):
    """Nearest hit across enabled kinds.

    Returns (hit, t, nx, ny, nz, kind) with kind 0=terrain 1=mesh 2=sdf.
    """
    rox, roy, roz = ro3
    rdx, rdy, rdz = rd3
    shape = jnp.broadcast_shapes(rox.shape, rdx.shape)
    best_t = jnp.full(shape, jnp.asarray(tmax, _F32))
    hit = jnp.zeros(shape, bool)
    nx = jnp.zeros(shape, _F32)
    ny = jnp.ones(shape, _F32)
    nz = jnp.zeros(shape, _F32)
    kind = jnp.full(shape, -1, jnp.int32)

    use_terrain = hs.terrain_scene is not None and mode in ("hybrid",
                                                            "terrain_only")
    use_mesh = hs.mesh_scene is not None and mode in ("hybrid", "mesh_only")
    use_sdf = hs.sdf_scene is not None and mode in ("hybrid", "sdf_only")

    if use_terrain:
        from ..ops.traversal import normal_at, trace

        r = trace(hs.terrain_scene, hs.terrain_static, ro3, rd3,
                  tmin=tmin, tmax=tmax)
        closer = r.hit & (r.t < best_t)
        px = rox + r.t * rdx
        py = roy + r.t * rdy
        pz = roz + r.t * rdz
        tnx, tny, tnz = normal_at(hs.terrain_scene, hs.terrain_static,
                                  (px, py, pz), r.cell_x, r.cell_z)
        best_t = jnp.where(closer, r.t, best_t)
        hit = hit | closer
        nx = jnp.where(closer, tnx, nx)
        ny = jnp.where(closer, tny, ny)
        nz = jnp.where(closer, tnz, nz)
        kind = jnp.where(closer, 0, kind)
    if use_mesh:
        from ..ops.bvh import trace_mesh

        r = trace_mesh(hs.mesh_scene, hs.mesh_nodes,
                       (rox, roy, roz), (rdx, rdy, rdz),
                       tmin=tmin, tmax=tmax)
        closer = r.hit & (r.t < best_t)
        pid = jnp.maximum(r.prim, 0)
        mn = jnp.stack([jnp.take(hs.mesh_normals[:, c], pid)
                        for c in range(3)], -1)
        flip = (mn[..., 0] * rdx + mn[..., 1] * rdy + mn[..., 2] * rdz) > 0
        mn = jnp.where(flip[..., None], -mn, mn)
        best_t = jnp.where(closer, r.t, best_t)
        hit = hit | closer
        nx = jnp.where(closer, mn[..., 0], nx)
        ny = jnp.where(closer, mn[..., 1], ny)
        nz = jnp.where(closer, mn[..., 2], nz)
        kind = jnp.where(closer, 1, kind)
    if use_sdf:
        shit, st, _ = hs.sdf_scene.raymarch(ro3, rd3, tmin=tmin,
                                            tmax=float(1e6))
        closer = shit & (st < best_t)
        px = rox + st * rdx
        py = roy + st * rdy
        pz = roz + st * rdz
        snx, sny, snz = hs.sdf_scene.normal(px, py, pz)
        best_t = jnp.where(closer, st, best_t)
        hit = hit | closer
        nx = jnp.where(closer, snx, nx)
        ny = jnp.where(closer, sny, ny)
        nz = jnp.where(closer, snz, nz)
        kind = jnp.where(closer, 2, kind)
    return hit, best_t, nx, ny, nz, kind


def _occluded_all(hs: HybridScene, mode: str, ro3, rd3, max_dist):
    h, t, *_ = _trace_all(hs, mode, ro3, rd3, 1e-3, max_dist)
    return h


def hybrid_render(width: int, height: int, scene: HybridScene, cam=None, *,
                  mode: str = "hybrid", sun=None,
                  albedo=((0.55, 0.52, 0.48), (0.7, 0.7, 0.72),
                          (0.8, 0.3, 0.25)),
                  env_intensity: float = 0.35, exposure: float = 1.0,
                  aovs=()) -> dict:
    """Render the hybrid scene (reference seam: hybrid_render).

    Per-kind albedo triple (terrain, mesh, sdf); sun NEE with a union
    shadow query; cosine-weighted sky ambient.
    """
    if mode not in TRAVERSAL_MODES:
        raise ValueError(f"unknown traversal mode {mode!r}; "
                         f"expected one of {TRAVERSAL_MODES}")
    width, height = int(width), int(height)
    cam = cam or {}
    origin = np.asarray(cam.get("origin", (0.0, 10.0, 30.0)), np.float32)
    look_at = np.asarray(cam.get("look_at", (0.0, 0.0, 0.0)), np.float32)
    fov_y = math.radians(float(cam.get("fov_y", 45.0)))
    right, upv, fwd = camera_basis(origin, look_at,
                                   np.asarray(cam.get("up", (0, 1, 0)),
                                              np.float32))
    H, W = height, width
    xs = jax.lax.broadcasted_iota(_F32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(_F32, (H, W), 0)
    ndc_x = 2.0 * (xs + 0.5) / W - 1.0
    ndc_y = 1.0 - 2.0 * (ys + 0.5) / H
    tan_half = math.tan(fov_y / 2)
    d = (jnp.asarray(fwd)
         + (ndc_x * (W / H) * tan_half)[..., None] * jnp.asarray(right)
         + (ndc_y * tan_half)[..., None] * jnp.asarray(upv))
    rd = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    ro3 = tuple(jnp.full((H, W), origin[i], _F32) for i in range(3))
    rd3 = (rd[..., 0], rd[..., 1], rd[..., 2])

    hit, t, nx, ny, nz, kind = _trace_all(scene, mode, ro3, rd3, 1e-3, 1e6)

    sun = sun or {}
    sd = sun_direction(float(sun.get("azimuth", 135.0)),
                       float(sun.get("elevation", 45.0)))
    sun_i = float(sun.get("intensity", 3.0))
    px = ro3[0] + t * rd3[0] + nx * 1e-3
    py = ro3[1] + t * rd3[1] + ny * 1e-3
    pz = ro3[2] + t * rd3[2] + nz * 1e-3
    sh = _occluded_all(scene, mode, (px, py, pz),
                       (jnp.full((H, W), sd[0], _F32),
                        jnp.full((H, W), sd[1], _F32),
                        jnp.full((H, W), sd[2], _F32)), 1e6)
    ndl = jnp.maximum(nx * sd[0] + ny * sd[1] + nz * sd[2], 0.0)
    vis = jnp.where(sh, 0.0, 1.0)
    amb = env_intensity * (0.5 + 0.5 * ny)

    alb = jnp.asarray(albedo, _F32)                        # (3 kinds, 3)
    ka = jnp.take(alb, jnp.clip(kind, 0, 2), axis=0)       # (H, W, 3)
    radiance = ka * (sun_i * ndl * vis / math.pi + amb)[..., None]

    # sky background
    sky = jnp.stack([0.45 + 0.35 * jnp.clip(rd3[1], 0, 1),
                     0.62 + 0.25 * jnp.clip(rd3[1], 0, 1),
                     0.85 + 0.1 * jnp.clip(rd3[1], 0, 1)], -1)
    color = jnp.where(hit[..., None], radiance, sky)
    exposed = color * exposure
    ldr = exposed / (exposed + 1.0)
    rgba = np.empty((H, W, 4), np.uint8)
    rgba[..., :3] = (np.clip(np.asarray(ldr), 0, 1) * 255 + 0.5).astype(np.uint8)
    rgba[..., 3] = 255
    out = {"rgba": rgba}
    if aovs:
        planes = {
            "depth": np.asarray(jnp.where(hit, t, 0.0), np.float32),
            "normal": np.stack([np.asarray(nx), np.asarray(ny),
                                np.asarray(nz)], -1),
            "visibility": np.asarray(hit, np.float32),
            "kind": np.asarray(kind, np.int32),
            "albedo": np.asarray(ka, np.float32),
        }
        for name in aovs:
            if name in planes:
                out[name] = planes[name]
    return out


def render_adjudication_pair(heightmap, width: int = 256, height: int = 192,
                             *, cam=None, sun=None, spp: int = 4,
                             max_frames: int = 48,
                             variance_threshold: float = 0.05) -> dict:
    """AEQUITAS: render the same terrain through the path-traced reference
    AND the raster-equivalent renderer, return both frames + agreement
    metrics (reference seam: render_adjudication_pair;
    gate = test_adjudication_gate.py semantics)."""
    import numpy as np

    from ..terrain.params import make_terrain_params
    from ..terrain.renderer import TerrainRenderer
    from ..utils.metrics import image_metrics
    from .terrain_ref import hybrid_render_terrain_reference

    heightmap = np.asarray(heightmap, np.float32)
    h, w = heightmap.shape
    cam = cam or {"origin": (w / 2, heightmap.max() + 0.45 * w, h * 1.7),
                  "look_at": (w / 2, 0.0, h / 2)}
    sun = sun or {"azimuth": 135.0, "elevation": 50.0, "intensity": 3.0}

    pt = hybrid_render_terrain_reference(
        heightmap, width, height, cam, spp=spp, min_frames=2,
        max_frames=max_frames, variance_threshold=variance_threshold,
        sun_azimuth_deg=sun["azimuth"], sun_elevation_deg=sun["elevation"],
        sun_intensity=sun["intensity"])

    p = make_terrain_params()
    p.size_px = (width, height)
    # adjudication compares geometry+lighting, so both lanes shade the
    # same constant albedo (the PT reference's default grey)
    p.albedo_mode = "constant"
    p.constant_albedo = (0.6, 0.6, 0.6)
    p.tonemap.mode = "reinhard"       # the PT reference's output transform
    p.output_srgb_eotf = False
    p.ibl.intensity = 0.35            # match the PT env ambient
    # orbit camera matching the lookat
    import math as _m

    o = np.asarray(cam["origin"], np.float64)
    tgt = np.asarray(cam["look_at"], np.float64)
    dv = o - tgt
    r = float(np.linalg.norm(dv))
    p.cam_target = tuple(map(float, tgt))
    p.cam_radius = r
    p.cam_theta_deg = _m.degrees(_m.asin(max(-1, min(1, dv[1] / r))))
    p.cam_phi_deg = _m.degrees(_m.atan2(dv[2], dv[0]))
    p.light.azimuth_deg = sun["azimuth"]
    p.light.elevation_deg = sun["elevation"]
    p.light.intensity = sun["intensity"]
    raster = TerrainRenderer().render_terrain_pbr_pom(
        params=p, heightmap=heightmap)

    # The two lanes are independent light-transport implementations with
    # different ambient models; the adjudication verdict is about shared
    # STRUCTURE (geometry, shading gradients, shadows), so the comparison
    # is exposure-normalized: both frames are scaled to a common mean
    # luminance before metrics. Raw frames are returned unscaled.
    a = pt["rgba"][..., :3].astype(np.float64)
    b = raster.rgba[..., :3].astype(np.float64)
    target = 120.0
    an = np.clip(a * (target / max(a.mean(), 1e-6)), 0, 255).astype(np.uint8)
    bn = np.clip(b * (target / max(b.mean(), 1e-6)), 0, 255).astype(np.uint8)
    metrics = image_metrics(an, bn)
    metrics["pt_mean"] = float(a.mean())
    metrics["raster_mean"] = float(b.mean())
    return {"pt": pt["rgba"], "raster": raster.rgba, "metrics": metrics}
