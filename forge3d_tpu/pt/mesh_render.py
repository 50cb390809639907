# forge3d_tpu/pt/mesh_render.py
# Mesh path tracing: triangle BVH traversal + PBR shading + sun NEE with
# BVH shadow rays + AOVs.
#
# Parity notes (reference behavior, not code): the `_pt_render_gpu_mesh`
# seam (SURVEY §A.7; /root/reference/src/py_module registration) renders a
# triangle mesh with the same camera/shading contract as the sphere
# megakernel. Design: the stackless threaded-BVH traversal
# (ops/bvh.py) runs as one fused lax.while_loop over all pixels — no
# wavefront queues — and the scene pytree is passed as a jit argument so
# tables stay resident in device memory across frames.

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import camera_basis
from ..ops.bvh import MeshScene, build_sah_bvh, mesh_scene, trace_mesh
from ..ops.shading import sun_direction
from .megakernel import AOV_NAMES, _env_color, _shade_pbr

_F32 = jnp.float32


class MeshMaterial(NamedTuple):
    albedo: jax.Array     # (3,)
    metallic: jax.Array   # ()
    roughness: jax.Array
    emissive: jax.Array   # (3,)


def _material_from_dict(mat: Optional[dict]) -> MeshMaterial:
    mat = mat or {}
    return MeshMaterial(
        albedo=jnp.asarray(mat.get("albedo", (0.75, 0.72, 0.68)), _F32),
        metallic=jnp.asarray(float(mat.get("metallic", 0.0)), _F32),
        roughness=jnp.asarray(float(mat.get("roughness", 0.55)), _F32),
        emissive=jnp.asarray(mat.get("emissive", (0.0, 0.0, 0.0)), _F32),
    )


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _render_mesh(width: int, height: int, n_nodes: int, scene: MeshScene,
                 face_normals, mat: MeshMaterial, cam_params, sun_params):
    origin, right, up, fwd, fov_y, aspect, exposure = cam_params
    sun_dir, sun_intensity = sun_params
    H, W = height, width
    xs = jax.lax.broadcasted_iota(_F32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(_F32, (H, W), 0)
    ndc_x = 2.0 * (xs + 0.5) / W - 1.0
    ndc_y = 1.0 - 2.0 * (ys + 0.5) / H
    tan_half = jnp.tan(0.5 * fov_y)
    d = (fwd + (ndc_x * aspect * tan_half)[..., None] * right
         + (ndc_y * tan_half)[..., None] * up)
    rd = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    ro = jnp.broadcast_to(origin, rd.shape)

    hit = trace_mesh(scene, n_nodes,
                     (ro[..., 0], ro[..., 1], ro[..., 2]),
                     (rd[..., 0], rd[..., 1], rd[..., 2]))
    pid = jnp.maximum(hit.prim, 0)
    n = jnp.stack([jnp.take(face_normals[:, c], pid) for c in range(3)], axis=-1)
    # two-sided shading: flip the normal toward the viewer
    n = jnp.where(jnp.sum(n * rd, -1, keepdims=True) > 0, -n, n)

    p = ro + hit.t[..., None] * rd
    v = -rd
    color_m, albedo_m, direct_m, indirect_m = _shade_pbr(
        v, n, mat.albedo, mat.metallic, mat.roughness, mat.emissive,
        mat.roughness, mat.roughness)

    # Sun NEE with a real BVH shadow ray (replaces shadow maps).
    sp = p + n * 1e-3
    sh = trace_mesh(scene, n_nodes,
                    (sp[..., 0], sp[..., 1], sp[..., 2]),
                    (jnp.broadcast_to(sun_dir[0], hit.t.shape),
                     jnp.broadcast_to(sun_dir[1], hit.t.shape),
                     jnp.broadcast_to(sun_dir[2], hit.t.shape)),
                    tmax=1e6)
    ndl = jnp.maximum(n[..., 0] * sun_dir[0] + n[..., 1] * sun_dir[1]
                      + n[..., 2] * sun_dir[2], 0.0)
    sun_vis = jnp.where(sh.hit, 0.0, 1.0)
    sun_rgb = (mat.albedo / math.pi) * (sun_intensity * ndl * sun_vis)[..., None]
    color_m = color_m + sun_rgb
    direct_m = direct_m + sun_rgb

    env = _env_color(rd)
    hm = hit.hit[..., None]
    color = jnp.where(hm, color_m, env)
    albedo = jnp.where(hm, albedo_m, 0.0)
    direct = jnp.where(hm, direct_m, 0.0)
    indirect = jnp.where(hm, indirect_m, env)
    depth = jnp.where(hit.hit, hit.t, 1.0)
    vis = jnp.where(hit.hit, 1.0, 0.0)
    normal = jnp.where(hm, n, jnp.asarray([0.0, 1.0, 0.0]))

    exposed = color * jnp.maximum(exposure, 1e-4)
    ldr = exposed / (exposed + 1.0)  # Reinhard, matching the megakernel
    rgba = jnp.concatenate([ldr, jnp.ones_like(ldr[..., :1])], axis=-1)
    return {"rgba": rgba, "albedo": albedo, "normal": normal, "depth": depth,
            "direct": direct, "indirect": indirect,
            "emission": jnp.broadcast_to(mat.emissive, color.shape) * vis[..., None],
            "visibility": vis, "prim": hit.prim}


class MeshTracerScene:
    """Host wrapper: builds the SAH BVH once, keeps device arrays resident."""

    def __init__(self, vertices, indices):
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.uint32).reshape(-1, 3)
        self.bvh = build_sah_bvh(vertices, indices)
        self.scene, self.n_nodes = mesh_scene(self.bvh)
        # face normals in BVH primitive order
        e1 = np.asarray(self.scene.tri_e1)
        e2 = np.asarray(self.scene.tri_e2)
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
        self.face_normals = jnp.asarray(fn, jnp.float32)

    @property
    def triangle_count(self) -> int:
        return self.bvh.triangle_count


def pt_render_gpu_mesh(width, height, vertices, indices, cam=None, *,
                       material=None, sun=None, seed=1, frames=1,
                       aovs=(), scene: Optional[MeshTracerScene] = None) -> dict:
    """Render a triangle mesh; returns {"rgba": u8, <aov>: f32}.

    Reference seam: `_pt_render_gpu_mesh`. Deterministic (pixel-center
    rays); `seed`/`frames` accepted for signature parity.
    """
    width, height = int(width), int(height)
    if width <= 0 or height <= 0:
        raise ValueError("width/height must be positive")
    if scene is None:
        scene = MeshTracerScene(vertices, indices)
    cam = cam or {}
    origin = np.asarray(cam.get("origin", (0.0, 1.5, 4.0)), np.float32)
    look_at = np.asarray(cam.get("look_at", (0.0, 0.5, 0.0)), np.float32)
    up = np.asarray(cam.get("up", (0.0, 1.0, 0.0)), np.float32)
    fov_y = math.radians(float(cam.get("fov_y", 45.0)))
    exposure = float(cam.get("exposure", 1.0))
    right, upv, fwd = camera_basis(origin, look_at, up)
    cam_params = (jnp.asarray(origin), jnp.asarray(right), jnp.asarray(upv),
                  jnp.asarray(fwd), jnp.asarray(fov_y, _F32),
                  jnp.asarray(width / height, _F32), jnp.asarray(exposure, _F32))
    sun = sun or {}
    sd = sun_direction(float(sun.get("azimuth", 135.0)),
                       float(sun.get("elevation", 45.0)))
    sun_params = (jnp.asarray(sd, _F32),
                  jnp.asarray(float(sun.get("intensity", 3.0)), _F32))
    out = _render_mesh(width, height, scene.n_nodes, scene.scene,
                       scene.face_normals, _material_from_dict(material),
                       cam_params, sun_params)
    rgba16 = np.asarray(out["rgba"], np.float32).astype(np.float16).astype(np.float32)
    result = {"rgba": (np.clip(rgba16, 0, 1) * 255 + 0.5).astype(np.uint8)}
    for name in aovs:
        if name in AOV_NAMES:
            result[name] = np.asarray(out[name], np.float32)
    return result
