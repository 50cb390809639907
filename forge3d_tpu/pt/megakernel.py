# forge3d_tpu/pt/megakernel.py
# The "megakernel" deterministic sphere+ground path tracer with AOVs —
# the simple, fully deterministic GPU test path.
#
# Reference behavior being matched (not copied):
#   /root/reference/src/shaders/pt_kernel.wgsl (A1 megakernel): pixel-center
#   primary ray, nearest-sphere intersect, GGX iso/aniso single-directional-
#   light shading + env-gradient indirect + emissive, glossy ground plane at
#   y=0 with distance fog, gradient sky, Reinhard tonemap, 7 AOVs
#   (albedo/normal/depth/direct/indirect/emission/visibility).
#   Python seam: _pt_render_gpu
#   (/root/reference/src/py_functions/path_tracing/gpu.rs:4-60).
#
# Design: spheres come in as an SoA (N, ...) batch; each pixel
# reduces over spheres with a vectorized argmin — no per-pixel loop, no
# queues. The whole image is one fused jnp program; jit-cached per
# (width, height, n_spheres).

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import camera_basis

_F32 = jnp.float32
_PI = 3.141592653589793

AOV_NAMES = ("albedo", "normal", "depth", "direct", "indirect", "emission", "visibility")

_SUN_DIR = (0.4, 1.0, 0.2)           # wgsl:174 (normalized below)
_SUN_RADIANCE = (2.5, 2.375, 2.25)   # (1.0, 0.95, 0.90) * 2.5


class SphereBatch(NamedTuple):
    center: jax.Array     # (N, 3)
    radius: jax.Array     # (N,)
    albedo: jax.Array     # (N, 3)
    metallic: jax.Array   # (N,)
    emissive: jax.Array   # (N, 3)
    roughness: jax.Array  # (N,)
    ior: jax.Array        # (N,)
    ax: jax.Array         # (N,)
    ay: jax.Array         # (N,)


def spheres_from_dicts(scene) -> SphereBatch:
    """Parse the reference's scene list-of-dicts contract
    (gpu.rs:16-60 defaults: albedo .8, metallic 0, roughness .5,
    emissive 0, ior 1, ax/ay 0.2)."""
    items = list(scene) if scene else []
    n = max(len(items), 1)
    c = np.zeros((n, 3), np.float32)
    r = np.zeros((n,), np.float32)  # radius 0 => never hit (placeholder)
    alb = np.full((n, 3), 0.8, np.float32)
    met = np.zeros((n,), np.float32)
    emi = np.zeros((n, 3), np.float32)
    rough = np.full((n,), 0.5, np.float32)
    ior = np.ones((n,), np.float32)
    ax = np.full((n,), 0.2, np.float32)
    ay = np.full((n,), 0.2, np.float32)
    for i, d in enumerate(items):
        if not isinstance(d, dict):
            raise ValueError("scene items must be dicts")
        if "center" not in d or "radius" not in d:
            raise ValueError("sphere missing 'center'/'radius'")
        c[i] = d["center"]
        r[i] = d["radius"]
        alb[i] = d.get("albedo", (0.8, 0.8, 0.8))
        met[i] = d.get("metallic", 0.0)
        emi[i] = d.get("emissive", (0.0, 0.0, 0.0))
        rough[i] = d.get("roughness", 0.5)
        ior[i] = d.get("ior", 1.0)
        ax[i] = d.get("ax", 0.2)
        ay[i] = d.get("ay", 0.2)
    return SphereBatch(*(jnp.asarray(v) for v in (c, r, alb, met, emi, rough, ior, ax, ay)))


def _env_color(d):
    """Gradient sky: up=blue, horizon=white, below=dark ground tint."""
    t = jnp.clip(0.5 * (d[..., 1] + 1.0), 0.0, 1.0)[..., None]
    sky = (1 - t) * jnp.asarray([0.9, 0.95, 1.0]) + t * jnp.asarray([0.2, 0.4, 0.8])
    ground = jnp.asarray([0.08, 0.08, 0.08])
    return (1 - t) * ground + t * sky


def _fresnel_schlick(cos_theta, f0):
    return f0 + (1.0 - f0) * jnp.power(1.0 - jnp.clip(cos_theta, 0.0, 1.0), 5.0)[..., None]


def _ggx_D(ndh, alpha):
    a2 = alpha * alpha
    denom = _PI * jnp.square(ndh * ndh * (a2 - 1.0) + 1.0)
    return a2 / jnp.maximum(denom, 1e-6)


def _smith_G1(ndx, alpha):
    k = jnp.square(alpha + 1.0) / 8.0
    return ndx / (ndx * (1.0 - k) + k)


def _tangent_basis(n):
    sign = jnp.where(n[..., 2] < 0.0, -1.0, 1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    bv = jnp.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t, bv


def _ggx_D_aniso(h, t, b, n, ax, ay):
    hx = jnp.sum(h * t, -1)
    hy = jnp.sum(h * b, -1)
    hz = jnp.maximum(jnp.sum(h * n, -1), 0.0)
    x2 = hx * hx / jnp.maximum(ax * ax, 1e-8)
    y2 = hy * hy / jnp.maximum(ay * ay, 1e-8)
    denom = x2 + y2 + hz * hz
    return 1.0 / jnp.maximum(_PI * ax * ay * denom * denom, 1e-6)


def _smith_G_aniso(v, t, b, n, ax, ay):
    vx = jnp.sum(v * t, -1)
    vy = jnp.sum(v * b, -1)
    vz = jnp.maximum(jnp.sum(v * n, -1), 1e-6)
    av = jnp.sqrt(vx * vx * ax * ax + vy * vy * ay * ay) / vz
    return 2.0 / (1.0 + jnp.sqrt(1.0 + av * av))


def _shade_pbr(v, n, m_albedo, m_metallic, m_roughness, m_emissive, m_ax, m_ay):
    """GGX direct + env-reflection indirect + emissive (wgsl:167-213)."""
    albedo = jnp.maximum(m_albedo, 0.0)
    metallic = jnp.clip(m_metallic, 0.0, 1.0)[..., None]
    rough = jnp.clip(m_roughness, 0.0, 1.0)
    ax = jnp.maximum(0.002, m_ax)
    ay = jnp.maximum(0.002, m_ay)

    l = jnp.asarray(_SUN_DIR) / np.linalg.norm(_SUN_DIR)
    li = jnp.asarray(_SUN_RADIANCE)
    h = l + v
    h = h / jnp.linalg.norm(h, axis=-1, keepdims=True)
    ndl = jnp.maximum(jnp.sum(n * l, -1), 0.0)
    ndv = jnp.maximum(jnp.sum(n * v, -1), 0.0)
    ndh = jnp.maximum(jnp.sum(n * h, -1), 0.0)
    vdh = jnp.maximum(jnp.sum(v * h, -1), 0.0)

    a_iso = jnp.maximum(0.02, rough * rough)
    D_iso = _ggx_D(ndh, a_iso)
    G_iso = _smith_G1(ndl, a_iso) * _smith_G1(ndv, a_iso)

    t, b = _tangent_basis(n)
    D_an = _ggx_D_aniso(h, t, b, n, ax, ay)
    G_an = _smith_G_aniso(
        jnp.broadcast_to(l, v.shape), t, b, n, ax, ay
    ) * _smith_G_aniso(v, t, b, n, ax, ay)

    iso = jnp.abs(ax - ay) < 1e-4
    D = jnp.where(iso, D_iso, D_an)
    G = jnp.where(iso, G_iso, G_an)

    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    F = _fresnel_schlick(vdh, f0)
    spec = (D * G / jnp.maximum(4.0 * ndl * ndv, 1e-6))[..., None] * F
    kd = (1.0 - F) * (1.0 - metallic)
    diffuse = kd * albedo / _PI
    direct = (diffuse + spec) * li * ndl[..., None]

    r = 2.0 * jnp.sum(n * v, -1, keepdims=True) * n - v
    env = _env_color(r)
    f_ibl = f0 + (jnp.maximum(1.0 - rough[..., None], f0) - f0) * jnp.power(
        1.0 - ndv, 5.0
    )[..., None]
    indirect = env * (f_ibl * 0.5 + 0.5 * kd * albedo)

    color = direct + indirect + jnp.maximum(m_emissive, 0.0)
    return color, albedo, direct, indirect


@functools.partial(jax.jit, static_argnums=(0, 1))
def _render(width: int, height: int, spheres: SphereBatch, cam_params):
    origin, right, up, fwd, fov_y, aspect, exposure = cam_params
    H, W = height, width
    xs = jax.lax.broadcasted_iota(_F32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(_F32, (H, W), 0)
    ndc_x = 2.0 * (xs + 0.5) / W - 1.0
    ndc_y = 1.0 - 2.0 * (ys + 0.5) / H
    tan_half = jnp.tan(0.5 * fov_y)
    d = (
        fwd
        + (ndc_x * aspect * tan_half)[..., None] * right
        + (ndc_y * tan_half)[..., None] * up
    )
    rd = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    ro = jnp.broadcast_to(origin, rd.shape)

    # --- nearest sphere (vectorized over the sphere batch) ---
    oc = origin[None, :] - spheres.center            # (N, 3)
    b = jnp.einsum("hwc,nc->hwn", rd, -oc) * -1.0    # dot(oc, rd)
    c = jnp.sum(oc * oc, -1) - spheres.radius**2     # (N,)
    disc = b * b - c
    sd = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sd
    t1 = -b + sd
    t = jnp.where(t0 > 1e-4, t0, t1)
    valid = (disc >= 0.0) & (t > 1e-4) & (spheres.radius > 0.0)
    t = jnp.where(valid, t, 1e30)
    best = jnp.argmin(t, axis=-1)
    best_t = jnp.take_along_axis(t, best[..., None], -1)[..., 0]
    hit_sphere = best_t < 1e30

    gather = lambda arr: jnp.take(arr, best, axis=0)
    s_center = gather(spheres.center)
    p = ro + best_t[..., None] * rd
    n_sph = p - s_center
    n_sph = n_sph / jnp.maximum(jnp.linalg.norm(n_sph, axis=-1, keepdims=True), 1e-12)

    v = -rd
    color_s, albedo_s, direct_s, indirect_s = _shade_pbr(
        v, n_sph,
        gather(spheres.albedo), gather(spheres.metallic),
        gather(spheres.roughness), gather(spheres.emissive),
        gather(spheres.ax), gather(spheres.ay),
    )

    # --- ground plane fallback (wgsl:222-278) ---
    tg = -ro[..., 1] / jnp.where(rd[..., 1] >= -1e-5, -1.0, rd[..., 1])
    hit_ground = (rd[..., 1] < -1e-5) & (tg > 0.0)
    pg = ro + tg[..., None] * rd
    ng = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), rd.shape)
    color_g, albedo_g, direct_g, indirect_g = _shade_pbr(
        v, ng,
        jnp.asarray([0.6, 0.6, 0.6]), jnp.asarray(0.0),
        jnp.asarray(0.2), jnp.zeros(3), jnp.asarray(0.2), jnp.asarray(0.2),
    )
    dist = jnp.linalg.norm(pg - ro, axis=-1)
    fog = jnp.clip(dist / 50.0, 0.0, 1.0)[..., None]
    horizon = _env_color(jnp.asarray([0.0, 1.0, 0.0])[None, None, :])
    color_g = (1 - fog) * color_g + fog * horizon

    env = _env_color(rd)

    hs = hit_sphere[..., None]
    hg = (~hit_sphere & hit_ground)[..., None]
    color = jnp.where(hs, color_s, jnp.where(hg, color_g, env))
    albedo = jnp.where(hs, albedo_s, jnp.where(hg, albedo_g, 0.0))
    direct = jnp.where(hs, direct_s, jnp.where(hg, direct_g, 0.0))
    indirect = jnp.where(hs, indirect_s, jnp.where(hg, indirect_g, env))
    depth = jnp.where(hit_sphere, best_t, jnp.where(hit_ground, tg, 1.0))
    vis = jnp.where(hit_sphere | hit_ground, 1.0, 0.0)
    normal = jnp.where(hs, n_sph, ng)
    normal = normal / jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)

    exposed = color * jnp.maximum(exposure, 1e-4)
    ldr = exposed / (exposed + 1.0)
    rgba = jnp.concatenate([ldr, jnp.ones_like(ldr[..., :1])], axis=-1)
    return {
        "rgba": rgba,
        "albedo": albedo,
        "normal": normal,
        "depth": depth,
        "direct": direct,
        "indirect": indirect,
        "emission": jnp.zeros_like(color),
        "visibility": vis,
    }


def pt_render_gpu(width, height, scene, cam, seed=1, frames=1):
    """Deterministic megakernel render -> (H, W, 4) uint8.

    Reference seam: _pt_render_gpu (gpu.rs:4). `seed`/`frames` are accepted
    for signature parity; the kernel is deterministic (pixel-center rays).
    """
    out = pt_render_aovs(width, height, scene, cam, seed=seed, frames=frames)
    rgba = out["rgba"]
    return rgba


def pt_render_aovs(width, height, scene, cam, seed=1, frames=1, aovs=AOV_NAMES):
    """Megakernel render returning rgba + requested AOV planes (numpy)."""
    width = int(width)
    height = int(height)
    if width <= 0 or height <= 0:
        raise ValueError("width/height must be positive")
    spheres = scene if isinstance(scene, SphereBatch) else spheres_from_dicts(scene)
    cam = cam or {}
    origin = np.asarray(cam.get("origin", (0.0, 1.2, 3.0)), np.float32)
    look_at = np.asarray(cam.get("look_at", (0.0, 1.0, 0.0)), np.float32)
    up = np.asarray(cam.get("up", (0.0, 1.0, 0.0)), np.float32)
    fov_y = math.radians(float(cam.get("fov_y", 45.0)))
    exposure = float(cam.get("exposure", 1.0))
    right, upv, fwd = camera_basis(origin, look_at, up)
    cam_params = (
        jnp.asarray(origin), jnp.asarray(right), jnp.asarray(upv),
        jnp.asarray(fwd), jnp.asarray(fov_y, _F32),
        jnp.asarray(width / height, _F32), jnp.asarray(exposure, _F32),
    )
    out = _render(width, height, spheres, cam_params)
    # f16 roundtrip mirrors the RGBA16F output texture; u8 quantize matches
    # the reference readback.
    rgba16 = np.asarray(out["rgba"], np.float32).astype(np.float16).astype(np.float32)
    rgba = (np.clip(rgba16, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    result = {"rgba": rgba}
    for name in aovs:
        if name == "rgba":
            continue
        plane = np.asarray(out[name], np.float32)
        if name in ("albedo", "normal", "direct", "indirect", "emission"):
            plane = plane.astype(np.float16).astype(np.float32)
        result[name] = plane
    return result
