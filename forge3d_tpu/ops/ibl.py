# forge3d_tpu/ops/ibl.py
# Image-based lighting: equirect -> cubemap, GGX prefilter chain,
# split-sum BRDF LUT, irradiance map — all fused jnp.
#
# Parity notes (reference behavior, not code): /root/reference/src/core/
# ibl/ + ibl*.wgsl implement the standard split-sum IBL pipeline
# (equirect to cubemap, roughness-prefiltered specular mips, BRDF
# integration LUT, diffuse irradiance) with quality tiers. Here:
# each stage is a deterministic jnp program over direction grids;
# importance sampling uses a fixed Hammersley set so bakes are
# reproducible byte-for-byte.

from __future__ import annotations

import math
from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["equirect_to_cubemap", "prefilter_environment", "brdf_lut",
           "irradiance_map", "sample_equirect", "IblMaps", "bake_ibl"]

_F32 = jnp.float32

_FACE_AXES = [
    # (forward, up, right) per cube face +X -X +Y -Y +Z -Z
    ((1, 0, 0), (0, 1, 0), (0, 0, -1)),
    ((-1, 0, 0), (0, 1, 0), (0, 0, 1)),
    ((0, 1, 0), (0, 0, -1), (1, 0, 0)),
    ((0, -1, 0), (0, 0, 1), (1, 0, 0)),
    ((0, 0, 1), (0, 1, 0), (1, 0, 0)),
    ((0, 0, -1), (0, 1, 0), (-1, 0, 0)),
]


def _face_dirs(face: int, size: int) -> jnp.ndarray:
    f, u, r = (np.asarray(a, np.float64) for a in _FACE_AXES[face])
    t = (np.arange(size) + 0.5) / size * 2 - 1
    vy, vx = np.meshgrid(-t, t, indexing="ij")
    d = f[None, None] + vx[..., None] * r[None, None] + vy[..., None] * u[None, None]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(d, _F32)


def sample_equirect(env: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Bilinear equirect lookup for unit directions d (..., 3)."""
    H, W = env.shape[:2]
    u = (jnp.arctan2(d[..., 0], d[..., 2]) / (2 * math.pi) + 0.5) * W - 0.5
    v = (jnp.arccos(jnp.clip(d[..., 1], -1, 1)) / math.pi) * H - 0.5
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, H - 2)
    fu = u - u0
    fv = jnp.clip(v - v0, 0, 1)
    u0m = jnp.mod(u0, W)
    u1m = jnp.mod(u0 + 1, W)
    a = env[v0, u0m] * (1 - fu[..., None]) + env[v0, u1m] * fu[..., None]
    b = env[v0 + 1, u0m] * (1 - fu[..., None]) + env[v0 + 1, u1m] * fu[..., None]
    return a * (1 - fv[..., None]) + b * fv[..., None]


def equirect_to_cubemap(env, size: int = 64) -> jnp.ndarray:
    """(6, size, size, 3) cubemap from an equirect HDR map."""
    env = jnp.asarray(env, _F32)
    faces = [sample_equirect(env, _face_dirs(f, size)) for f in range(6)]
    return jnp.stack(faces)


def _hammersley(n: int) -> np.ndarray:
    out = np.empty((n, 2), np.float64)
    for i in range(n):
        bits = i
        bits = (bits << 16 | bits >> 16) & 0xFFFFFFFF
        bits = ((bits & 0x55555555) << 1 | (bits & 0xAAAAAAAA) >> 1)
        bits = ((bits & 0x33333333) << 2 | (bits & 0xCCCCCCCC) >> 2)
        bits = ((bits & 0x0F0F0F0F) << 4 | (bits & 0xF0F0F0F0) >> 4)
        bits = ((bits & 0x00FF00FF) << 8 | (bits & 0xFF00FF00) >> 8)
        out[i] = (i / n, (bits & 0xFFFFFFFF) * 2.3283064365386963e-10)
    return out


def _ggx_sample(xi, roughness):
    a = roughness * roughness
    phi = 2 * math.pi * xi[:, 0]
    cos_t = np.sqrt((1 - xi[:, 1]) / (1 + (a * a - 1) * xi[:, 1]))
    sin_t = np.sqrt(np.maximum(1 - cos_t * cos_t, 0))
    return np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)


def prefilter_environment(env, *, base_size: int = 32, mips: int = 5,
                          samples: int = 64) -> List[jnp.ndarray]:
    """Roughness-prefiltered specular chain: mip m stores the GGX-convolved
    environment at roughness m/(mips-1); each level is an equirect map
    (H = base_size >> m clamped)."""
    env = jnp.asarray(env, _F32)
    out = []
    xi = _hammersley(samples)
    for m in range(mips):
        rough = m / max(mips - 1, 1)
        h = max(base_size >> m, 4)
        w = h * 2
        theta = (np.arange(h) + 0.5) / h * math.pi
        phi = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
        PH, TH = np.meshgrid(phi, theta)
        n = np.stack([np.sin(TH) * np.sin(PH), np.cos(TH),
                      np.sin(TH) * np.cos(PH)], -1)
        if m == 0:
            out.append(sample_equirect(env, jnp.asarray(n, _F32)))
            continue
        # tangent frame per texel
        up = np.where(np.abs(n[..., 1:2]) < 0.99,
                      np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
        t = np.cross(up, n)
        t /= np.linalg.norm(t, axis=-1, keepdims=True)
        b = np.cross(n, t)
        hs = _ggx_sample(xi, rough)           # (S, 3) in tangent space
        acc = jnp.zeros((h, w, 3), _F32)
        wsum = jnp.zeros((h, w, 1), _F32)
        for s in range(samples):
            hv = (t * hs[s, 0] + b * hs[s, 1] + n * hs[s, 2])
            # L = reflect(-n, h) with V=N approximation
            ndh = np.sum(n * hv, -1, keepdims=True)
            L = 2 * ndh * hv - n
            ndl = jnp.asarray(np.maximum(np.sum(n * L, -1, keepdims=True),
                                         0.0), _F32)
            acc = acc + sample_equirect(env, jnp.asarray(L, _F32)) * ndl
            wsum = wsum + ndl
        out.append(acc / jnp.maximum(wsum, 1e-6))
    return out


def brdf_lut(size: int = 32, samples: int = 128) -> jnp.ndarray:
    """Split-sum BRDF integration LUT: (size, size, 2) over
    (NdotV, roughness) -> (scale, bias) for F0."""
    nv = (np.arange(size) + 0.5) / size
    rough = (np.arange(size) + 0.5) / size
    NV, R = np.meshgrid(nv, rough, indexing="ij")
    V = np.stack([np.sqrt(1 - NV * NV), np.zeros_like(NV), NV], -1)
    xi = _hammersley(samples)
    A = np.zeros_like(NV)
    B = np.zeros_like(NV)
    for s in range(samples):
        a = R * R
        phi = 2 * math.pi * xi[s, 0]
        cos_t = np.sqrt((1 - xi[s, 1]) / (1 + (a * a - 1) * xi[s, 1]))
        sin_t = np.sqrt(np.maximum(1 - cos_t ** 2, 0))
        H = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1)
        vdh = np.sum(V * H, -1)
        L = 2 * vdh[..., None] * H - V
        ndl = L[..., 2]
        ok = ndl > 0
        ndh = np.maximum(H[..., 2], 0)
        vdh = np.maximum(vdh, 1e-6)
        k = (R * R) / 2
        g1l = np.maximum(ndl, 1e-6) / (np.maximum(ndl, 1e-6) * (1 - k) + k)
        g1v = np.maximum(NV, 1e-6) / (np.maximum(NV, 1e-6) * (1 - k) + k)
        G = g1l * g1v
        g_vis = np.where(ok, G * vdh / (ndh * np.maximum(NV, 1e-6) + 1e-9), 0)
        fc = (1 - vdh) ** 5
        A += np.where(ok, (1 - fc) * g_vis, 0.0)
        B += np.where(ok, fc * g_vis, 0.0)
    return jnp.asarray(np.stack([A, B], -1) / samples, _F32)


def irradiance_map(env, *, size: int = 16, samples: int = 256) -> jnp.ndarray:
    """Cosine-convolved diffuse irradiance (equirect, size x 2size)."""
    env = jnp.asarray(env, _F32)
    h, w = size, size * 2
    theta = (np.arange(h) + 0.5) / h * math.pi
    phi = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    PH, TH = np.meshgrid(phi, theta)
    n = np.stack([np.sin(TH) * np.sin(PH), np.cos(TH),
                  np.sin(TH) * np.cos(PH)], -1)
    up = np.where(np.abs(n[..., 1:2]) < 0.99,
                  np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    t = np.cross(up, n)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)
    xi = _hammersley(samples)
    acc = jnp.zeros((h, w, 3), _F32)
    for s in range(samples):
        # cosine-weighted hemisphere
        r = math.sqrt(xi[s, 1])
        ang = 2 * math.pi * xi[s, 0]
        lx, ly = r * math.cos(ang), r * math.sin(ang)
        lz = math.sqrt(max(1 - xi[s, 1], 0.0))
        d = t * lx + b * ly + n * lz
        acc = acc + sample_equirect(env, jnp.asarray(d, _F32))
    return acc / samples


class IblMaps(NamedTuple):
    cubemap: jnp.ndarray
    specular_mips: Tuple[jnp.ndarray, ...]
    brdf: jnp.ndarray
    irradiance: jnp.ndarray


def bake_ibl(env, *, quality: str = "medium") -> IblMaps:
    """Full IBL bake with quality tiers (the reference's tiered bake)."""
    tiers = {"low": (16, 3, 16, 16, 64),
             "medium": (32, 4, 32, 16, 128),
             "high": (64, 5, 64, 32, 256)}
    try:
        cube, mips, smp, isz, bs = tiers[quality]
    except KeyError:
        raise ValueError(f"unknown IBL quality {quality!r}") from None
    return IblMaps(
        cubemap=equirect_to_cubemap(env, cube),
        specular_mips=tuple(prefilter_environment(
            env, base_size=cube, mips=mips, samples=smp)),
        brdf=brdf_lut(isz, bs),
        irradiance=irradiance_map(env, size=isz, samples=smp * 2),
    )
