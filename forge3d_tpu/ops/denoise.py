# forge3d_tpu/ops/denoise.py
# Edge-avoiding à-trous (SVGF-style) guided denoiser as fused jnp
# convolutions.
#
# Parity notes (reference behavior, not code):
#   /root/reference/python/forge3d/denoise.py + src/shaders/denoise_atrous.wgsl:
#   iterative à-trous wavelet passes with doubling step, guided by
#   albedo/normal/depth AOVs via per-pixel weights
#   w = w_color * w_albedo * w_normal * w_depth, each exp(-dist/sigma).
#
# Here: each iteration is 25 shifted adds (5x5 à-trous kernel) over
# the whole image — pure elementwise math that XLA fuses; no gather.

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_KERNEL_1D = jnp.asarray([1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16], jnp.float32)


def _shift2d(a, dy, dx):
    """Edge-clamped shift of (H, W, ...) array."""
    if dy > 0:
        a = jnp.concatenate([a[:1]] * dy + [a[:-dy]], axis=0)
    elif dy < 0:
        a = jnp.concatenate([a[-dy:]] + [a[-1:]] * (-dy), axis=0)
    if dx > 0:
        a = jnp.concatenate([a[:, :1]] * dx + [a[:, :-dx]], axis=1)
    elif dx < 0:
        a = jnp.concatenate([a[:, -dx:]] + [a[:, -1:]] * (-dx), axis=1)
    return a


def atrous_denoise(
    color,
    albedo=None,
    normal=None,
    depth=None,
    iterations: int = 5,
    sigma_color: float = 0.30,
    sigma_albedo: float = 0.30,
    sigma_normal: float = 0.60,
    sigma_depth: float = 0.80,
):
    """Guided à-trous denoise of (H, W, 3) color; returns same shape.

    Guidance planes are optional; missing planes simply drop their weight
    term (reference contract).
    """
    c = jnp.asarray(color, jnp.float32)
    if c.ndim != 3 or c.shape[2] != 3:
        raise ValueError("color must be (H, W, 3)")
    alb = None if albedo is None else jnp.asarray(albedo, jnp.float32)
    nrm = None if normal is None else jnp.asarray(normal, jnp.float32)
    dep = None if depth is None else jnp.asarray(depth, jnp.float32)
    if dep is not None:
        dep = jnp.nan_to_num(dep, nan=0.0, posinf=0.0)
        scale = jnp.maximum(jnp.max(jnp.abs(dep)), 1e-6)
        dep = dep / scale

    out = c
    for it in range(int(iterations)):
        step = 1 << it
        acc = jnp.zeros_like(out)
        wacc = jnp.zeros_like(out[..., :1])
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                kw = float(_KERNEL_1D[ky + 2] * _KERNEL_1D[kx + 2])
                dy, dx = ky * step, kx * step
                cs = _shift2d(out, dy, dx)
                w = jnp.full_like(wacc, kw)
                dc = jnp.sum((cs - out) ** 2, -1, keepdims=True)
                w = w * jnp.exp(-dc / (sigma_color**2 + 1e-8))
                if alb is not None:
                    da = jnp.sum((_shift2d(alb, dy, dx) - alb) ** 2, -1, keepdims=True)
                    w = w * jnp.exp(-da / (sigma_albedo**2 + 1e-8))
                if nrm is not None:
                    dn = jnp.sum((_shift2d(nrm, dy, dx) - nrm) ** 2, -1, keepdims=True)
                    w = w * jnp.exp(-dn / (sigma_normal**2 + 1e-8))
                if dep is not None:
                    dd = (_shift2d(dep, dy, dx) - dep) ** 2
                    if dd.ndim == 2:
                        dd = dd[..., None]
                    w = w * jnp.exp(-dd / (sigma_depth**2 + 1e-8))
                acc = acc + cs * w
                wacc = wacc + w
        out = acc / jnp.maximum(wacc, 1e-8)
    return out


def svgf_denoise(color, aovs: dict, iterations: int = 5):
    """SVGF-flavored wrapper taking an AOV dict (albedo/normal/depth)."""
    return atrous_denoise(
        color,
        albedo=aovs.get("albedo"),
        normal=aovs.get("normal"),
        depth=aovs.get("depth"),
        iterations=iterations,
    )


def oidn_denoise(color, **kwargs):
    """OIDN is not bundled with this build; fail closed with a typed error so
    callers can fall back (reference: denoise_oidn.py raises when the
    library is missing)."""
    raise NotImplementedError(
        "OIDN is not available in this build; use atrous_denoise/svgf_denoise"
    )
