# forge3d_tpu/shadows.py
# CSM-equivalent global shadow state + cascade math.
#
# Parity notes (reference behavior, not code): the reference keeps a
# GLOBAL_CSM_STATE mutex (src/lib.rs:57-59) driven by configure_csm /
# set_csm_enabled / set_csm_light_direction / set_csm_pcf_kernel /
# set_csm_bias_params / set_csm_debug_mode / get_csm_cascade_info /
# validate_csm_peter_panning, with cascade split math in
# src/shadows/cascade_math.rs. Translation: shadows are heightfield
# ray queries (no shadow maps), but the SAME state drives shadow quality
# (ray count = PCF kernel analogue, bias = ray-origin offset), and the
# cascade-split math is kept for parity + the viewer's cascade debug view.

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["configure_csm", "set_csm_enabled", "set_csm_light_direction",
           "set_csm_pcf_kernel", "set_csm_bias_params", "set_csm_debug_mode",
           "get_csm_cascade_info", "validate_csm_peter_panning",
           "cascade_splits", "csm_state"]

_LOCK = threading.Lock()
_STATE: Dict[str, object] = {
    "enabled": True,
    "cascade_count": 4,
    "lambda": 0.7,                 # log/uniform split blend
    "near": 0.1,
    "far": 1000.0,
    "light_direction": (-0.5, -0.8, -0.3),
    "pcf_kernel": 3,               # -> shadow ray sample count analogue
    "bias": 1e-3,                  # ray-origin normal offset
    "slope_bias": 2e-3,
    "debug_mode": 0,
}


def cascade_splits(near: float, far: float, count: int,
                   lam: float = 0.7) -> List[float]:
    """Practical split scheme: blend of uniform and logarithmic splits
    (the reference's cascade_math contract)."""
    if not (0 < near < far):
        raise ValueError("require 0 < near < far")
    if count < 1:
        raise ValueError("cascade_count must be >= 1")
    splits = []
    for i in range(1, count + 1):
        f = i / count
        uni = near + (far - near) * f
        logd = near * (far / near) ** f
        splits.append(lam * logd + (1 - lam) * uni)
    return splits


def configure_csm(cascade_count: int = 4, near: float = 0.1,
                  far: float = 1000.0, lam: float = 0.7, **kw) -> dict:
    """Configure the global CSM state (reference seam: configure_csm)."""
    if not (1 <= cascade_count <= 8):
        raise ValueError("cascade_count in [1, 8]")
    with _LOCK:
        _STATE.update(cascade_count=int(cascade_count), near=float(near),
                      far=float(far))
        _STATE["lambda"] = float(lam)
        for k, v in kw.items():
            if k in _STATE:
                _STATE[k] = v
    return csm_state()


def set_csm_enabled(enabled: bool) -> None:
    with _LOCK:
        _STATE["enabled"] = bool(enabled)


def set_csm_light_direction(x: float, y: float, z: float) -> None:
    n = math.sqrt(x * x + y * y + z * z)
    if n < 1e-9:
        raise ValueError("light direction must be non-zero")
    with _LOCK:
        _STATE["light_direction"] = (x / n, y / n, z / n)


def set_csm_pcf_kernel(size: int) -> None:
    if size not in (1, 3, 5, 7):
        raise ValueError("pcf kernel must be 1, 3, 5 or 7")
    with _LOCK:
        _STATE["pcf_kernel"] = int(size)


def set_csm_bias_params(bias: float, slope_bias: float) -> None:
    if bias < 0 or slope_bias < 0:
        raise ValueError("biases must be >= 0")
    with _LOCK:
        _STATE["bias"] = float(bias)
        _STATE["slope_bias"] = float(slope_bias)


def set_csm_debug_mode(mode: int) -> None:
    with _LOCK:
        _STATE["debug_mode"] = int(mode)


def csm_state() -> dict:
    with _LOCK:
        return dict(_STATE)


def get_csm_cascade_info() -> dict:
    """Cascade split distances + per-cascade texel-density analogue
    (reference seam: get_csm_cascade_info)."""
    s = csm_state()
    splits = cascade_splits(s["near"], s["far"], s["cascade_count"],
                            s["lambda"])
    cascades = []
    prev = s["near"]
    for i, sp in enumerate(splits):
        cascades.append({"index": i, "near": prev, "far": sp,
                         "extent": sp - prev})
        prev = sp
    return {"enabled": s["enabled"], "count": s["cascade_count"],
            "splits": splits, "cascades": cascades,
            "light_direction": s["light_direction"],
            "pcf_kernel": s["pcf_kernel"]}


def validate_csm_peter_panning(heights: np.ndarray, *,
                               spacing: Tuple[float, float] = (1.0, 1.0),
                               samples: int = 128, seed: int = 0) -> dict:
    """Peter-panning validation (reference seam:
    validate_csm_peter_panning): with ray-traced shadows the failure mode
    is the bias detaching contact shadows — probe random surface points
    and check each point with zero bias is occluded by itself (bias=0 ->
    self-intersection) while the configured bias is NOT (no detachment).
    """
    from .ops.pyramid import build_pyramid
    from .ops.traversal import scene_from_pyramid, trace

    import jax.numpy as jnp

    s = csm_state()
    h = np.asarray(heights, np.float32)
    pyr = build_pyramid(h)
    scene, static = scene_from_pyramid(pyr, spacing_xz=spacing)
    rng = np.random.default_rng(seed)
    H, W = h.shape
    cx = rng.uniform(0.5, W - 1.5, samples)
    cz = rng.uniform(0.5, H - 1.5, samples)
    cy = np.array([h[int(z), int(x)] for x, z in zip(cx, cz)]) + 0.0
    ld = np.asarray(s["light_direction"], np.float64)
    to_sun = tuple(np.full(samples, -v, np.float32) for v in ld)
    bias = float(s["bias"])
    ro_biased = (jnp.asarray(cx, jnp.float32),
                 jnp.asarray(cy + bias + 1e-4, jnp.float32),
                 jnp.asarray(cz, jnp.float32))
    occ = np.asarray(trace(scene, static, ro_biased, to_sun).hit)
    # detached contact shadows: all probes unoccluded under extreme bias
    extreme = (jnp.asarray(cx, jnp.float32),
               jnp.asarray(cy + 10.0 * (h.max() - h.min() + 1), jnp.float32),
               jnp.asarray(cz, jnp.float32))
    occ_extreme = np.asarray(trace(scene, static, extreme, to_sun).hit)
    return {
        "bias": bias,
        "occluded_fraction": float(occ.mean()),
        "extreme_bias_occluded_fraction": float(occ_extreme.mean()),
        "peter_panning_detected": bool(occ.mean()
                                       <= occ_extreme.mean() + 1e-6
                                       and occ.mean() < 0.01),
        "samples": samples,
    }
