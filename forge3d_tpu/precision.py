# forge3d_tpu/precision.py
# DUPLA: double-float (f32 pair) arithmetic with measured error-bound
# proofs and the camera-jitter demo.
#
# Parity notes (reference behavior, not code): /root/reference/src/core/dd/
# (dd.rs:1-27) implements DD = (hi, lo) f32 pairs with two_sum/two_prod
# building blocks, mirrored bit-for-bit in WGSL (dd_harness.wgsl), plus
# `dd_selftest` error-bound verification over large random vectors
# (CHANGELOG 1.34.0: add 2.39/3 u^2, mul 5.63/7, div 5.92/15, sqrt 3.34/15)
# and `dd_jitter_demo` showing f64-scale camera anchoring. Here: the
# same algorithms in jnp run on-device; XLA must not re-associate, so all
# kernels force explicit operation order via jnp primitives (safe: XLA
# does not re-associate f32 adds across data dependencies).
#
# DD ops here are Dekker/Knuth error-free transformations:
#   two_sum: exact a+b = s + e;  two_prod via FMA-free Dekker split.

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DD", "dd_from_f64", "dd_to_f64", "dd_add", "dd_mul", "dd_div",
           "dd_sqrt", "two_sum", "two_prod", "dd_selftest", "dd_harness",
           "dd_jitter_demo"]

_F32 = jnp.float32
_U = 2.0 ** -24  # f32 unit roundoff


class DD(NamedTuple):
    """Unevaluated sum hi + lo with |lo| <= ulp(hi)/2."""

    hi: jax.Array
    lo: jax.Array


def two_sum(a, b) -> Tuple[jax.Array, jax.Array]:
    """Knuth two-sum: s + e == a + b exactly (f32)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split of f32 into hi/lo 12-bit halves (2^12+1 factor)."""
    c = _F32(4097.0) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b) -> Tuple[jax.Array, jax.Array]:
    """Dekker two-product: p + e == a*b exactly (barring overflow)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_from_f64(x) -> DD:
    """Split f64 host values into a DD pair."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DD(jnp.asarray(hi), jnp.asarray(lo))


def dd_to_f64(d: DD) -> np.ndarray:
    return (np.asarray(d.hi, np.float64) + np.asarray(d.lo, np.float64))


def dd_add(a: DD, b: DD) -> DD:
    s, e = two_sum(a.hi, b.hi)
    e = e + (a.lo + b.lo)
    hi, lo = two_sum(s, e)
    return DD(hi, lo)


def dd_mul(a: DD, b: DD) -> DD:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    hi, lo = two_sum(p, e)
    return DD(hi, lo)


def dd_div(a: DD, b: DD) -> DD:
    q1 = a.hi / b.hi
    # residual r = a - q1*b computed in DD
    p, e = two_prod(q1, b.hi)
    r_hi, r_e = two_sum(a.hi, -p)
    r = r_hi + (r_e + a.lo - e - q1 * b.lo)
    q2 = r / b.hi
    hi, lo = two_sum(q1, q2)
    return DD(hi, lo)


def dd_sqrt(a: DD) -> DD:
    q1 = jnp.sqrt(a.hi)
    safe = q1 > 0
    q1s = jnp.where(safe, q1, 1.0)
    p, e = two_prod(q1s, q1s)
    r_hi, r_e = two_sum(a.hi, -p)
    r = r_hi + (r_e + a.lo - e)
    q2 = r / (2.0 * q1s)
    hi, lo = two_sum(q1s, q2)
    return DD(jnp.where(safe, hi, 0.0), jnp.where(safe, lo, 0.0))


# ---------------------------------------------------------------------------
# proofs


_BOUNDS_U2 = {"add": 3.0, "mul": 7.0, "div": 15.0, "sqrt": 15.0}


def dd_selftest(n: int = 1_000_000, seed: int = 0) -> dict:
    """Measure DD op error against f64 oracle over random vectors; verify
    the committed u^2 bounds (reference seam: dd_selftest; bounds mirror
    CHANGELOG 1.34.0 gates). Returns per-op {max_err_u2, bound_u2, ok}."""
    rng = np.random.default_rng(seed)
    a64 = rng.uniform(-1e3, 1e3, n)
    b64 = rng.uniform(-1e3, 1e3, n)
    b64 = np.where(np.abs(b64) < 1e-3, 1.0, b64)
    a = dd_from_f64(a64)
    b = dd_from_f64(b64)

    report = {}

    def check(name, got_dd, want64, denom=None):
        got = dd_to_f64(got_dd)
        # relative error in units of u^2; for add the bound is relative to
        # |a|+|b| (cancellation makes result-relative error unbounded)
        denom = np.maximum(np.abs(want64) if denom is None else denom, 1e-300)
        rel = np.abs(got - want64) / denom
        max_u2 = float(rel.max() / (_U * _U))
        report[name] = {"max_err_u2": max_u2,
                        "bound_u2": _BOUNDS_U2[name],
                        "ok": bool(max_u2 <= _BOUNDS_U2[name])}

    check("add", dd_add(a, b), a64 + b64, denom=np.abs(a64) + np.abs(b64))
    check("mul", dd_mul(a, b), a64 * b64)
    check("div", dd_div(a, b), a64 / b64)
    pos = np.abs(a64)
    check("sqrt", dd_sqrt(dd_from_f64(pos)), np.sqrt(pos))
    report["n"] = n
    report["ok"] = all(report[k]["ok"] for k in _BOUNDS_U2)
    return report


def dd_harness(op: str, a, b=None) -> dict:
    """Run one DD op on-device and return hi/lo + f64 oracle comparison
    (reference seam: dd_harness, mirroring the WGSL lockstep harness)."""
    a64 = np.asarray(a, np.float64)
    ad = dd_from_f64(a64)
    if op == "add":
        b64 = np.asarray(b, np.float64)
        out = dd_add(ad, dd_from_f64(b64))
        want = a64 + b64
    elif op == "mul":
        b64 = np.asarray(b, np.float64)
        out = dd_mul(ad, dd_from_f64(b64))
        want = a64 * b64
    elif op == "div":
        b64 = np.asarray(b, np.float64)
        out = dd_div(ad, dd_from_f64(b64))
        want = a64 / b64
    elif op == "sqrt":
        out = dd_sqrt(ad)
        want = np.sqrt(a64)
    else:
        raise ValueError(f"unknown dd op: {op}")
    got = dd_to_f64(out)
    return {"op": op, "hi": np.asarray(out.hi).tolist(),
            "lo": np.asarray(out.lo).tolist(),
            "result_f64": got.tolist(),
            "oracle_f64": np.asarray(want).tolist(),
            "max_abs_err": float(np.max(np.abs(got - want)))}


def dd_jitter_demo(anchor: float = 1.0e7, extent: float = 2.0,
                   n: int = 1024, seed: int = 3) -> dict:
    """Camera-anchor precision demo: positions near a large world anchor
    lose sub-meter detail in plain f32; DD keeps it (reference seam:
    dd_jitter_demo — the MENSURA f64-anchor motivation)."""
    rng = np.random.default_rng(seed)
    offsets = rng.uniform(-extent, extent, n)
    world = anchor + offsets

    # plain f32 path: world positions stored in f32, camera-relative delta
    f32_rel = (world.astype(np.float32)
               - np.float32(anchor)).astype(np.float64)
    f32_err = np.abs(f32_rel - offsets)

    # DD path: world stored as DD, subtract DD anchor
    w = dd_from_f64(world)
    a = dd_from_f64(np.full(n, anchor))
    rel = dd_add(w, DD(-a.hi, -a.lo))
    dd_err = np.abs(dd_to_f64(rel) - offsets)

    return {
        "anchor": anchor,
        "extent": extent,
        "f32_max_err": float(f32_err.max()),
        "dd_max_err": float(dd_err.max()),
        "improvement": float(f32_err.max() / max(dd_err.max(), 1e-300))
        if dd_err.max() > 0 else math.inf,
    }
