# forge3d_tpu/ops/restir.py
# ReSTIR DI reservoirs as structure-of-arrays pytrees + the temporal and
# spatial reuse passes, vectorized over all pixels.
#
# Parity notes (reference behavior, not code):
#   - Reservoir layout {LightSample, w_sum, M, W, target_pdf}, W = w_sum /
#     (M * target_pdf): /root/reference/src/path_tracing/restir/types.rs and
#     src/shaders/hybrid_terrain_traversal.wgsl:31-72
#   - History M-cap 512 with w_sum rescale: wgsl:66-68,393-402
#   - Temporal merge (pick-higher-weight, sum w_sum/M):
#     src/shaders/pt_restir_temporal.wgsl:56-109
#   - Spatial: K=8 random neighbors in radius 3, streaming RIS with
#     target-pdf re-evaluation at the receiver (directional lights: selection
#     probability with facing test): src/shaders/pt_restir_spatial.wgsl
#
# Design: a reservoir buffer is a NamedTuple of (H*W,) arrays
# (SoA), every pass is a fused elementwise/gather program. The spatial pass's
# per-candidate sequential stream (9 candidates) unrolls into a fori_loop —
# still data-parallel across pixels. The terrain reference only uses
# directional (sun) samples, so `light_type` is retained for layout parity
# and future area lights.

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .rng import xorshift32

_F32 = jnp.float32
_U32 = jnp.uint32

M_CAP = 512  # ReSTIR history cap (reference: TERRAIN_RESTIR_M_CAP)


class Reservoirs(NamedTuple):
    """SoA reservoir buffer over N pixels (directional-light samples carry
    direction + intensity; position/params omitted until area lights land)."""

    dir_x: jax.Array
    dir_y: jax.Array
    dir_z: jax.Array
    intensity: jax.Array
    light_type: jax.Array   # u32: 0 none/point, 1 directional, 2 area
    light_index: jax.Array  # u32
    w_sum: jax.Array
    m: jax.Array            # u32
    weight: jax.Array
    target_pdf: jax.Array

    @staticmethod
    def zeros(n: int) -> "Reservoirs":
        z = jnp.zeros((n,), _F32)
        zu = jnp.zeros((n,), _U32)
        return Reservoirs(z, z, z, z, zu, zu, z, zu, z, z)


def reservoir_weight(w_sum, m, target_pdf):
    return w_sum / (m.astype(_F32) * target_pdf)


def valid(r: Reservoirs):
    return (r.m > 0) & (r.weight > 0.0) & (r.target_pdf > 0.0)


def m_clamp(r: Reservoirs, cap: int = M_CAP) -> Reservoirs:
    """Rescale history to at most `cap` M before temporal merge
    (wgsl:393-402)."""
    over = r.m > cap
    scale = jnp.where(over, _F32(cap) / jnp.maximum(r.m.astype(_F32), 1.0), 1.0)
    w_sum = r.w_sum * scale
    m = jnp.where(over, _U32(cap), r.m)
    weight = jnp.where(
        over & (r.target_pdf > 0.0),
        reservoir_weight(w_sum, m, r.target_pdf),
        r.weight,
    )
    return r._replace(w_sum=w_sum, m=m, weight=weight)


def _select(pred, a: Reservoirs, b: Reservoirs) -> Reservoirs:
    return Reservoirs(*(jnp.where(pred, xa, xb) for xa, xb in zip(a, b)))


def temporal_merge(prev: Reservoirs, curr: Reservoirs) -> Reservoirs:
    """Combine last frame's merged history with fresh candidates
    (pt_restir_temporal.wgsl:56-109): keep the higher-weight sample, sum
    w_sum and M, refinalize W."""
    pv = valid(prev)
    cv = valid(curr)

    choose_prev = prev.weight > curr.weight
    merged_sample = _select(choose_prev, prev, curr)
    m = prev.m + curr.m
    w_sum = prev.w_sum + curr.w_sum
    tp = merged_sample.target_pdf
    weight = jnp.where((w_sum > 0.0) & (tp > 0.0),
                       w_sum / (m.astype(_F32) * jnp.maximum(tp, 1e-30)), 0.0)
    merged = merged_sample._replace(w_sum=w_sum, m=m, weight=weight)

    out = _select(pv & cv, merged, _select(pv, prev, curr))
    return out


def spatial_reuse(
    res_in: Reservoirs,
    gb_nx, gb_ny, gb_nz,           # receiver G-buffer normals
    width: int, height: int,
    frame_index, seed_hi,
    k_neighbors: int = 8, radius: int = 3,
) -> Reservoirs:
    """K-neighbor streaming RIS (pt_restir_spatial.wgsl main): directional
    lights only (single sun ⇒ selection pdf 1, facing test against the
    receiver normal)."""
    n = width * height
    idx = jnp.arange(n, dtype=_U32)
    x = (idx % width).astype(jnp.int32)
    y = (idx // width).astype(jnp.int32)

    seed = (_U32(seed_hi) ^ _U32(frame_index)) + idx * _U32(1664525) + _U32(1013904223)

    def consider(state, cand: Reservoirs, is_self):
        w_acc, ch, ch_pdf, seed = state
        # p_curr for a single directional light: selection pdf 1 gated by the
        # receiver facing the sample direction.
        inv = jax.lax.rsqrt(
            cand.dir_x**2 + cand.dir_y**2 + cand.dir_z**2 + 1e-30
        )
        cosr = gb_nx * cand.dir_x * inv + gb_ny * cand.dir_y * inv + gb_nz * cand.dir_z * inv
        ok = (cand.light_type == 1) & (cosr > 0.0) & (cand.target_pdf > 0.0)
        p_curr = jnp.where(ok, 1.0, 0.0)
        w = jnp.where(ok, cand.w_sum * (p_curr / jnp.maximum(cand.target_pdf, 1e-6)), 0.0)
        take = w > 0.0
        w_acc = w_acc + jnp.where(take, w, 0.0)
        seed, u = xorshift32(seed)
        choose = take & (u < w / jnp.maximum(w_acc, 1e-30))
        ch = _select(choose, cand, ch)
        ch_pdf = jnp.where(choose, p_curr, ch_pdf)
        return (w_acc, ch, ch_pdf, seed)

    r_self = Reservoirs(*(jnp.take(c, idx) for c in res_in))
    state = (jnp.zeros((n,), _F32), r_self, r_self.target_pdf, seed)
    state = consider(state, r_self, True)
    m_total = r_self.m

    for _ in range(k_neighbors):
        w_acc, ch, ch_pdf, seed = state
        seed, u1 = xorshift32(seed)
        seed, u2 = xorshift32(seed)
        span = 2 * radius + 1
        rx = jnp.floor(u1 * span).astype(jnp.int32) - radius
        ry = jnp.floor(u2 * span).astype(jnp.int32) - radius
        self_tap = (rx == 0) & (ry == 0)
        nx_i = jnp.clip(x + rx, 0, width - 1)
        ny_i = jnp.clip(y + ry, 0, height - 1)
        ni = (ny_i * width + nx_i).astype(jnp.int32)
        rn = Reservoirs(*(jnp.take(c, ni) for c in res_in))
        # Skip the (0,0) tap like the reference's `continue` (also skip its
        # RNG draws happening inside consider_candidate).
        before = (w_acc, ch, ch_pdf, seed)
        after = consider((w_acc, ch, ch_pdf, seed), rn, False)
        state = tuple(
            jax.tree_util.tree_map(lambda a, b: jnp.where(self_tap, a, b), bs, as_)
            for bs, as_ in zip(before, after)
        )
        m_total = m_total + jnp.where(self_tap, 0, rn.m).astype(_U32)

    w_acc, ch, ch_pdf, _ = state
    tp = ch_pdf
    weight = jnp.where((w_acc > 0.0) & (tp > 0.0),
                       w_acc / (m_total.astype(_F32) * jnp.maximum(tp, 1e-30)), 0.0)
    return ch._replace(w_sum=w_acc, m=m_total, weight=weight, target_pdf=tp)
