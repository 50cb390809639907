# forge3d_tpu/guiding.py
# Path guiding: spatial-directional radiance caching to steer bounce
# sampling (reference seam: python/forge3d/guiding.py).
#
# Parity notes (reference behavior, not code): the reference exposes a
# guiding module that accumulates a luminance histogram over direction
# bins per spatial cell and importance-samples bounces from it. Here:
# the cache is a dense (cells, bins) array updated with scatter-adds and
# sampled with the alias-free CDF inversion — all fused jnp; bins follow a
# concentric octahedral mapping (uniform solid angle).

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["GuidingCache", "octa_encode", "octa_decode"]

_F32 = jnp.float32


def octa_encode(dx, dy, dz, res: int):
    """Direction -> octahedral bin index in [0, res*res)."""
    ax = jnp.abs(dx)
    ay = jnp.abs(dy)
    az = jnp.abs(dz)
    norm = ax + ay + az
    u = dx / norm
    v = dz / norm
    # fold the lower hemisphere
    lower = dy < 0
    u2 = jnp.where(lower, (1 - jnp.abs(v)) * jnp.sign(u), u)
    v2 = jnp.where(lower, (1 - jnp.abs(u)) * jnp.sign(v), v)
    iu = jnp.clip(((u2 * 0.5 + 0.5) * res).astype(jnp.int32), 0, res - 1)
    iv = jnp.clip(((v2 * 0.5 + 0.5) * res).astype(jnp.int32), 0, res - 1)
    return iv * res + iu


def octa_decode(bin_idx, res: int):
    """Bin center -> unit direction."""
    iv = bin_idx // res
    iu = bin_idx % res
    u = (iu.astype(_F32) + 0.5) / res * 2 - 1
    v = (iv.astype(_F32) + 0.5) / res * 2 - 1
    y = 1 - jnp.abs(u) - jnp.abs(v)
    lower = y < 0
    u2 = jnp.where(lower, (1 - jnp.abs(v)) * jnp.sign(u), u)
    v2 = jnp.where(lower, (1 - jnp.abs(u)) * jnp.sign(v), v)
    d = jnp.stack([u2, y, v2], -1)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


class GuidingCache(NamedTuple):
    """(cells_x * cells_z, bins) luminance histogram over a world AABB."""

    hist: jax.Array
    origin: Tuple[float, float]
    extent: Tuple[float, float]
    cells: int
    octa_res: int

    @staticmethod
    def create(origin_xz, extent_xz, *, cells: int = 32,
               octa_res: int = 8) -> "GuidingCache":
        return GuidingCache(
            hist=jnp.full((cells * cells, octa_res * octa_res), 1e-3, _F32),
            origin=(float(origin_xz[0]), float(origin_xz[1])),
            extent=(float(extent_xz[0]), float(extent_xz[1])),
            cells=cells, octa_res=octa_res)

    def _cell_of(self, px, pz):
        cx = jnp.clip(((px - self.origin[0]) / self.extent[0]
                       * self.cells).astype(jnp.int32), 0, self.cells - 1)
        cz = jnp.clip(((pz - self.origin[1]) / self.extent[1]
                       * self.cells).astype(jnp.int32), 0, self.cells - 1)
        return cz * self.cells + cx

    def record(self, px, pz, dx, dy, dz, luminance) -> "GuidingCache":
        """Scatter-add observed radiance into the cache (pure update)."""
        cell = self._cell_of(jnp.asarray(px, _F32), jnp.asarray(pz, _F32))
        b = octa_encode(jnp.asarray(dx, _F32), jnp.asarray(dy, _F32),
                        jnp.asarray(dz, _F32), self.octa_res)
        flat = cell * (self.octa_res ** 2) + b
        hist = self.hist.reshape(-1).at[flat.reshape(-1)].add(
            jnp.asarray(luminance, _F32).reshape(-1))
        return self._replace(hist=hist.reshape(self.hist.shape))

    def sample(self, px, pz, u1, u2):
        """Importance-sample a direction per point from the cached
        distribution; returns (dx, dy, dz, pdf). CDF inversion per cell."""
        cell = self._cell_of(jnp.asarray(px, _F32), jnp.asarray(pz, _F32))
        rows = jnp.take(self.hist, cell, axis=0)          # (..., bins)
        total = jnp.sum(rows, -1, keepdims=True)
        cdf = jnp.cumsum(rows, -1) / jnp.maximum(total, 1e-20)
        r = jnp.asarray(u1, _F32)[..., None]
        bin_idx = jnp.sum((cdf < r).astype(jnp.int32), -1)
        bin_idx = jnp.clip(bin_idx, 0, self.octa_res ** 2 - 1)
        d = octa_decode(bin_idx, self.octa_res)
        pdf_bin = jnp.take_along_axis(
            rows, bin_idx[..., None], -1)[..., 0] / jnp.maximum(total[..., 0],
                                                                1e-20)
        # bin solid angle = 4pi / bins
        pdf = pdf_bin * (self.octa_res ** 2) / (4 * math.pi)
        # jitter within the bin via u2 (rotate slightly around y)
        ang = (jnp.asarray(u2, _F32) - 0.5) * (2 * math.pi / self.octa_res)
        ca = jnp.cos(ang)
        sa = jnp.sin(ang)
        dx = d[..., 0] * ca - d[..., 2] * sa
        dz = d[..., 0] * sa + d[..., 2] * ca
        return dx, d[..., 1], dz, pdf

    def stats(self) -> dict:
        h = np.asarray(self.hist)
        return {"cells": self.cells, "bins": self.octa_res ** 2,
                "total_energy": float(h.sum()),
                "max_cell_energy": float(h.sum(-1).max()),
                "nbytes": int(h.nbytes)}
