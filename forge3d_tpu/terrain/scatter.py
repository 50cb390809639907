# forge3d_tpu/terrain/scatter.py
# Terrain scatter: instanced vegetation/rock placement over a heightfield
# with density masks, slope/height rules, and memory/stats reports.
#
# Parity notes (reference behavior, not code): /root/reference/src/terrain/
# scatter.rs + renderer/scatter.rs + python/forge3d/terrain_scatter.py
# (938 LoC) place instance batches (position, rotation, scale, kind) by
# deterministic stratified sampling filtered by slope/height/mask rules,
# and report per-batch instance counts + memory. Here: placement is
# host-side numpy (deterministic, seeded); rendering instances as
# billboards/meshes feeds the mesh tracer or splat compositor.

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ScatterRule", "ScatterBatch", "scatter_instances",
           "scatter_stats", "scatter_memory_report"]


@dataclass
class ScatterRule:
    """Placement rule for one instance kind."""

    kind: str = "tree"
    density: float = 0.02             # instances per cell
    min_height: float = -1e30
    max_height: float = 1e30
    max_slope_deg: float = 35.0
    scale_range: Tuple[float, float] = (0.8, 1.3)
    align_to_normal: bool = False
    mask: Optional[np.ndarray] = None  # (H, W) in [0,1] multiplies density
    seed: int = 0


@dataclass
class ScatterBatch:
    kind: str
    positions: np.ndarray      # (N, 3) world
    rotations: np.ndarray      # (N,) yaw radians
    scales: np.ndarray         # (N,)
    normals: np.ndarray        # (N, 3)

    @property
    def count(self) -> int:
        return int(len(self.positions))

    @property
    def nbytes(self) -> int:
        return (self.positions.nbytes + self.rotations.nbytes
                + self.scales.nbytes + self.normals.nbytes)


def _slope_normal(heights: np.ndarray, spacing: Tuple[float, float]):
    gz, gx = np.gradient(heights.astype(np.float64))
    gx /= spacing[0]
    gz /= spacing[1]
    n = np.stack([-gx, np.ones_like(gx), -gz], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    slope = np.degrees(np.arccos(np.clip(n[..., 1], -1, 1)))
    return n, slope


def scatter_instances(heights: np.ndarray, rules: List[ScatterRule], *,
                      origin_xz=(0.0, 0.0), spacing=(1.0, 1.0),
                      exaggeration: float = 1.0) -> List[ScatterBatch]:
    """Deterministic stratified scatter over the DEM (reference seam:
    the TerrainRenderer scatter API). Each cell draws a Poisson-ish count
    from the rule density, positions jittered inside the cell, filtered by
    height/slope/mask."""
    h = np.asarray(heights, np.float64) * exaggeration
    H, W = h.shape
    normals, slope = _slope_normal(h, spacing)
    batches = []
    for rule in rules:
        import zlib

        # stable cross-process hash (python hash() is salted per run)
        kind_key = zlib.crc32(rule.kind.encode())
        rng = np.random.default_rng(
            np.random.SeedSequence([kind_key, rule.seed]))
        density = np.full((H - 1, W - 1), rule.density)
        if rule.mask is not None:
            m = np.asarray(rule.mask, np.float64)
            if m.shape != (H - 1, W - 1):
                # resample nearest
                yi = np.clip((np.arange(H - 1) * m.shape[0]) // (H - 1), 0,
                             m.shape[0] - 1)
                xi = np.clip((np.arange(W - 1) * m.shape[1]) // (W - 1), 0,
                             m.shape[1] - 1)
                m = m[np.ix_(yi, xi)]
            density = density * m
        counts = rng.poisson(np.maximum(density, 0.0))
        total = int(counts.sum())
        if total == 0:
            batches.append(ScatterBatch(rule.kind,
                                        np.zeros((0, 3)), np.zeros(0),
                                        np.zeros(0), np.zeros((0, 3))))
            continue
        cz, cx = np.nonzero(counts)
        reps = counts[cz, cx]
        cz = np.repeat(cz, reps)
        cx = np.repeat(cx, reps)
        u = rng.random(total)
        v = rng.random(total)
        px = origin_xz[0] + (cx + u) * spacing[0]
        pz = origin_xz[1] + (cz + v) * spacing[1]
        # bilinear height
        h00 = h[cz, cx]
        h10 = h[cz, cx + 1]
        h01 = h[cz + 1, cx]
        h11 = h[cz + 1, cx + 1]
        py = (h00 * (1 - u) + h10 * u) * (1 - v) + (h01 * (1 - u) + h11 * u) * v
        nrm = normals[cz, cx]
        slp = slope[cz, cx]
        keep = ((py >= rule.min_height) & (py <= rule.max_height)
                & (slp <= rule.max_slope_deg))
        batches.append(ScatterBatch(
            kind=rule.kind,
            positions=np.stack([px, py, pz], -1)[keep].astype(np.float32),
            rotations=(rng.random(total) * 2 * math.pi)[keep].astype(np.float32),
            scales=(rule.scale_range[0]
                    + rng.random(total)
                    * (rule.scale_range[1] - rule.scale_range[0])
                    )[keep].astype(np.float32),
            normals=nrm[keep].astype(np.float32),
        ))
    return batches


def scatter_stats(batches: List[ScatterBatch]) -> dict:
    """Per-kind instance counts (reference seam: scatter stats report)."""
    return {
        "total_instances": sum(b.count for b in batches),
        "batches": {b.kind: b.count for b in batches},
    }


def scatter_memory_report(batches: List[ScatterBatch]) -> dict:
    """Instance memory accounting (reference seam: scatter memory report)."""
    per = {b.kind: b.nbytes for b in batches}
    return {"total_bytes": sum(per.values()), "per_batch_bytes": per}
