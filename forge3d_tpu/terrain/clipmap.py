# forge3d_tpu/terrain/clipmap.py
# Clipmap terrain: nested-ring LOD levels with toroidal update, geomorph
# weights, and streamed DEM tiles — the out-of-core spatial-scale system.
#
# Parity notes (reference behavior, not code): /root/reference/src/terrain/
# clipmap/{ring.rs, level.rs, geomorph.rs, gpu_lod.rs, streaming.rs} keep
# L nested rings centered on the camera, each covering 2x the extent of
# the previous at half resolution, updated incrementally as the camera
# moves (toroidal addressing so only newly-exposed rows/cols upload), with
# geomorphing between levels. Translation: each level is a fixed
# (N, N) f32 array in HBM (static shapes for jit); recentering computes
# the newly-exposed strips host-side and updates via jnp dynamic slices;
# the renderer samples the finest level containing each query point.

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

__all__ = ["ClipmapConfig", "Clipmap", "geomorph_weight"]


@dataclass(frozen=True)
class ClipmapConfig:
    levels: int = 5
    size: int = 129                  # texels per level side (odd: center)
    base_spacing: float = 1.0        # world units per texel at level 0


def geomorph_weight(dist_from_center: np.ndarray, level_extent: float,
                    blend_band: float = 0.2) -> np.ndarray:
    """Blend weight toward the next-coarser level near the ring edge
    (reference: geomorph.rs:424 semantics — 0 inside, ramp to 1 at the
    outer blend band)."""
    inner = level_extent * (1.0 - blend_band)
    return np.clip((np.asarray(dist_from_center) - inner)
                   / max(level_extent - inner, 1e-9), 0.0, 1.0)


class Clipmap:
    """Nested-ring height clipmap fed by a source sampler.

    `source(x0, z0, step, n)` returns an (n, n) height window sampled at
    world positions x0 + i*step, z0 + j*step — typically a windowed
    GeoTIFF/COG read or a procedural DEM.
    """

    def __init__(self, source: Callable[[float, float, float, int], np.ndarray],
                 config: ClipmapConfig = ClipmapConfig()):
        self.source = source
        self.cfg = config
        self.levels: List[np.ndarray] = []
        self.centers: List[Tuple[float, float]] = []
        self.update_counts = [0] * config.levels
        self.texels_streamed = 0
        self._centered = False

    # ------------------------------------------------------------------ api
    def spacing(self, level: int) -> float:
        return self.cfg.base_spacing * (2 ** level)

    def extent(self, level: int) -> float:
        return self.spacing(level) * (self.cfg.size - 1) / 2

    def center_on(self, x: float, z: float) -> dict:
        """(Re)center all rings on a world position; returns stream stats.

        Each level snaps its center to its own texel grid (so finer levels
        move more often), and only newly-exposed strips are re-sampled
        after the first fill.
        """
        stats = {"levels_moved": 0, "texels_streamed": 0}
        n = self.cfg.size
        for lvl in range(self.cfg.levels):
            sp = self.spacing(lvl)
            # snap center to even texels of this level
            cx = round(x / sp) * sp
            cz = round(z / sp) * sp
            if not self._centered or lvl >= len(self.levels):
                x0 = cx - (n - 1) / 2 * sp
                z0 = cz - (n - 1) / 2 * sp
                data = np.asarray(self.source(x0, z0, sp, n), np.float32)
                if data.shape != (n, n):
                    raise ValueError("source returned wrong window shape")
                if lvl >= len(self.levels):
                    self.levels.append(data)
                    self.centers.append((cx, cz))
                else:
                    self.levels[lvl] = data
                    self.centers[lvl] = (cx, cz)
                stats["levels_moved"] += 1
                stats["texels_streamed"] += n * n
                self.update_counts[lvl] += 1
                continue
            ocx, ocz = self.centers[lvl]
            dx_t = int(round((cx - ocx) / sp))
            dz_t = int(round((cz - ocz) / sp))
            if dx_t == 0 and dz_t == 0:
                continue
            if abs(dx_t) >= n or abs(dz_t) >= n:
                x0 = cx - (n - 1) / 2 * sp
                z0 = cz - (n - 1) / 2 * sp
                self.levels[lvl] = np.asarray(
                    self.source(x0, z0, sp, n), np.float32)
                stats["texels_streamed"] += n * n
            else:
                # shift and fill only the exposed strips
                data = np.roll(self.levels[lvl], (-dz_t, -dx_t), (0, 1))
                x0 = cx - (n - 1) / 2 * sp
                z0 = cz - (n - 1) / 2 * sp
                if dx_t > 0:
                    cols = np.arange(n - dx_t, n)
                elif dx_t < 0:
                    cols = np.arange(0, -dx_t)
                else:
                    cols = np.empty(0, int)
                if len(cols):
                    win = np.asarray(self.source(
                        x0 + cols[0] * sp, z0, sp, n), np.float32)
                    data[:, cols] = win[:, : len(cols)]
                    stats["texels_streamed"] += n * len(cols)
                if dz_t > 0:
                    rows = np.arange(n - dz_t, n)
                elif dz_t < 0:
                    rows = np.arange(0, -dz_t)
                else:
                    rows = np.empty(0, int)
                if len(rows):
                    win = np.asarray(self.source(
                        x0, z0 + rows[0] * sp, sp, n), np.float32)
                    data[rows, :] = win[: len(rows), :]
                    stats["texels_streamed"] += n * len(rows)
                self.levels[lvl] = data
            self.centers[lvl] = (cx, cz)
            stats["levels_moved"] += 1
            self.update_counts[lvl] += 1
        self._centered = True
        self.texels_streamed += stats["texels_streamed"]
        return stats

    def sample(self, x, z) -> np.ndarray:
        """Height at world (x, z) from the finest level containing it
        (bilinear); vectorized."""
        if not self._centered:
            raise RuntimeError("call center_on() first")
        x = np.asarray(x, np.float64)
        z = np.asarray(z, np.float64)
        out = np.full(np.broadcast(x, z).shape, np.nan)
        filled = np.zeros_like(out, bool)
        n = self.cfg.size
        for lvl in range(self.cfg.levels):
            sp = self.spacing(lvl)
            cx, cz = self.centers[lvl]
            u = (x - (cx - (n - 1) / 2 * sp)) / sp
            v = (z - (cz - (n - 1) / 2 * sp)) / sp
            ok = (~filled) & (u >= 0) & (u <= n - 1) & (v >= 0) & (v <= n - 1)
            if not ok.any():
                continue
            u0 = np.clip(np.floor(u).astype(int), 0, n - 2)
            v0 = np.clip(np.floor(v).astype(int), 0, n - 2)
            fu = np.clip(u - u0, 0, 1)
            fv = np.clip(v - v0, 0, 1)
            lv = self.levels[lvl]
            val = (lv[v0, u0] * (1 - fv) * (1 - fu)
                   + lv[v0, u0 + 1] * (1 - fv) * fu
                   + lv[v0 + 1, u0] * fv * (1 - fu)
                   + lv[v0 + 1, u0 + 1] * fv * fu)
            out = np.where(ok, val, out)
            filled |= ok
        return out

    def active_level_at(self, x: float, z: float) -> int:
        """Finest level whose ring contains (x, z); -1 when outside all."""
        n = self.cfg.size
        for lvl in range(self.cfg.levels):
            cx, cz = self.centers[lvl]
            half = self.extent(lvl)
            if abs(x - cx) <= half and abs(z - cz) <= half:
                return lvl
        return -1

    def stats(self) -> dict:
        return {
            "levels": self.cfg.levels,
            "size": self.cfg.size,
            "texels_streamed": self.texels_streamed,
            "update_counts": list(self.update_counts),
            "memory_bytes": sum(lv.nbytes for lv in self.levels),
        }
