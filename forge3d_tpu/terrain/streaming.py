# forge3d_tpu/terrain/streaming.py — asynchronous height-tile streaming.
#
# Parity notes (reference behavior, not code): the reference streams
# height tiles off-thread into the page table / clipmap
# (src/terrain/page_table/height_loader.rs:36-222, terrain/stream/):
# tiles are requested around the camera with a prefetch horizon, loaded
# on a worker pool, kept in an LRU byte budget, and assembled into
# mosaics for upload. Equivalent here: a ThreadPoolExecutor tile
# loader over any `(tile_x, tile_z, lod) -> (n, n) float32` source
# (GeoTIFF windows, COG ranges, procedural), an LRU cache charged
# against the memory ledger, and a windowed mosaic sampler that plugs
# directly into Clipmap's `source(x0, z0, step, n)` contract.

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["HeightTileLoader", "TileStats", "geotiff_tile_source"]

TileKey = Tuple[int, int, int]      # (tile_x, tile_z, lod)


@dataclass
class TileStats:
    requested: int = 0
    loaded: int = 0
    hits: int = 0
    misses: int = 0
    evicted: int = 0
    inflight: int = 0
    resident_bytes: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class HeightTileLoader:
    """Async tile loader + LRU residency + mosaic sampling.

    `tile_source(tx, tz, lod)` returns the (tile_px, tile_px) float32
    height tile covering world
    [tx*tile_px*spacing*2^lod, (tx+1)*tile_px*spacing*2^lod) x (same in
    z). Missing tiles may raise; they resolve to `fill_value` and are
    retried on the next request.
    """

    def __init__(self, tile_source: Callable[[int, int, int], np.ndarray],
                 *, tile_px: int = 256, spacing: float = 1.0,
                 budget_bytes: int = 64 << 20, workers: int = 4,
                 fill_value: float = 0.0,
                 track_label: str = "terrain-stream.tiles"):
        self.tile_source = tile_source
        self.tile_px = int(tile_px)
        self.spacing = float(spacing)
        self.budget_bytes = int(budget_bytes)
        self.fill_value = float(fill_value)
        self._pool = ThreadPoolExecutor(max_workers=int(workers),
                                        thread_name_prefix="height-tile")
        self._lock = threading.Lock()
        self._cache: "OrderedDict[TileKey, np.ndarray]" = OrderedDict()
        self._inflight: Dict[TileKey, Future] = {}
        self.stats = TileStats()
        self._track_label = track_label
        self._rid = None
        try:
            from ..mem import global_tracker

            self._tracker = global_tracker()
        except Exception:
            self._tracker = None

    # -- residency ---------------------------------------------------------

    def _charge(self) -> None:
        if self._tracker is None:
            return
        if self._rid is not None:
            self._tracker.free(self._rid)
        self._rid = self._tracker.track(self._track_label,
                                        max(self.stats.resident_bytes, 1),
                                        "buffer")

    def _insert(self, key: TileKey, tile: np.ndarray) -> None:
        with self._lock:
            self._cache[key] = tile
            self._cache.move_to_end(key)
            self.stats.loaded += 1
            self.stats.resident_bytes += tile.nbytes
            while self.stats.resident_bytes > self.budget_bytes \
                    and len(self._cache) > 1:
                _, old = self._cache.popitem(last=False)
                self.stats.resident_bytes -= old.nbytes
                self.stats.evicted += 1
        self._charge()

    def _load(self, key: TileKey) -> Optional[np.ndarray]:
        """Returns the tile, or None on source failure (the caller resolves
        the request with a fill tile WITHOUT caching it, so the tile is
        retried on the next request)."""
        tx, tz, lod = key
        try:
            tile = np.asarray(self.tile_source(tx, tz, lod), np.float32)
            if tile.shape != (self.tile_px, self.tile_px):
                raise ValueError(
                    f"tile source returned {tile.shape}, expected "
                    f"({self.tile_px}, {self.tile_px})")
        except Exception:
            return None
        return tile

    def request(self, key: TileKey) -> "Future[np.ndarray]":
        """Async-request one tile (idempotent while in flight)."""
        with self._lock:
            self.stats.requested += 1
            if key in self._cache:
                self.stats.hits += 1
                self._cache.move_to_end(key)
                fut: Future = Future()
                fut.set_result(self._cache[key])
                return fut
            self.stats.misses += 1
            if key in self._inflight:
                return self._inflight[key]
            self.stats.inflight += 1

            def work(k=key):
                tile = self._load(k)
                if tile is None:
                    tile = np.full((self.tile_px, self.tile_px),
                                   self.fill_value, np.float32)
                else:
                    self._insert(k, tile)
                with self._lock:
                    self._inflight.pop(k, None)
                    self.stats.inflight -= 1
                return tile

            fut = self._pool.submit(work)
            self._inflight[key] = fut
            return fut

    def prefetch_around(self, x: float, z: float, *, radius_tiles: int = 1,
                        lod: int = 0) -> int:
        """Queue the (2r+1)^2 tile neighborhood of a world position (the
        prefetch-horizon seam); returns the number of queued tiles."""
        world_tile = self.tile_px * self.spacing * (1 << lod)
        tx0 = int(np.floor(x / world_tile))
        tz0 = int(np.floor(z / world_tile))
        n = 0
        for dz in range(-radius_tiles, radius_tiles + 1):
            for dx in range(-radius_tiles, radius_tiles + 1):
                self.request((tx0 + dx, tz0 + dz, lod))
                n += 1
        return n

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until all in-flight tiles resolve."""
        while True:
            with self._lock:
                futs = list(self._inflight.values())
            if not futs:
                return
            for f in futs:
                f.result(timeout=timeout)

    # -- mosaic sampling (Clipmap source contract) --------------------------

    def window(self, x0: float, z0: float, step: float,
               n: int) -> np.ndarray:
        """(n, n) height window at world origin (x0, z0) with sample
        spacing `step` — synchronous (loads any missing tiles), so it
        plugs into `Clipmap(source=loader.window, ...)` directly."""
        lod = max(int(np.round(np.log2(max(step / self.spacing, 1.0)))), 0)
        world_tile = self.tile_px * self.spacing * (1 << lod)
        xs = x0 + np.arange(n) * step
        zs = z0 + np.arange(n) * step
        txs = np.floor(xs / world_tile).astype(int)
        tzs = np.floor(zs / world_tile).astype(int)
        out = np.empty((n, n), np.float32)
        # group samples by tile, fetch each tile once
        for tz in np.unique(tzs):
            rowsel = tzs == tz
            for tx in np.unique(txs):
                colsel = txs == tx
                tile = self.request((int(tx), int(tz), lod)).result()
                lx = ((xs[colsel] - tx * world_tile)
                      / (self.spacing * (1 << lod)))
                lz = ((zs[rowsel] - tz * world_tile)
                      / (self.spacing * (1 << lod)))
                ix = np.clip(lx.astype(int), 0, self.tile_px - 1)
                iz = np.clip(lz.astype(int), 0, self.tile_px - 1)
                out[np.ix_(rowsel, colsel)] = tile[np.ix_(iz, ix)]
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._tracker is not None and self._rid is not None:
            self._tracker.free(self._rid)
            self._rid = None


def geotiff_tile_source(path, *, tile_px: int = 256,
                        band: int = 0) -> Callable[[int, int, int],
                                                   np.ndarray]:
    """Tile source over a GeoTIFF via windowed reads (gis.geotiff);
    LOD l reads a 2^l-strided window. Out-of-bounds regions fill with
    the dataset edge."""
    from ..gis.geotiff import raster_info, read_raster

    info = raster_info(path)
    full_w, full_h = int(info.width), int(info.height)

    def source(tx: int, tz: int, lod: int) -> np.ndarray:
        stride = 1 << int(lod)
        size = tile_px * stride
        x0, z0 = tx * size, tz * size
        cw = max(min(full_w - x0, size), 0)
        ch = max(min(full_h - z0, size), 0)
        out = np.zeros((size, size), np.float32)
        if cw > 0 and ch > 0 and x0 >= 0 and z0 >= 0:
            win = read_raster(path, window=(x0, z0, cw, ch), band=band)
            out[:ch, :cw] = np.asarray(win, np.float32)[..., 0] \
                if np.asarray(win).ndim == 3 else np.asarray(win,
                                                             np.float32)
            # edge-extend the dataset boundary
            if cw < size:
                out[:ch, cw:] = out[:ch, cw - 1:cw]
            if ch < size:
                out[ch:, :] = out[ch - 1:ch, :]
        return out[::stride, ::stride]

    return source
