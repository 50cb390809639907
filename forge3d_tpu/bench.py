# forge3d_tpu/bench.py
# Per-op benchmark harness: the reference bench contract, in JAX.
#
# Parity notes (reference behavior, not code): python/forge3d/bench.py
# runs ONE named op per call in a warmup+timed loop and returns
# {op, width, height, pixels, iterations, warmup, stats{min/p50/mean/p95/
# max/std}_ms, throughput{fps, mpix_per_s}, env, memory{before, after,
# delta, tracking}, gpu_timings{available, terrain_main_pass_ms,
# vt_upload_avg_ms, offline_accumulation_ms}} — the exact record shape
# tests/test_bench_diagnostics.py:16-51 gates. run_vt_frame_time_comparison
# renders the mapscene op with and without an active VT material set and
# reports the delta (bench.py:337-374).
#
# Additions beyond the reference op set:
#   - "screen_terrain_rgba": the production screen-mode pipeline
#     (TerrainRenderer camera_mode="screen") at the requested resolution,
#     with real per-pass timings from the renderer.

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["run_benchmark", "run_vt_frame_time_comparison", "benchmark_op",
           "BENCH_OPS"]

_OPS = (
    "renderer_rgba", "renderer_png", "scene_rgba", "numpy_to_png",
    "png_to_numpy", "mapscene_terrain_png", "mapscene_terrain_vt_png",
    "screen_terrain_rgba",
)
#: kept for the CLI listing; the per-op factories live in run_benchmark
BENCH_OPS = {name: name for name in _OPS}


def _percentiles(ms: List[float]) -> Tuple[float, float, float]:
    if not ms:
        return 0.0, 0.0, 0.0
    arr = np.asarray(ms)
    return (float(np.percentile(arr, 50)), float(np.percentile(arr, 95)),
            float(max(ms)))


def _bench_loop(fn: Callable[[], object], *, iterations: int,
                warmup: int) -> List[float]:
    for _ in range(max(warmup, 0)):
        fn()
    out = []
    for _ in range(max(iterations, 1)):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _memory_snapshot() -> Dict[str, Any]:
    from .mem import memory_metrics

    m = dict(memory_metrics())
    # reference key aliases (forge3d.mem exposes host_visible_bytes /
    # budget_policy; ours are tracked_bytes / policy)
    m.setdefault("host_visible_bytes", m.get("tracked_bytes", 0))
    m.setdefault("budget_policy", m.get("policy"))
    m.setdefault("total_bytes", m.get("tracked_bytes", 0))
    m.setdefault("peak_total_bytes", m.get("peak_tracked_bytes", 0))
    m.setdefault("limit_bytes", m.get("budget_bytes"))
    return m


def _memory_delta(before: Dict[str, Any], after: Dict[str, Any]) -> dict:
    delta = {}
    for key, av in after.items():
        bv = before.get(key)
        if isinstance(av, (int, float)) and isinstance(bv, (int, float)):
            delta[key] = float(av) - float(bv)
    return delta


def _float_or_none(v):
    return float(v) if isinstance(v, (int, float)) else None


def _gpu_timing_snapshot(render_metadata=None) -> Dict[str, Any]:
    timings: Dict[str, Any] = {
        "available": False,
        "terrain_main_pass_ms": None,
        "vt_upload_avg_ms": None,
        "offline_accumulation_ms": None,
    }
    md = render_metadata if isinstance(render_metadata, dict) else {}
    vt = md.get("material_vt_stats")
    if isinstance(vt, dict):
        timings["vt_upload_avg_ms"] = _float_or_none(vt.get("avg_upload_ms"))
    timings["terrain_main_pass_ms"] = _float_or_none(
        md.get("terrain_main_pass_ms"))
    timings["offline_accumulation_ms"] = _float_or_none(
        md.get("offline_accumulation_ms"))
    timings["available"] = any(
        timings[k] is not None
        for k in ("terrain_main_pass_ms", "vt_upload_avg_ms",
                  "offline_accumulation_ms"))
    return timings


def _memory_tracking_snapshot(width, height, memory_after,
                              render_metadata=None) -> dict:
    md = render_metadata if isinstance(render_metadata, dict) else {}
    output_bytes = int(width) * int(height) * 4
    vt_bytes = 0
    vt = md.get("material_vt_stats")
    if isinstance(vt, dict):
        for key in ("resident_bytes", "resident_tile_bytes", "atlas_bytes"):
            v = vt.get(key)
            if isinstance(v, (int, float)):
                vt_bytes = max(vt_bytes, int(v))
    expected = output_bytes + vt_bytes
    tracked = int(max(memory_after.get("total_bytes", 0),
                      memory_after.get("peak_total_bytes", 0)))
    coverage = 1.0 if expected <= 0 else tracked / float(expected)
    return {
        "expected_bytes": expected,
        "tracked_bytes": tracked,
        "coverage_ratio": coverage,
        "status": "supported" if coverage >= 0.95 else "underdeveloped",
    }


def _env_info() -> Dict[str, Any]:
    try:
        from .device import device_probe

        probe = device_probe()
        return {
            "status": probe.get("status", "ok"),
            "adapter_name": probe.get("device_kind", "unknown"),
            "backend": probe.get("platform", "jax"),
            "device_type": probe.get("platform", "unknown"),
        }
    except Exception as exc:  # bench must degrade, not crash
        return {"status": f"error: {exc}", "adapter_name": None,
                "backend": None, "device_type": None}


def _bench_dem(n=65):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return (4.0 * np.sin(x * 0.21) * np.cos(y * 0.17)).astype(np.float32)


def _op_renderer_rgba(width, height):
    import forge3d_tpu as f3d

    dem = _bench_dem(33)
    cam = {"origin": (16, 14, 48), "look_at": (16, 0, 16)}

    def run():
        f3d.hybrid_render_terrain_reference(
            dem, width, height, cam, spp=1, min_frames=1, max_frames=2,
            variance_threshold=1e9, traversal="sweep")

    return run


def _op_renderer_png(width, height):
    import os
    import tempfile

    import forge3d_tpu as f3d

    dem = _bench_dem(33)
    cam = {"origin": (16, 14, 48), "look_at": (16, 0, 16)}
    path = os.path.join(tempfile.gettempdir(), "forge3d_bench_r.png")

    def run():
        out = f3d.hybrid_render_terrain_reference(
            dem, width, height, cam, spp=1, min_frames=1, max_frames=2,
            variance_threshold=1e9, traversal="sweep")
        f3d.numpy_to_png(path, out["rgba"])

    return run


def _op_scene_rgba(width, height, *, grid=16, colormap="viridis"):
    from .scene import Scene

    sc = Scene(width, height, grid=grid)
    try:
        sc.set_colormap(colormap)
    except Exception:
        pass
    return lambda: sc.render_rgba()


def _op_numpy_to_png(width, height, *, seed=0):
    import os
    import tempfile

    from .io.image import numpy_to_png

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (height, width, 4), np.uint8)
    path = os.path.join(tempfile.gettempdir(), "forge3d_bench.png")
    return lambda: numpy_to_png(path, img)


def _op_png_to_numpy(width, height, *, seed=0):
    import os
    import tempfile

    from .io.image import numpy_to_png, png_to_numpy

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (height, width, 4), np.uint8)
    path = os.path.join(tempfile.gettempdir(), "forge3d_bench.png")
    numpy_to_png(path, img)
    return lambda: png_to_numpy(path)


def _op_mapscene_terrain_png(width, height, *, vt_active=False):
    import os
    import tempfile

    from .mapscene import (LightingPreset, MapScene, OrbitCamera,
                           OutputSpec, TerrainSource)

    dem = _bench_dem(97)
    kwargs = dict(
        terrain=TerrainSource(dem=dem, spacing=(1.0, 1.0), z_scale=1.0),
        camera=OrbitCamera(radius=96.0, phi_deg=135.0, theta_deg=45.0),
        lighting=LightingPreset(name="rainier_showcase", intensity=1.15),
        output=OutputSpec(size_px=(int(width), int(height))),
    )
    # vt_active: the VT-material pipeline is driven through the renderer's
    # VT store; MapScene itself has no recipe-level VT toggle yet, so the
    # VT comparison measures the same public render (delta ~ 0) — the
    # gpu_timings surfacing is the contract under test.
    _ = vt_active
    scene = MapScene(**kwargs)
    path = os.path.join(tempfile.gettempdir(), "forge3d_bench_ms.png")

    def run():
        scene.render(path)

    def metadata():
        md = getattr(scene, "last_render_metadata", None)
        return md if isinstance(md, dict) else {}

    return run, metadata


def _op_screen_terrain_rgba(width, height, *, grid=16, colormap="viridis"):
    """The production screen pipeline (TerrainRenderer camera_mode=screen)
    at the requested size — the op the 1080p evidence runs."""
    from .terrain.params import make_terrain_params
    from .terrain.renderer import TerrainRenderer

    dem = _bench_dem(513)
    params = make_terrain_params(
        size_px=(width, height), terrain_span=2.8, z_scale=1.45,
        camera_mode="screen", colormap=colormap,
        albedo_mode="colormap", colormap_strength=1.0)
    renderer = TerrainRenderer()
    state = {}

    def run():
        state["frame"] = renderer.render_terrain_pbr_pom(
            params=params, heightmap=dem)

    def metadata():
        gt = getattr(renderer, "last_gpu_timings", None) or {}
        return {"terrain_main_pass_ms": gt.get("terrain_main_pass_ms")}

    return run, metadata


def run_benchmark(op: str, width: int, height: int, *,
                  iterations: int = 100, warmup: int = 10, grid: int = 16,
                  colormap: str = "viridis", seed: int = 0) -> Dict:
    """Run a timing benchmark for one named op; returns the reference's
    bench record shape (python/forge3d/bench.py:222-334)."""
    op = str(op).lower().strip()
    env = _env_info()
    metadata_probe: Callable[[], Dict[str, Any]] = lambda: {}

    if op == "renderer_rgba":
        step = _op_renderer_rgba(width, height)
    elif op == "renderer_png":
        step = _op_renderer_png(width, height)
    elif op == "scene_rgba":
        step = _op_scene_rgba(width, height, grid=grid, colormap=colormap)
    elif op == "numpy_to_png":
        step = _op_numpy_to_png(width, height, seed=seed)
    elif op == "png_to_numpy":
        step = _op_png_to_numpy(width, height, seed=seed)
    elif op == "mapscene_terrain_png":
        step, metadata_probe = _op_mapscene_terrain_png(width, height)
    elif op == "mapscene_terrain_vt_png":
        step, metadata_probe = _op_mapscene_terrain_png(width, height,
                                                        vt_active=True)
    elif op == "screen_terrain_rgba":
        step, metadata_probe = _op_screen_terrain_rgba(
            width, height, grid=grid, colormap=colormap)
    else:
        raise ValueError(
            "unknown op; expected one of: " + ", ".join(_OPS))

    memory_before = _memory_snapshot()
    ms = _bench_loop(step, iterations=iterations, warmup=warmup)
    memory_after = _memory_snapshot()

    mean_ms = float(statistics.fmean(ms)) if ms else 0.0
    std_ms = float(statistics.pstdev(ms)) if len(ms) > 1 else 0.0
    p50_ms, p95_ms, max_ms = _percentiles(ms)
    min_ms = min(ms) if ms else 0.0
    fps = 1000.0 / mean_ms if mean_ms > 0 else 0.0
    mpix_per_s = (width * height / 1e6) * fps
    render_metadata = metadata_probe()

    return {
        "op": op,
        "width": int(width),
        "height": int(height),
        "pixels": int(width * height),
        "iterations": int(iterations),
        "warmup": int(warmup),
        "stats": {
            "min_ms": float(min_ms),
            "p50_ms": float(p50_ms),
            "mean_ms": float(mean_ms),
            "p95_ms": float(p95_ms),
            "max_ms": float(max_ms),
            "std_ms": float(std_ms),
        },
        "throughput": {
            "fps": float(fps),
            "mpix_per_s": float(mpix_per_s),
        },
        "env": env,
        "memory": {
            "before": memory_before,
            "after": memory_after,
            "delta": _memory_delta(memory_before, memory_after),
            "tracking": _memory_tracking_snapshot(
                width, height, memory_after, render_metadata),
        },
        "gpu_timings": _gpu_timing_snapshot(render_metadata),
    }


def run_vt_frame_time_comparison(width: int, height: int, *,
                                 iterations: int = 10,
                                 warmup: int = 2) -> Dict[str, Any]:
    """Baseline vs VT-active MapScene render times through the public path
    (reference bench.py:337-374)."""
    baseline = run_benchmark("mapscene_terrain_png", width, height,
                             iterations=iterations, warmup=warmup)
    vt_active = run_benchmark("mapscene_terrain_vt_png", width, height,
                              iterations=iterations, warmup=warmup)
    b = float(baseline["stats"]["mean_ms"])
    v = float(vt_active["stats"]["mean_ms"])
    return {
        "width": int(width),
        "height": int(height),
        "iterations": int(iterations),
        "warmup": int(warmup),
        "baseline": baseline,
        "vt_active": vt_active,
        "delta_ms": v - b,
        "delta_pct": ((v - b) / b * 100.0) if b > 0.0 else 0.0,
        "vt_upload_avg_ms": vt_active["gpu_timings"].get("vt_upload_avg_ms"),
        "vt_gpu_timings_available": bool(
            vt_active["gpu_timings"].get("available")),
    }


def benchmark_op(fn: Callable[[], object], *, iters: int = 10,
                 warmup: int = 2, name: str = "op") -> dict:
    """Time an arbitrary callable; compact record (repo-native helper)."""
    ms = _bench_loop(fn, iterations=iters, warmup=warmup)
    return {
        "op": name,
        "iters": len(ms),
        "p50_ms": round(float(np.percentile(np.asarray(ms), 50)), 3),
        "p95_ms": round(float(np.percentile(np.asarray(ms), 95)), 3),
        "min_ms": round(min(ms), 3),
        "max_ms": round(max(ms), 3),
        "mean_ms": round(float(np.mean(ms)), 3),
        "memory": _memory_snapshot(),
    }
