#!/usr/bin/env python
"""Time the sweep renderer's alternative forms on a GPU at the flagship job
(bench.flagship_job: 1920x1080 over a seeded 1025^2 DEM).

    python scripts/sweep_variants.py [--only NAME ...]

NAME is one of: lookups, per_ray, unroll, batch. Every line
names the card and its power limit. Times are medians of warm calls that
end in block_until_ready; "first" is the first call (compile included).
Refuses to run without a GPU.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import card_name_and_power_limit, flagship_job  # noqa: E402

CARD = None
N_FRAMES = 4          # frames vmapped per batch, as in the pipeline


def log(msg):
    print(f"[{CARD}] {msg}", flush=True)


def timeit(fn, *args, n=5):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), ts


def _plan(job):
    from forge3d_tpu.pt import terrain_sweep as ts

    dem, W, H, cam = job
    return ts._build_pipeline(
        dem.shape, (1.0, 1.0), 1.0, tuple(cam["origin"]),
        tuple(cam["look_at"]), (0.0, 1.0, 0.0), float(cam["fov_y"]), W, H,
        32, 12, -0.55, 315.0, 45.0, True, None)[:2]


def _jitters(n):
    xi = jnp.linspace(0.05, 0.95, n)
    ja = jnp.linspace(-0.45, 0.45, n)
    return xi, ja


def measure_lookups(job):
    """2-tap gather + lerp against the dense hat-weight product at
    Precision.HIGHEST, for the profile extraction and the screen warp."""
    from _polar_hat_reference import extract_profiles_hat, warp_to_screen_hat
    from forge3d_tpu.ops import polarscan as pol

    dem, W, H, cam = job
    rg, ps = _plan(job)
    key = jax.random.PRNGKey(0)
    rotbuf = jax.random.uniform(key, (rg.n_v, rg.n_u, 5)) * 50.0
    xi, ja = _jitters(N_FRAMES)
    for name, fn in (("gather", pol.extract_profiles),
                     ("hat-HIGHEST", extract_profiles_hat)):
        f = jax.jit(jax.vmap(lambda x, a, fn=fn: fn(rotbuf, ps, xi=x, ja=a)))
        first, med, _ = timeit(f, xi, ja)
        log(f"extract_profiles {name:<12} x{N_FRAMES} frames: median "
            f"{med * 1e3:.3f} ms (first {first:.2f} s) shapes "
            f"rotbuf={rotbuf.shape} K={ps.k_count} A={ps.a_count}")
    polar = jax.random.uniform(key, (ps.e_count, ps.a_count, 8))
    for name, fn in (("gather", pol.warp_to_screen),
                     ("hat-HIGHEST", warp_to_screen_hat)):
        f = jax.jit(lambda p, fn=fn: (
            fn(p[..., :3], ps, width=W, height=H, supersample=2),
            fn(p[..., 3:8], ps, width=W, height=H, supersample=1)))
        first, med, _ = timeit(f, polar)
        log(f"warp_to_screen   {name:<12} beauty+aov: median "
            f"{med * 1e3:.3f} ms (first {first:.2f} s) polar={polar.shape}")


def measure_per_ray(job):
    """The per-ray DDA engine (the sweep's reference) on the job's
    1920x1080 primary rays, and a 2-frame per-ray render."""
    from forge3d_tpu.ops.pyramid import build_pyramid
    from forge3d_tpu.ops.traversal import scene_from_pyramid, trace
    from forge3d_tpu.pt.terrain_ref import TerrainRefDesc, _camera_rays

    dem, W, H, cam = job
    desc = TerrainRefDesc(heights=dem, cam_origin=cam["origin"],
                          cam_look_at=cam["look_at"], fov_y_deg=cam["fov_y"],
                          width=W, height=H)
    scene, static = scene_from_pyramid(build_pyramid(dem))
    z = jnp.zeros((H, W), jnp.float32)
    rd = _camera_rays(desc, z, z)
    ro = tuple(jnp.full((H, W), c, jnp.float32) for c in cam["origin"])
    f_dda = jax.jit(lambda s, o, d: trace(s, static, o, d).t)
    first, med, _ = timeit(f_dda, scene, ro, rd)
    log(f"primary rays {W}x{H} dda: median {med * 1e3:.3f} ms (first "
        f"{first:.2f} s) = {W * H / med / 1e6:.1f} Mrays/s")
    import forge3d_tpu as f3d

    kw = dict(spp=1, min_frames=2, max_frames=2, variance_threshold=1e9,
              seed=7, traversal="dda")
    t0 = time.perf_counter()
    f3d.hybrid_render_terrain_reference(dem, W, H, cam, **kw)
    first = time.perf_counter() - t0
    ts_ = []
    for _ in range(2):
        t0 = time.perf_counter()
        f3d.hybrid_render_terrain_reference(dem, W, H, cam, **kw)
        ts_.append(time.perf_counter() - t0)
    log(f"per-ray render {W}x{H} traversal=dda, 2 frames x 1 spp (restir "
        f"on): median {np.median(ts_):.3f} s (first {first:.2f} s)")


def _sweep_inputs(job):
    from forge3d_tpu.ops import sweep as sw

    dem, W, H, cam = job
    rg, ps = _plan(job)
    h, _v, du, dv = jax.jit(lambda d: sw.rotate_heights(
        d, rg, origin_xz=(0.0, 0.0), spacing_xz=(1.0, 1.0),
        cam_xz=(cam["origin"][0], cam["origin"][2]), exaggeration=1.0,
        with_derivatives=True))(jnp.asarray(dem))
    return rg, ps, h, du, dv


def measure_unroll(job):
    """Propagation scan unroll factor, sweep_lighting x N_FRAMES vmapped."""
    from forge3d_tpu.ops import sweep as sw
    from forge3d_tpu.ops.shading import EnvMap, sun_direction

    rg, ps, h, du, dv = _sweep_inputs(job)
    strata = sw.make_strata(32, 12, -0.55)
    sun_w = tuple(float(np.asarray(v)) for v in sun_direction(315.0, 45.0))
    keys = jax.random.split(jax.random.PRNGKey(2), N_FRAMES)
    saved = sw.SCAN_UNROLL
    try:
        for unroll in (1, 8, 16):
            sw.SCAN_UNROLL = unroll
            f = jax.jit(jax.vmap(lambda k: sw.sweep_lighting(
                h, du, dv, strata=strata, key=k,
                env=EnvMap(rgb=None, intensity=jnp.float32(0.35)),
                e_u=rg.e_u, e_v=rg.e_v, sun_world=sun_w,
                spacing=rg.spacing)))
            first, med, _ = timeit(f, keys)
            log(f"sweep_lighting unroll={unroll:<2} x{N_FRAMES} frames: "
                f"median {med * 1e3:.3f} ms (first {first:.2f} s) grid "
                f"{h.shape}")
    finally:
        sw.SCAN_UNROLL = saved


def measure_batch(job):
    """Frames vmapped per batch: warm converged render (8 frames) with the
    batch cap at 8, 4 and 2, plus the 8-cap again to gauge drift."""
    import forge3d_tpu as f3d
    from forge3d_tpu.pt import terrain_sweep as ts

    dem, W, H, cam = job
    saved = ts.BATCH_CAP
    try:
        for cap in (8, 4, 2, 8):
            ts.BATCH_CAP = cap
            ts._build_pipeline.cache_clear()
            t0 = time.perf_counter()
            f3d.hybrid_render_terrain_reference(
                dem, W, H, cam, spp=2, seed=7, traversal="sweep")["rgba"]
            first = time.perf_counter() - t0
            ts_ = []
            for s in range(3):
                t0 = time.perf_counter()
                f3d.hybrid_render_terrain_reference(
                    dem, W, H, cam, spp=2, seed=8 + s,
                    traversal="sweep")["rgba"]
                ts_.append(time.perf_counter() - t0)
            peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
            log(f"render 8 frames, batch cap {cap}: median "
                f"{np.median(ts_):.3f} s {['%.3f' % t for t in ts_]} (first "
                f"{first:.2f} s) peak bytes_in_use so far {peak}")
    finally:
        ts.BATCH_CAP = saved
        ts._build_pipeline.cache_clear()


MEASUREMENTS = {"lookups": measure_lookups, "per_ray": measure_per_ray,
                "unroll": measure_unroll, "batch": measure_batch}


def main():
    global CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=list(MEASUREMENTS),
                    choices=list(MEASUREMENTS))
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("sweep_variants.py needs a GPU")
    CARD = card_name_and_power_limit()
    job = flagship_job()
    for name in args.only:
        MEASUREMENTS[name](job)


if __name__ == "__main__":
    main()
