#!/usr/bin/env python
"""chip_smoke.py — the flagship render path, end to end on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py               # one card: all phases below
    python chip_smoke.py --four-cards  # frame-sharded render over 4 cards

Phases, in order, in one process (each must pass; any failure raises, the
script exits non-zero and does not print its last line):

  device     the default JAX device is a GPU; prints its kind and count,
             the card's name and power limit, the JAX version and the
             device memory limit.
  render     the flagship job (bench.flagship_job: 1920x1080 over a seeded
             1025^2 DEM) through hybrid_render_terrain_reference(...,
             traversal="sweep"), then hybrid_render_terrain_sequence with
             4 seeds; each sequence frame must be bit-identical to the
             single call with the same seed.
  reference  the same scene, and its smooth variant (no per-node noise),
             with the per-ray DDA engine (restir=False, the exact
             estimator the sweep computes), gated by SSIM and mean abs
             diff against the sweep output (REFERENCE_GATES).
  stages     each sweep stage at the job's shapes on the GPU against the
             same function on this process's CPU backend (full f32).
  screen     the MapScene/viewer screen pipeline (terrain_pbr, 1280x720)
             against its numpy oracle, within 1 u8 step.
  --four-cards  only: render_sweep_sharded over a flat 4-card mesh against
             the one-card render of the same frames, within 1 u8 step.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

import argparse
import json
import sys
import time

import numpy as np

#: Per-ray DDA reference: samples per pixel per frame and frames. 16 x 32
#: = 512 jittered samples per pixel, which holds its Monte Carlo noise
#: well under the 0.8/255 mean-abs-diff gate at this size.
REF_SPP = 16
REF_FRAMES = 32

#: Sweep-vs-DDA gates at the flagship size: (SSIM >, mean abs diff < in u8
#: steps). The repo's own converged gate (tests/test_sweep.py: 0.99, 0.8)
#: holds at 128x96 on a smooth DEM. At 1920x1080 an H100 measured (PERF.md):
REFERENCE_GATES = {
    # the flagship DEM's 2-sigma per-node noise casts shadows inside single
    # cells, which the sweep's node-pitch sun shadow heights do not
    # resolve: SSIM 0.763, mean abs diff 9.12 against a 256-spp reference.
    # The CPU backend shows the same gap at small size (0.880 / 6.26 at
    # 128x96 with 5% noise), so it is the estimator, not the card.
    "flagship": (0.72, 10.0),
    # the same job without the noise term: 0.9886 / 0.702 against the
    # 512-spp reference (0.9874 / 0.748 at 256 spp: part of the gap is the
    # reference's own noise). Above the DEM's front-edge band (the bottom
    # eighth of the frame) SSIM is 0.9934 and the repo's 0.99 gate holds;
    # the band itself reads 0.956.
    "smooth": (0.98, 0.8),
}
#: SSIM gate above the bottom eighth of the frame (the DEM's front edge).
SMOOTH_INTERIOR_SSIM_GATE = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(ok, msg) -> None:
    """Fail the phase unless `ok` (a plain raise: checks hold under -O)."""
    if not ok:
        raise SmokeFailure(msg)


def _keep_cpu_backend() -> None:
    """The stages phase compares against JAX's CPU backend in this same
    process; keep it available when JAX_PLATFORMS names only the GPU."""
    import jax

    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")


class _CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self._EVENTS:
            self.seconds += float(duration)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(n_cards: int):
    import jax

    from bench import card_name_and_power_limit

    devs = jax.devices()
    dev = devs[0]
    check(dev.platform == "gpu",
          f"no GPU: the default JAX device is {dev.platform!r}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, have {len(devs)}")
    card = card_name_and_power_limit()
    limit = dev.memory_stats()["bytes_limit"]
    log(f"device: kind={dev.device_kind} count={len(devs)} | nvidia-smi: "
        f"{card} | jax {jax.__version__} | bytes_limit={limit}")
    return dev, card


def phase_render(card, job, clock):
    import forge3d_tpu as f3d

    dem, W, H, cam = job
    dev = __import__("jax").devices()[0]

    def single(seed):
        out = f3d.hybrid_render_terrain_reference(
            dem, W, H, cam, spp=2, seed=seed, traversal="sweep")
        out["rgba"]
        return out

    c0 = clock.seconds
    t0 = time.perf_counter()
    first = single(7)
    t_first = time.perf_counter() - t0
    t_compile = clock.seconds - c0
    t0 = time.perf_counter()
    warm = single(7)
    t_warm = time.perf_counter() - t0
    check(np.array_equal(warm["rgba"], first["rgba"]),
          "two renders with one seed differ")

    seeds = [11, 12, 13, 14]
    t0 = time.perf_counter()
    seq = f3d.hybrid_render_terrain_sequence(dem, W, H, cam, seeds=seeds,
                                             spp=2)
    for out in seq:
        out["rgba"]
    t_seq = (time.perf_counter() - t0) / len(seeds)
    for seed, out in zip(seeds, seq):
        one = single(seed)
        for key in ("rgba", "hdr", "depth", "normal"):
            check(np.array_equal(out[key], one[key], equal_nan=True),
                  f"sequence frame seed={seed} differs from the single "
                  f"render in {key!r}")

    rgba = first["rgba"]
    check(rgba.shape == (H, W, 4) and rgba.dtype == np.uint8,
          f"rgba {rgba.shape} {rgba.dtype}")
    hit = np.isfinite(first["depth"]).mean()
    check(0.3 < hit < 1.0, f"terrain covers {hit:.3f} of the frame")
    peak = dev.memory_stats()["peak_bytes_in_use"]
    log(f"render [{card}]: {W}x{H} over {dem.shape[0]}^2 DEM, "
        f"{first['frames']} sweep frames | compile {t_compile:.3f} s | "
        f"first call {t_first:.3f} s (compile included) | warm single "
        f"render {t_warm:.3f} s | sequence {t_seq:.3f} s/render | peak "
        f"bytes_in_use {peak} | terrain coverage {hit:.4f} | "
        f"sequence frames bit-identical to single renders")
    return first


def phase_reference(card, job, smooth_job, sweep_out):
    import forge3d_tpu as f3d
    from forge3d_tpu.pt.terrain_ref import (TerrainRefDesc,
                                            render_terrain_reference)
    from forge3d_tpu.utils.metrics import ssim

    smooth = smooth_job
    smooth_out = f3d.hybrid_render_terrain_reference(
        smooth[0], smooth[1], smooth[2], smooth[3], spp=2, seed=7,
        traversal="sweep")
    for name, (dem, W, H, cam), sweep in (("flagship", job, sweep_out),
                                          ("smooth", smooth, smooth_out)):
        desc = TerrainRefDesc(
            heights=dem, cam_origin=cam["origin"],
            cam_look_at=cam["look_at"], fov_y_deg=cam["fov_y"], width=W,
            height=H, spp=REF_SPP, min_frames=REF_FRAMES,
            max_frames=REF_FRAMES, variance_threshold=1e9, restir=False,
            traversal="dda", seed=7)
        t0 = time.perf_counter()
        ref = render_terrain_reference(desc)
        t_ref = time.perf_counter() - t0
        a = ref["rgba"][..., :3].astype(np.float32) / 255
        b = sweep["rgba"][..., :3].astype(np.float32) / 255
        s = ssim(a, b)
        mad = float(np.abs(a - b).mean() * 255)
        bias = float((b - a).mean() * 255)
        band = H * 7 // 8
        s_top = ssim(a[:band], b[:band])
        s_bottom = ssim(a[band:], b[band:])
        ssim_gate, mad_gate = REFERENCE_GATES[name]
        log(f"reference {name} [{card}]: per-ray DDA "
            f"{REF_SPP * REF_FRAMES} spp in {t_ref:.3f} s | sweep vs DDA "
            f"SSIM {s:.5f} (gate > {ssim_gate}; rows above {band}: "
            f"{s_top:.5f}, below: {s_bottom:.5f}) | mean abs diff "
            f"{mad:.4f}/255 (gate < {mad_gate}) | sweep minus DDA mean "
            f"{bias:+.4f}/255")
        check(s > ssim_gate, f"{name}: sweep vs DDA SSIM {s}")
        check(mad < mad_gate, f"{name}: sweep vs DDA mean abs diff {mad}")
        if name == "smooth":
            check(s_top > SMOOTH_INTERIOR_SSIM_GATE,
                  f"smooth: SSIM above the front-edge band {s_top}")


# Stage tolerances, normwise: max |gpu - cpu| / max |cpu| and the same for
# the mean. Every stage runs in f32 with explicit precision on its
# products; a TF32 product (~10 mantissa bits, ~5e-4 relative) would put
# the mean of a contracting stage near 1e-4. The max gates are set by
# discrete near-ties that the last ulp of an input flips; each is named
# with what an H100 (700 W) measured against the CPU backend (PERF.md).
STAGE_TOLERANCES = {
    # bilinear resample + slopes: measured exact
    "rotate.h": (1e-5, 1e-6), "rotate.du": (1e-5, 1e-6),
    "rotate.dv": (1e-5, 1e-6),
    # the whole sky sweep: its bin directions come from sin/cos/sqrt, whose
    # GPU and CPU results differ in the last ulp, and the binary lit test
    # (h >= z_in) flips at near-ties on this rough DEM. Measured 4.1e-2 /
    # 2.5e-4; a 1-ulp nudge of the directions on the CPU alone gives
    # 4.0e-2 / 7.8e-4. The bin contraction itself is gated by
    # "lighting.bins" below, from host-made directions.
    "lighting.e_sky": (1e-1, 2e-3),
    # propagation + bin contraction from identical directions: the lit test
    # still flips where fused arithmetic rounds the shadow line otherwise
    # (measured 2.1e-2 / 4.2e-5; a 1-ulp nudge of tau and delta on the CPU
    # gives 1.7e-2 / 2.8e-4 with 3.4% of texels changed). TF32 operands
    # (emulated on the CPU) change 49% of texels by more than 1e-6 of the
    # scale, so this stage also gates that share (STAGE_SHARE_GATES).
    "lighting.bins": (5e-2, 1e-3),
    # z_sun is a running max of lerps: measured 1.0e-7 / 1.3e-13; its gate
    # (2e-5 of ~100 m = 2 mm) stays under the 1e-4*(range+1) shadow
    # epsilon the sun test uses
    "lighting.z_sun": (2e-5, 1e-6),
    # 2-tap gather + lerp: f32 column positions round in the last ulp,
    # times cell-scale slopes (mean measured 8e-11)
    "profiles": (1e-3, 1e-6),
    # first crossing at Precision.HIGHEST: where the running max is flat
    # the crossing fraction is a step in Q, so Q's last ulp can move a hit
    # by a row (measured 1.9e-3 / 6.5e-10)
    "crossing": (1e-2, 1e-6),
    # 2-tap gather + lerp + box filter: 1 ulp of the azimuth position is
    # 2.4e-4 of a column at A = 3328, times the jump at a silhouette
    # (measured 1.4e-4 / 6.1e-7 beauty, 2.4e-4 / 5.8e-9 AOVs)
    "warp.beauty": (1e-3, 2e-6), "warp.aov": (1e-3, 2e-6),
}

#: Largest share of elements that may differ by more than 1e-6 of the
#: scale, where a near-tie flip is local and a precision loss is global.
STAGE_SHARE_GATES = {"lighting.bins": 0.1}

#: Magnitude above which a value means "no terrain" (the -1e30 sentinel and
#: lerps onto it); real heights, depths and radiance stay far below.
_NO_TERRAIN = 1e9


def _compare(name, got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, (name, got.shape, want.shape))
    # -1e30 "no terrain" sentinels must agree exactly as a mask
    sent = np.abs(want) >= _NO_TERRAIN
    check(np.array_equal(sent, np.abs(got) >= _NO_TERRAIN),
          f"{name}: no-terrain masks differ")
    check(np.isfinite(got[~sent]).all(), f"{name}: non-finite output")
    diff = np.abs(got - want)[~sent]
    scale = max(float(np.abs(want[~sent]).max()), 1e-30)
    max_abs = float(diff.max())
    rel_max, rel_mean = max_abs / scale, float(diff.mean()) / scale
    share = float((diff > 1e-6 * scale).mean())
    tol_max, tol_mean = STAGE_TOLERANCES[name]
    tol_share = STAGE_SHARE_GATES.get(name, 1.0)
    return dict(name=name, max_abs=max_abs, rel_max=rel_max,
                rel_mean=rel_mean, share=share, tol_max=tol_max,
                tol_mean=tol_mean, tol_share=tol_share,
                ok=(rel_max <= tol_max and rel_mean <= tol_mean
                    and share <= tol_share))


def sweep_stage_checks(job, gpu, cpu):
    """Run each sweep stage on `gpu` and on `cpu` from the same inputs
    (the GPU's own output of the stage before) and compare. Returns one
    result dict per output."""
    import jax
    import jax.numpy as jnp

    from forge3d_tpu.ops import polarscan as pol
    from forge3d_tpu.ops import sweep as sw
    from forge3d_tpu.ops.shading import EnvMap, env_radiance, sun_direction
    from forge3d_tpu.pt import terrain_sweep as ts

    dem, W, H, cam = job
    up = (0.0, 1.0, 0.0)
    rg, ps = ts._build_pipeline(
        dem.shape, (1.0, 1.0), 1.0, tuple(cam["origin"]),
        tuple(cam["look_at"]), up, float(cam["fov_y"]), W, H, 32, 12, -0.55,
        315.0, 45.0, True, None)[:2]
    cam_xz = (float(cam["origin"][0]), float(cam["origin"][2]))
    strata = sw.make_strata(32, 12, -0.55)
    sun_w = tuple(float(np.asarray(v)) for v in sun_direction(315.0, 45.0))
    xi, ja, je = 0.37, -0.21, 0.13

    def env():
        return EnvMap(rgb=None, intensity=jnp.float32(0.35))

    @jax.jit
    def rotate(hgt):
        h, _valid, du, dv = sw.rotate_heights(
            hgt, rg, origin_xz=(0.0, 0.0), spacing_xz=(1.0, 1.0),
            cam_xz=cam_xz, exaggeration=1.0, with_derivatives=True)
        return h, du, dv

    @jax.jit
    def lighting(h, du, dv):
        m = sw.sweep_lighting(h, du, dv, strata=strata,
                              key=jax.random.PRNGKey(5), env=env(),
                              e_u=rg.e_u, e_v=rg.e_v, sun_world=sun_w,
                              spacing=rg.spacing)
        return m.e_sky, m.z_sun

    # the bin contraction alone, from directions made on the host: the same
    # inputs on both devices (one marching group, +v rows)
    rng = np.random.default_rng(11)
    n_bins = 96
    az = rng.uniform(-0.7, 0.7, n_bins)
    el = rng.uniform(-0.3, 0.9, n_bins)
    ce = np.sqrt(1.0 - el * el)
    w_u, w_v, w_y = np.sin(az) * ce, -np.cos(az) * ce, el
    l_row = -w_v
    bin_args = [np.asarray(v, np.float32) for v in (
        np.clip(-w_u / l_row, -1.0, 1.0), rg.spacing * w_y / l_row, w_u,
        w_v, w_y, rng.uniform(0.001, 0.01, (n_bins, 3)))]

    @jax.jit
    def bins(h, du, dv, tau, delta, wu, wv, wy, env_w):
        invn = jax.lax.rsqrt(1.0 + du * du + dv * dv)
        e, _ = sw._propagate_group(h, du, dv, invn, tau, delta, wu, wv, wy,
                                   env_w, emit_z0=False)
        return e

    @jax.jit
    def profiles(rotbuf):
        return pol.extract_profiles(rotbuf, ps, xi=xi, ja=ja)

    @jax.jit
    def crossing_inputs(prof):
        # shaded values with the magnitudes the frame body produces:
        # radiance (~1), hit distance (~1e3), unit normals, flags
        q, t_dist = pol.profile_hit_tangents(prof[..., 0], ps, xi=xi, ja=ja)
        s = jnp.tanh(q)
        n = jnp.stack([0.6 * s, jnp.sqrt(1.0 - 0.36 * s * s), 0.0 * s], -1)
        ones = jnp.ones_like(q)
        values = jnp.concatenate(
            [prof[..., 1:4], t_dist[..., None], n, ones[..., None],
             (q > 0).astype(jnp.float32)[..., None]], axis=-1)
        dx, dy, dz, _, _ = pol.polar_directions(ps, ja=ja, je=je)
        mr, mg, mb = env_radiance(env(), dx, dy, dz)
        z = jnp.zeros_like(mr)
        miss = jnp.stack([mr, mg, mb, z, z, z, z, z, z], axis=-1)
        return values, q, miss

    @jax.jit
    def crossing(values, q, miss):
        return pol.synthesize_polar(values, q, miss, ps, je=je)

    @jax.jit
    def warp(polar):
        return (pol.warp_to_screen(polar[..., :3], ps, width=W, height=H,
                                   supersample=2),
                pol.warp_to_screen(polar[..., 3:8], ps, width=W, height=H,
                                   supersample=1))

    def both(fn, *args):
        on_gpu = fn(*jax.device_put(args, gpu))
        on_cpu = fn(*jax.device_put(args, cpu))
        return jax.device_get(on_gpu), jax.device_get(on_cpu)

    results = []
    (h, du, dv), (hc, duc, dvc) = both(rotate, dem)
    results += [_compare("rotate.h", h, hc), _compare("rotate.du", du, duc),
                _compare("rotate.dv", dv, dvc)]
    (e_sky, z_sun), (e_skyc, z_sunc) = both(lighting, h, du, dv)
    e_bins, e_binsc = both(bins, h, du, dv, *bin_args)
    results += [_compare("lighting.e_sky", e_sky, e_skyc),
                _compare("lighting.bins", e_bins, e_binsc),
                _compare("lighting.z_sun", z_sun, z_sunc)]
    rotbuf = np.concatenate([h[..., None], e_sky, z_sun[..., None]], -1)
    prof, profc = both(profiles, rotbuf)
    results.append(_compare("profiles", prof, profc))
    values, q, miss = jax.device_get(
        crossing_inputs(jax.device_put(prof, gpu)))
    polar, polarc = both(crossing, values, q, miss)
    results.append(_compare("crossing", polar, polarc))
    (beauty, aov), (beautyc, aovc) = both(warp, polar)
    results += [_compare("warp.beauty", beauty, beautyc),
                _compare("warp.aov", aov, aovc)]
    return results


def phase_stages(card, job):
    import jax

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    results = sweep_stage_checks(job, gpu, cpu)
    for r in results:
        log(f"stage {r['name']:<15} [{card}] GPU vs CPU f32: max abs "
            f"{r['max_abs']:.3e} | max rel {r['rel_max']:.3e} (tol "
            f"{r['tol_max']:.0e}) | mean rel {r['rel_mean']:.3e} (tol "
            f"{r['tol_mean']:.0e}) | share > 1e-6 {r['share']:.4f} (tol "
            f"{r['tol_share']:g}) | {'ok' if r['ok'] else 'FAIL'}")
    log(f"stages: {time.perf_counter() - t0:.1f} s")
    bad = [r["name"] for r in results if not r["ok"]]
    check(not bad, f"stages outside tolerance: {bad}")


def phase_screen(card, size_px=(1280, 720)):
    from forge3d_tpu.terrain import screen as eng
    from forge3d_tpu.terrain import screen_golden as sg

    kw = dict(sg.FAMILY_SCENES["terrain_pbr"])
    kw.pop("water_mask", None)
    kw.pop("render_scale", None)
    kw["size_px"] = size_px
    lut = eng.build_lut_from_stops(kw.pop("stops", sg.FAMILY_STOPS))
    kw.setdefault("hdr_rgb", eng.decode_test_hdr(blue=kw.pop("hdr_blue",
                                                             128)))
    hm = sg.family_heightmap()
    t0 = time.perf_counter()
    want = sg.render_screen_scene(hm, lut, water_mask=None, **kw)
    t_oracle = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = eng.render_screen_scene(hm, lut, water_mask=None, **kw)
    t_engine = time.perf_counter() - t0
    check(got.shape == want.shape == (size_px[1], size_px[0], 4),
          (got.shape, want.shape))
    d = np.abs(got[..., :3].astype(int) - want[..., :3].astype(int))
    log(f"screen [{card}]: terrain_pbr {size_px[0]}x{size_px[1]} engine "
        f"vs numpy oracle max {int(d.max())} u8 step(s) (gate <= 1), "
        f"{int((d > 0).sum())} channels differ | engine {t_engine:.3f} s "
        f"(compile included) | oracle {t_oracle:.3f} s")
    check(d.max() <= 1, f"screen engine deviates {d.max()} u8 steps")
    for mod in ("PIL", "fontTools"):
        check(mod not in sys.modules, f"the screen path imported {mod}")


def phase_four_cards(card, job):
    import jax

    from forge3d_tpu.parallel.mesh import frame_mesh
    from forge3d_tpu.parallel.sweep import render_sweep_sharded
    from forge3d_tpu.pt.terrain_ref import TerrainRefDesc
    from forge3d_tpu.pt.terrain_sweep import (_sweep_frames,
                                              render_terrain_sweep)

    dem, W, H, cam = job
    devs = jax.devices()[:4]
    desc = TerrainRefDesc(
        heights=dem, cam_origin=cam["origin"], cam_look_at=cam["look_at"],
        fov_y_deg=cam["fov_y"], width=W, height=H, spp=2, seed=7)
    n_frames = _sweep_frames(desc)
    mesh = frame_mesh(devs)      # flat 1-D axis: the cards are all-to-all

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        out["rgba"]
        return out, time.perf_counter() - t0

    sharded, t_sh_first = timed(
        lambda: render_sweep_sharded(desc, n_frames, mesh=mesh))
    sharded, t_sh = timed(
        lambda: render_sweep_sharded(desc, n_frames, mesh=mesh))
    single, t_one_first = timed(lambda: render_terrain_sweep(desc))
    single, t_one = timed(lambda: render_terrain_sweep(desc))
    check(sharded["frames"] == single["frames"] == n_frames,
          (sharded["frames"], single["frames"], n_frames))
    check(sharded["devices"] == 4, sharded["devices"])
    d = np.abs(sharded["rgba"][..., :3].astype(int)
               - single["rgba"][..., :3].astype(int))
    stats = [dv.memory_stats() for dv in devs]
    log(f"four cards [{card}]: {n_frames} frames, "
        f"{sharded['frames_per_device']} per card | sharded vs one card "
        f"max {int(d.max())} u8 step(s) (gate <= 1), "
        f"{int((d > 0).sum())} channels differ | warm sharded "
        f"{t_sh:.3f} s, warm one card {t_one:.3f} s | first calls "
        f"{t_sh_first:.3f} s / {t_one_first:.3f} s (compile included)")
    log("four cards: per-device bytes_in_use "
        + ", ".join(f"{dv.id}:{s['bytes_in_use']}" for dv, s in
                    zip(devs, stats))
        + " | peak_bytes_in_use "
        + ", ".join(f"{dv.id}:{s['peak_bytes_in_use']}" for dv, s in
                    zip(devs, stats)))
    check(d.max() <= 1, f"sharded render deviates {d.max()} u8 steps")
    # each card integrates its frames: its peak must hold at least the
    # first-crossing temporaries of one frame (E x K x 128 f32)
    check(all(s["peak_bytes_in_use"] > 2 ** 30 for s in stats),
          "a card of the mesh did no frame work")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the frame-sharded render over 4 cards "
                         "and the one-card render it is compared with")
    args = ap.parse_args(argv)

    from bench import flagship_job

    if not args.four_cards:
        _keep_cpu_backend()
    clock = _CompileClock()
    dev, card = phase_device(4 if args.four_cards else 1)
    job = flagship_job()
    if args.four_cards:
        phase_four_cards(card, job)
    else:
        sweep_out = phase_render(card, job, clock)
        phase_reference(card, job, flagship_job(noise=0.0), sweep_out)
        phase_stages(card, job)
        phase_screen(card)
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
