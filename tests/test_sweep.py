# Sweep renderer correctness: propagation sweeps and polar scan against
# brute-force ray marching, plus converged-image equivalence against the
# per-ray DDA reference estimator (restir=False — the exact
# single-directional-light NEE integral both paths compute; see
# pt/terrain_sweep.py docstring).

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from forge3d_tpu.ops.sweep import (
    grid_derivatives,
    make_strata,
    plan_rot_grid,
    rotate_heights,
    sweep_lighting,
)
from forge3d_tpu.ops.shading import EnvMap


def _brute_visibility(h, w_dir, spacing=1.0, n_steps=400, step=0.25):
    """Reference per-texel visibility along direction w by dense ray
    marching with bilinear height sampling."""
    V, U = h.shape
    wu, wv, wy = w_dir
    lit = np.ones((V, U), bool)
    iu, iv = np.meshgrid(np.arange(U, dtype=np.float64),
                         np.arange(V, dtype=np.float64))
    horiz = math.hypot(wu, wv)
    if horiz < 1e-9:
        return lit
    for s in range(1, n_steps + 1):
        d = s * step
        pu = iu + d * wu / horiz
        pv = iv + d * wv / horiz
        py = h + d * spacing * wy / horiz  # ray height in world units... NO
        # careful: d is in cells; world horizontal distance = d*spacing
        py = h + (d * spacing) * (wy / horiz)
        inside = (pu >= 0) & (pu <= U - 1) & (pv >= 0) & (pv <= V - 1)
        i0 = np.clip(np.floor(pu).astype(int), 0, U - 2)
        j0 = np.clip(np.floor(pv).astype(int), 0, V - 2)
        au = pu - i0
        av = pv - j0
        hv = (h[j0, i0] * (1 - au) * (1 - av) + h[j0, i0 + 1] * au * (1 - av)
              + h[j0 + 1, i0] * (1 - au) * av + h[j0 + 1, i0 + 1] * au * av)
        blocked = inside & (hv > py + 1e-6)
        lit &= ~blocked
    return lit


@pytest.mark.parametrize("azimuth,elevation", [
    (315.0, 45.0), (10.0, 30.0), (120.0, 60.0), (200.0, 20.0), (80.0, 75.0),
])
def test_sun_sweep_matches_brute_force(azimuth, elevation):
    rng = np.random.default_rng(3)
    n = 48
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    h = (8.0 * np.exp(-((xx - 20) ** 2 + (yy - 25) ** 2) / 60.0)
         + 0.5 * rng.normal(size=(n, n))).astype(np.float32)

    az = math.radians(azimuth)
    el = math.radians(elevation)
    sun = (math.cos(az) * math.cos(el), math.sin(el),
           math.sin(az) * math.cos(el))
    # identity grid: e_u = +x, e_v = +z
    maps = sweep_lighting(
        jnp.asarray(h), jnp.zeros((n, n)), jnp.zeros((n, n)),
        strata=make_strata(4, 1), key=jax.random.PRNGKey(0),
        env=EnvMap(rgb=None, intensity=jnp.float32(0.0)),
        e_u=(1.0, 0.0, 0.0), e_v=(0.0, 0.0, 1.0),
        sun_world=sun, spacing=1.0, sun_only=True)
    lit_sweep = np.asarray(h >= np.asarray(maps.z_sun) - 1e-4)
    # grid direction components: wu along x (e_u), wv along z (e_v)
    lit_ref = _brute_visibility(h, (sun[0], sun[2], sun[1]), n_steps=300)
    agree = (lit_sweep == lit_ref).mean()
    # the 0.5/cell noise DEM is rougher than any real DEM at native
    # resolution; row-sampled propagation (substeps=2) disagrees with the
    # dense march only on sub-cell grazing contacts
    assert agree > 0.94, f"sun visibility agreement {agree:.3f}"


@pytest.mark.parametrize("azimuth,elevation", [(315.0, 35.0), (200.0, 25.0)])
def test_sun_sweep_smooth_dem_high_agreement(azimuth, elevation):
    n = 64
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    h = (6.0 * np.sin(xx * 0.2) * np.cos(yy * 0.17)).astype(np.float32)
    az = math.radians(azimuth)
    el = math.radians(elevation)
    sun = (math.cos(az) * math.cos(el), math.sin(el),
           math.sin(az) * math.cos(el))
    maps = sweep_lighting(
        jnp.asarray(h), jnp.zeros((n, n)), jnp.zeros((n, n)),
        strata=make_strata(4, 1), key=jax.random.PRNGKey(0),
        env=EnvMap(rgb=None, intensity=jnp.float32(0.0)),
        e_u=(1.0, 0.0, 0.0), e_v=(0.0, 0.0, 1.0),
        sun_world=sun, spacing=1.0, sun_only=True)
    lit_sweep = np.asarray(h >= np.asarray(maps.z_sun) - 1e-4)
    lit_ref = _brute_visibility(h, (sun[0], sun[2], sun[1]), n_steps=400)
    agree = (lit_sweep == lit_ref).mean()
    # residual disagreement is the sub-texel shadow boundary zone (the
    # lateral line lerp is smooth where the exact line has creases)
    assert agree > 0.97, f"smooth-DEM sun visibility agreement {agree:.3f}"


def test_sky_irradiance_flat_unshadowed():
    """Flat ground: E_sky must equal env_intensity (the full cosine-weighted
    hemisphere integral of a constant environment)."""
    n = 32
    h = jnp.zeros((n, n))
    maps = sweep_lighting(
        h, jnp.zeros((n, n)), jnp.zeros((n, n)),
        strata=make_strata(32, 12), key=jax.random.PRNGKey(1),
        env=EnvMap(rgb=None, intensity=jnp.float32(0.7)),
        e_u=(1.0, 0.0, 0.0), e_v=(0.0, 0.0, 1.0),
        sun_world=(0.0, 1.0, 0.0), spacing=1.0)
    e = np.asarray(maps.e_sky)[8:-8, 8:-8]
    assert np.allclose(e, 0.7, rtol=0.02), (e.min(), e.max())


def test_sky_irradiance_slope_and_valley():
    """An infinite inclined plane still sees its full normal-hemisphere
    (E ~ env), while a valley floor between two walls sees only a wedge of
    sky (E well below env)."""
    n = 64
    xx = np.arange(n, dtype=np.float32)
    slope = np.broadcast_to(2.0 * xx, (n, n)).astype(np.float32).copy()
    du_s = np.full((n, n), 2.0, np.float32)
    valley = np.broadcast_to(2.0 * np.abs(xx - n / 2), (n, n)) \
        .astype(np.float32).copy()
    du_v = np.broadcast_to(2.0 * np.sign(xx - n / 2), (n, n)) \
        .astype(np.float32).copy()

    def esky(h, du):
        maps = sweep_lighting(
            jnp.asarray(h), jnp.asarray(du), jnp.zeros((n, n)),
            strata=make_strata(32, 12), key=jax.random.PRNGKey(2),
            env=EnvMap(rgb=None, intensity=jnp.float32(1.0)),
            e_u=(1.0, 0.0, 0.0), e_v=(0.0, 0.0, 1.0),
            sun_world=(0.0, 1.0, 0.0), spacing=1.0)
        return np.asarray(maps.e_sky)

    e_slope = esky(slope, du_s)[24:-24, 24:-24]
    assert (e_slope > 0.85).all() and (e_slope < 1.05).all(), (
        e_slope.min(), e_slope.max())
    e_valley = esky(valley, du_v)
    floor = e_valley[24:-24, n // 2 - 1: n // 2 + 2]
    # valley floor between two atan(2) walls sees roughly the wedge
    # fraction of the cosine-weighted dome
    assert (floor < 0.6).all() and (floor > 0.15).all(), (
        floor.min(), floor.max())


def test_polar_hits_match_dda():
    """Polar-scan primary hit distances agree with the DDA traversal."""
    from forge3d_tpu.camera import camera_basis
    from forge3d_tpu.ops.polarscan import (plan_polar, extract_profiles,
                                           profile_hit_tangents,
                                           synthesize_polar, warp_to_screen)
    from forge3d_tpu.ops.pyramid import build_pyramid
    from forge3d_tpu.ops.traversal import scene_from_pyramid, trace

    n = 65
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(xx * 0.15) * np.cos(yy * 0.12)).astype(np.float32)
    W, H = 96, 64
    cam_o = (32.0, 25.0, 85.0)
    look = (32.0, 0.0, 32.0)
    right, up_v, fwd = camera_basis(cam_o, look, (0, 1, 0))

    cam_xz = (cam_o[0], cam_o[2])
    rg = plan_rot_grid(n - 1, n - 1, origin_xz=(0., 0.), spacing_xz=(1., 1.),
                       cam_xz=cam_xz, fwd_xz=(float(fwd[0]), float(fwd[2])))
    h_rot, valid = rotate_heights(jnp.asarray(dem), rg, origin_xz=(0., 0.),
                                  spacing_xz=(1., 1.), cam_xz=cam_xz)
    ps = plan_polar(width=W, height=H, fov_y_deg=40.0, right=right, up=up_v,
                    fwd=fwd, cam_y=cam_o[1], rg_n_v=rg.n_v, rg_n_u=rg.n_u,
                    rg_spacing=rg.spacing, e_u=rg.e_u, e_v=rg.e_v,
                    cam_iu=rg.cam_iu, cam_iv=rg.cam_iv)
    rotbuf = h_rot[..., None]
    prof = extract_profiles(rotbuf, ps, xi=0.0, ja=0.0)
    q_prof, t_dist = profile_hit_tangents(prof[..., 0], ps, xi=0.0, ja=0.0)
    ones = jnp.ones_like(q_prof)
    values = jnp.stack([t_dist, ones], -1)
    miss = jnp.zeros((ps.e_count, ps.a_count, 2), jnp.float32)
    polar = synthesize_polar(values, q_prof, miss, ps, je=0.0)
    img = warp_to_screen(polar, ps, width=W, height=H, supersample=1)
    t_sweep = np.asarray(img[..., 0])
    vis_sweep = np.asarray(img[..., 1])

    # DDA reference rays through pixel centers
    pyr = build_pyramid(dem)
    scene, static = scene_from_pyramid(pyr)
    xs = (np.arange(W, dtype=np.float32) + 0.5) / W * 2.0 - 1.0
    ys = 1.0 - (np.arange(H, dtype=np.float32) + 0.5) / H * 2.0 - 0.0
    ys = (1.0 - (np.arange(H, dtype=np.float32) + 0.5) / H) * 2.0 - 1.0
    hh = math.tan(math.radians(40.0) * 0.5)
    hw = hh * W / H
    dx = (fwd[0] + xs[None, :] * hw * right[0] + ys[:, None] * hh * up_v[0])
    dy = (fwd[1] + xs[None, :] * hw * right[1] + ys[:, None] * hh * up_v[1])
    dz = (fwd[2] + xs[None, :] * hw * right[2] + ys[:, None] * hh * up_v[2])
    inv = 1.0 / np.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    ro = tuple(jnp.full((H, W), c, jnp.float32) for c in cam_o)
    hit = trace(scene, static, ro, (jnp.asarray(dx), jnp.asarray(dy),
                                    jnp.asarray(dz)))
    hit_ref = np.asarray(hit.hit)
    t_ref = np.asarray(hit.t)

    both = hit_ref & (vis_sweep > 0.9)
    assert both.mean() > 0.5  # scene fills most of the frame
    # hit/miss classification agrees away from silhouettes
    agree = ((vis_sweep > 0.5) == hit_ref).mean()
    assert agree > 0.97, f"hit classification agreement {agree}"
    rel = np.abs(t_sweep[both] - t_ref[both]) / t_ref[both]
    assert np.median(rel) < 0.01, f"median hit-distance error {np.median(rel)}"
    assert np.percentile(rel, 90) < 0.05


@pytest.mark.slow
def test_sweep_render_matches_reference_converged():
    """Converged sweep render vs converged per-ray reference (restir=False):
    the same integral estimated two ways."""
    from forge3d_tpu.pt.terrain_ref import (TerrainRefDesc,
                                            render_terrain_reference)
    from forge3d_tpu.pt.terrain_sweep import render_terrain_sweep
    from forge3d_tpu.utils.metrics import ssim

    n = 65
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(xx * 0.15) * np.cos(yy * 0.12)).astype(np.float32)
    kw = dict(heights=dem, cam_origin=(32.0, 22.0, 90.0),
              cam_look_at=(32.0, 0.0, 32.0), fov_y_deg=42.0,
              width=128, height=96)
    ref = render_terrain_reference(TerrainRefDesc(
        spp=8, min_frames=32, max_frames=64, variance_threshold=1e9,
        restir=False, **kw))
    sw = render_terrain_sweep(TerrainRefDesc(spp=1, **kw), frames=16)
    a = ref["rgba"][..., :3].astype(np.float32) / 255
    b = sw["rgba"][..., :3].astype(np.float32) / 255
    s = ssim(a, b)
    mad = float(np.abs(a - b).mean() * 255)
    # ratchet: round-3 measured 0.9927 / 0.53 on this scene after (a)
    # exact bilinear-patch normals gathered at the profile sample
    # positions (no slope resampling at all), (b) sub-row crossing
    # interpolation in the first-hit contraction (anti-aliased
    # silhouettes/boundaries), (c) the ray-height-guarded phantom rule,
    # and (d) EXACT boundary-entry samples: the sentinel row before each
    # azimuth's first in-DEM sample is replaced by a sample evaluated at
    # the true DEM-rect crossing, so front-edge hits position and shade
    # exactly (this removed the bottom-frame residual stripe). Gate holds
    # a margin below the measurement so backend noise can't flake it.
    assert s > 0.99, f"SSIM {s}"
    assert mad < 0.8, f"mean abs diff {mad}/255"


def test_sweep_sequence_bitwise_matches_single_calls():
    """Pipelined sequence frames are bit-identical to single renders."""
    from forge3d_tpu.pt.terrain_ref import TerrainRefDesc
    from forge3d_tpu.pt.terrain_sweep import (render_terrain_sweep,
                                              render_terrain_sweep_sequence)

    n = 33
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (4.0 * np.sin(xx * 0.2) * np.cos(yy * 0.17)).astype(np.float32)
    kw = dict(heights=dem, cam_origin=(16.0, 14.0, 46.0),
              cam_look_at=(16.0, 0.0, 16.0), fov_y_deg=42.0,
              width=64, height=48)
    seq = render_terrain_sweep_sequence(
        TerrainRefDesc(spp=1, seed=3, **kw), seeds=[3, 9], frames=4)
    assert len(seq) == 2
    for seed, out in zip((3, 9), seq):
        one = render_terrain_sweep(TerrainRefDesc(spp=1, seed=seed, **kw),
                                   frames=4)
        assert np.array_equal(out["rgba"], one["rgba"])
        assert np.array_equal(out["depth"], one["depth"], equal_nan=True)
