# Engine screen pipeline == numpy oracle (VERDICT r3 item 1).
#
# The jitted JAX screen pipeline (forge3d_tpu/terrain/screen.py) must
# reproduce the behavior-exact numpy replica
# (forge3d_tpu/terrain/screen_golden.py — now a test-only oracle) on the
# reference terrain golden family. Measured at swap time: byte-identical
# (max 1 LSB) on 8/9 scenes; terrain_pom within 0.0025 SSIM (f32
# associativity in the POM march).

import numpy as np
import pytest

from forge3d_tpu.utils.metrics import ssim


def _pair(name, size_px=(96, 64)):
    from forge3d_tpu.terrain import screen as eng
    from forge3d_tpu.terrain import screen_golden as sg

    kw = dict(sg.FAMILY_SCENES[name])
    wm = sg.family_water_mask() if kw.pop("water_mask", False) else None
    kw["size_px"] = size_px
    hm = {"family": sg.family_heightmap,
          "tv10": sg.tv10_heightmap}[kw.pop("heightmap", "family")]()
    lut = eng.build_lut_from_stops(kw.pop("stops", sg.FAMILY_STOPS))
    blue = kw.pop("hdr_blue", 128)
    kw.setdefault("hdr_rgb", eng.decode_test_hdr(blue=blue))
    kw.pop("render_scale", None)
    a = sg.render_screen_scene(hm, lut, water_mask=wm, **kw)
    b = eng.render_screen_scene(hm, lut, water_mask=wm, **kw)
    return a, b


@pytest.mark.parametrize("name,max_lsb", [
    ("terrain_pbr", 1),
    ("terrain_water", 1),
    ("terrain_tv10_scene_a_sss", 2),
])
def test_engine_matches_oracle_bytes(name, max_lsb):
    a, b = _pair(name)
    d = np.abs(a[..., :3].astype(int) - b[..., :3].astype(int))
    assert d.max() <= max_lsb, f"{name}: engine deviates {d.max()} LSB"


@pytest.mark.slow
@pytest.mark.parametrize("name", ["terrain_atmosphere",
                                  "terrain_water_reflection"])
def test_engine_matches_oracle_ssim(name):
    a, b = _pair(name)
    s = float(ssim(a[..., :3], b[..., :3]))
    assert s >= 0.998, f"{name}: engine-vs-oracle SSIM {s:.4f}"


def test_engine_pom_close_to_oracle():
    a, b = _pair("terrain_pom", size_px=(128, 80))
    s = float(ssim(a[..., :3], b[..., :3]))
    assert s >= 0.99, f"pom engine-vs-oracle SSIM {s:.4f}"


def test_renderer_screen_dispatch_and_aov():
    """TerrainRenderer(camera_mode='screen') routes to the jitted screen
    pipeline, honors render_scale blit, and returns screen AOVs."""
    from forge3d_tpu import colormaps
    from forge3d_tpu.terrain import screen as eng
    from forge3d_tpu.terrain import screen_golden as sg
    from forge3d_tpu.terrain.params import make_terrain_params
    from forge3d_tpu.terrain.renderer import TerrainRenderer

    lut = eng.build_lut_from_stops(sg.FAMILY_STOPS)
    try:
        colormaps.register("screen_engine_test", lut)
    except Exception:
        pass
    hm = sg.family_heightmap(48)
    p = make_terrain_params(
        size_px=(64, 48), camera_mode="screen", terrain_span=2.8,
        z_scale=1.45, domain=(0.0, 1.0), colormap="screen_engine_test",
        hue_variation_strength=0.08,
        light=dict(azimuth_deg=135.0, elevation_deg=24.0, intensity=2.4,
                   color=(1.0, 1.0, 1.0)),
        ibl=dict(enabled=True, intensity=1.0,
                 env_map=eng.decode_test_hdr()),
        cam_radius=5.0, cam_phi_deg=138.0, cam_theta_deg=63.0,
        fov_y_deg=54.0, clip=(0.1, 6000.0))
    r = TerrainRenderer()
    frame, aov = r.render_with_aov(params=p, heightmap=hm)
    assert frame.rgba.shape == (48, 64, 4)
    assert frame.metadata["camera_mode"] == "screen"
    assert set(aov.aovs) == {"albedo", "normal", "depth"}
    ora = sg.render_screen_scene(
        hm, lut, size_px=(64, 48), terrain_span=2.8, z_scale=1.45,
        light_azimuth_deg=135.0, light_elevation_deg=24.0,
        sun_intensity=2.4, sun_color=(1.0, 1.0, 1.0), ibl_intensity=1.0,
        cam_radius=5.0, cam_phi_deg=138.0, cam_theta_deg=63.0,
        fov_y_deg=54.0, hdr_rgb=eng.decode_test_hdr())
    d = np.abs(frame.rgba[..., :3].astype(int) - ora[..., :3].astype(int))
    assert d.max() <= 1

    # render_scale: internal supersample + bilinear blit to output size
    p2 = make_terrain_params(
        size_px=(64, 48), render_scale=1.25, camera_mode="screen",
        terrain_span=2.8, z_scale=1.45, domain=(0.0, 1.0),
        colormap="screen_engine_test",
        ibl=dict(enabled=True, intensity=1.0,
                 env_map=eng.decode_test_hdr()))
    f2 = r.render_terrain_pbr_pom(params=p2, heightmap=hm)
    assert f2.rgba.shape == (48, 64, 4)


def test_renderer_screen_constant_albedo_and_domain_default():
    from forge3d_tpu.terrain import screen_golden as sg
    from forge3d_tpu.terrain.params import make_terrain_params
    from forge3d_tpu.terrain.renderer import TerrainRenderer

    hm = sg.family_heightmap(32) * 3.0 + 1.0   # non-unit domain
    p = make_terrain_params(
        size_px=(32, 32), camera_mode="screen", albedo_mode="constant",
        constant_albedo=(0.5, 0.4, 0.3))
    frame = TerrainRenderer().render_terrain_pbr_pom(params=p, heightmap=hm)
    assert frame.rgba.shape == (32, 32, 4)
    assert frame.rgba[..., :3].std() > 0  # shaded, not flat


# -- clipmap camera mode: engine == oracle ---------------------------------

def _clipmap_pair():
    import forge3d_tpu.mapscene_screen as mss
    from forge3d_tpu.terrain import screen as eng
    from forge3d_tpu.terrain import screen_golden as sg

    xg = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
    xx, yy = np.meshgrid(xg, xg)
    dem = (0.35 * np.sin(xx * np.pi * 2.0)
           + 0.22 * np.cos(yy * np.pi * 3.0)).astype(np.float32)
    az, el = mss.sun_angles_from_direction((0.64, 0.42, -0.64))
    kw = dict(size_px=(128, 80), camera_mode="clipmap:4:32:32:10:0.3",
              terrain_span=1.0, z_scale=1.2, light_azimuth_deg=az,
              light_elevation_deg=el, sun_intensity=1.15,
              sun_color=(1.0, 0.95, 0.90), ibl_intensity=0.3,
              cam_radius=1.44, cam_phi_deg=135.0, cam_theta_deg=45.0,
              fov_y_deg=55.0, albedo_mode="mix", colormap_strength=0.5,
              hdr_rgb=mss.minimal_hdr_rgb(),
              domain=(float(dem.min()), float(dem.max())),
              pom=dict(enabled=True, height_scale=0.04, min_steps=12,
                       max_steps=40, refine_steps=4, occlusion=True))
    lut = eng.build_lut_from_stops(mss.TERRAIN_STOPS)
    a = sg.render_clipmap_scene(dem, lut, **kw)
    b = eng.render_clipmap_scene(dem, lut, **kw)
    return a, b


def test_clipmap_engine_matches_oracle():
    a, b = _clipmap_pair()
    d = np.abs(a[..., :3].astype(int) - b[..., :3].astype(int))
    # mean within a fraction of an LSB; isolated plateau-boundary pixels
    # may flip a quantization step under f32 vs f64 association
    assert d.mean() <= 0.25, f"clipmap engine-vs-oracle mean {d.mean():.3f}"
    assert (d > 2).mean() <= 0.005, \
        f"clipmap engine-vs-oracle outliers {(d > 2).mean():.4f}"
    s = float(ssim(a[..., :3], b[..., :3]))
    assert s >= 0.995, f"clipmap engine-vs-oracle SSIM {s:.4f}"
