# forge3d_tpu/terrain/renderer.py
# TerrainRenderer: the production offscreen terrain renderer
# (raster-equivalent), rebuilt as a primary-visibility ray engine.
#
# Parity notes (reference behavior, not code):
#   - API: TerrainRenderer(session) + render_terrain_pbr_pom(material_set,
#     env_maps, params, heightmap, target=None, water_mask=None,
#     time_seconds=0.0, certificate=None, cache=None) -> Frame and
#     render_with_aov(...) -> (Frame, AovFrame)
#     (/root/reference/src/terrain/renderer/py_api.rs:182,247,317).
#   - Feature checklist of the forward pass (terrain_pbr_pom.wgsl, SURVEY
#     A.3): colormap/hypsometric albedo + height curve, height/slope
#     material layers (snow/rock), lambert contrast, sun + ambient + IBL,
#     shadows, water, fog, tonemap + sRGB EOTF, AA supersampling.
#
# Design: there is no raster pipeline, so the 4-pass framegraph
# (prepare/shadow/forward/resolve) collapses into ONE jitted program:
# jittered primary rays (MSAA-equivalent), heightfield traversal (shared
# with the path tracer — CSM shadow maps are replaced by ray-marched sun
# visibility on the same min-max pyramid), fused shading, tonemap. Numeric
# parameters travel as traced uniforms so param changes don't recompile;
# only structural switches (feature on/off, sizes) specialize the program.

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import colormaps
from ..camera import camera_basis, orbit_camera_origin
from ..errors import RenderError, UploadError
from ..frame import AovFrame, Frame, HdrFrame
from ..mem import global_tracker
from ..ops import tonemap as tm
from ..ops.pyramid import build_pyramid
from ..ops.rng import seed_state, xorshift32
from ..ops.shading import cosine_dir, luminance
from ..ops.traversal import normal_at, scene_from_pyramid, trace
from .params import TerrainRenderParams, make_terrain_params

_F32 = jnp.float32


class MaterialSet:
    """Material description for the terrain surface.

    The reference's MaterialSet carries PBR texture stacks resolved
    through virtual texturing (src/terrain/vt/, terrain_pbr_pom.wgsl
    :1939-2283). Here a MaterialSet can bind a packed VT store
    (terrain/vt.py): per render, the residency pass decodes the needed
    albedo pages under the budget into a fixed-capacity atlas, and the
    shader samples it by (level, page, texel) with graceful fallback to
    the colormap/constant albedo where pages are not resident (fallback
    texels are counted per render — the TESSELLA evidence metric)."""

    def __init__(self, name: str = "default", vt_store=None,
                 vt_budget_bytes: int = 64 * 1024 * 1024):
        self.name = name
        self.vt_budget_bytes = int(vt_budget_bytes)
        if vt_store is not None and not hasattr(vt_store, "request"):
            from .vt import VTStore

            vt_store = VTStore(vt_store, budget_bytes=self.vt_budget_bytes)
        self.vt_store = vt_store

    @staticmethod
    def default() -> "MaterialSet":
        return MaterialSet()


class IBL:
    """Environment lighting wrapper (reference: lighting/ibl_wrapper.rs)."""

    def __init__(self, env_map: Optional[np.ndarray] = None, intensity: float = 0.35):
        if env_map is not None:
            env_map = np.asarray(env_map, np.float32)
            if env_map.ndim != 3 or env_map.shape[2] != 3:
                raise UploadError("IBL env_map must be (H, W, 3)")
        self.env_map = env_map
        self.intensity = float(intensity)

    @staticmethod
    def default() -> "IBL":
        return IBL()


def _static_key(p: TerrainRenderParams, has_env: bool, has_water_mask: bool,
                W: int, H: int, dem_shape, vt_static=None) -> tuple:
    return (
        vt_static,
        W, H, int(p.sampling.aa_samples), p.albedo_mode, p.tonemap.mode,
        bool(p.output_srgb_eotf), bool(p.shadows.enabled), int(p.shadows.samples),
        p.fog is not None and p.fog.enabled,
        p.water is not None and p.water.enabled,
        p.clouds is not None and p.clouds.enabled,
        p.height_ao is not None and p.height_ao.enabled,
        int(p.height_ao.samples) if (p.height_ao and p.height_ao.enabled) else 0,
        p.material_layers is not None and p.material_layers.enabled,
        p.triplanar is not None and p.triplanar.enabled,
        p.detail is not None and p.detail.enabled,
        p.pom is not None and p.pom.enabled and float(p.pom.scale) > 0.0,
        p.reflection is not None and p.reflection.enabled,
        has_env, has_water_mask, p.height_curve_mode, p.debug_mode,
        dem_shape,
    )


class TerrainRenderer:
    """Offscreen PBR terrain renderer (one jitted program per config)."""

    def __init__(self, session=None):
        from ..device import Session, try_ctx

        try_ctx()
        self._session = session if session is not None else Session(window=False)
        self._fn_cache: Dict[tuple, object] = {}
        self._scene_cache: Dict[tuple, tuple] = {}
        self.last_consumed_settings: tuple = ()
        self.last_ignored_settings: tuple = ()
        self.last_gpu_timings: Dict[str, float] = {}

    @staticmethod
    def _settings_report(p, has_env: bool, has_water_mask: bool,
                         has_vt: bool):
        """(consumed, ignored) settings-group names for this render.

        `consumed` mirrors the gating conditions in _make_shade exactly;
        `ignored` lists groups the caller ENABLED that this shading path
        does not read — surfacing silent partial parity as a visible
        contract (VERDICT r2 item 7; terrain/params.py:7-10)."""
        consumed = ["light", "sampling", "tonemap", "camera", "colormap"]
        ignored = []
        if p.ibl.enabled:
            consumed.append("ibl")
        if p.shadows.enabled:
            consumed.append("shadows")
        if p.triplanar is not None and p.triplanar.enabled:
            consumed.append("triplanar")
        if p.pom is not None and p.pom.enabled and float(p.pom.scale) > 0:
            consumed.append("pom")
        if p.fog is not None and p.fog.enabled:
            consumed.append("fog")
        water_on = p.water is not None and p.water.enabled
        if water_on:
            consumed.append("water")
        if water_on and p.reflection is not None and p.reflection.enabled:
            consumed.append("reflection")
        elif p.reflection is not None and p.reflection.enabled:
            ignored.append("reflection")   # needs water enabled
        if p.clouds is not None and p.clouds.enabled:
            consumed.append("clouds")
        if p.detail is not None and p.detail.enabled:
            consumed.append("detail")
        if p.height_ao is not None and p.height_ao.enabled:
            consumed.append("height_ao")
        if p.material_layers is not None and p.material_layers.enabled:
            consumed.append("material_layers")
        if has_vt:
            consumed.append("vt")
        if p.height_curve_mode != "linear":
            consumed.append("height_curve")
        # accepted-but-unwired groups: fail loud instead of silent
        if p.sun_visibility is not None and getattr(
                p.sun_visibility, "enabled", False):
            ignored.append("sun_visibility")
        if getattr(p.lod, "enabled", False):
            ignored.append("lod")
        return tuple(sorted(consumed)), tuple(sorted(ignored))

    # -- scene prep --------------------------------------------------------
    def _scene_for(self, heightmap: np.ndarray, span: float, z_scale: float):
        hm = np.ascontiguousarray(np.asarray(heightmap, np.float32))
        key = (hm.shape, float(span), float(z_scale), hash(hm.tobytes()))
        if key in self._scene_cache:
            return self._scene_cache[key]
        h, w = hm.shape
        spacing = (span / (w - 1), span / (h - 1)) if span > 0 else (1.0, 1.0)
        pyr = build_pyramid(hm)
        scene, static = scene_from_pyramid(
            pyr, origin_xz=(0.0, 0.0), spacing_xz=spacing, exaggeration=z_scale
        )
        tracker = global_tracker()
        rid = tracker.track(f"terrain.pyramid{hm.shape}", pyr.nbytes, "pyramid")
        entry = (scene, static, spacing, float(hm.min()), float(hm.max()), rid)
        if len(self._scene_cache) > 4:  # keep the ledger bounded
            _, _, _, _, _, old = self._scene_cache.pop(next(iter(self._scene_cache)))
            tracker.free(old)
        self._scene_cache[key] = entry
        return entry

    # -- public API --------------------------------------------------------
    def render_terrain_pbr_pom(
        self, material_set=None, env_maps=None, params=None, heightmap=None,
        target=None, water_mask=None, time_seconds=0.0, certificate=None,
        cache=None,
    ) -> Frame:
        if target is not None:
            raise RenderError(
                "Custom render targets not supported; use target=None for "
                "offscreen rendering."
            )
        if self.offline_session_active():
            raise RenderError(
                "An offline accumulation session is active; call "
                "end_offline_accumulation() before one-shot rendering."
            )
        if cache is not None and certificate is None:
            from ..assurance.anamnesis import cached_render, open_store

            store = open_store(cache)
            p = params if params is not None else make_terrain_params()
            key_inputs = dict(
                params=p.to_dict(),
                heightmap=np.asarray(heightmap, np.float32),
                water_mask=None if water_mask is None else np.asarray(water_mask),
                time_seconds=float(time_seconds),
            )
            arrays, hit = cached_render(
                store, "terrain.render_terrain_pbr_pom", key_inputs,
                lambda: {"rgba": self._render(
                    material_set, env_maps, params, heightmap, water_mask,
                    time_seconds, want_aov=False)[0].rgba},
            )
            self.last_anamnesis_report = store.report.as_dict() if store else {}
            return Frame(rgba=arrays["rgba"],
                         metadata={"anamnesis_hit": hit})
        frame, _ = self._render(material_set, env_maps, params, heightmap,
                                water_mask, time_seconds, want_aov=False)
        self.last_anamnesis_report = {}
        if certificate is not None:
            from ..assurance.certificate import emit_certificate

            emit_certificate(certificate, "render_terrain_pbr_pom",
                             {"frames": 1, "rgba": frame.rgba})
        return frame

    def render_with_aov(
        self, material_set=None, env_maps=None, params=None, heightmap=None,
        water_mask=None, time_seconds=0.0, certificate=None, cache=None,
    ) -> Tuple[Frame, AovFrame]:
        frame, aov = self._render(material_set, env_maps, params, heightmap,
                                  water_mask, time_seconds, want_aov=True)
        if certificate is not None:
            from ..assurance.certificate import emit_certificate

            emit_certificate(certificate, "render_with_aov",
                             {"frames": 1, "rgba": frame.rgba})
        return frame, aov

    # -- core --------------------------------------------------------------
    def _render(self, material_set, env_maps, params, heightmap, water_mask,
                time_seconds, want_aov: bool):
        import time as _time

        if heightmap is None:
            raise UploadError("heightmap is required")
        p = params if params is not None else make_terrain_params()
        p.validate()
        env: IBL = env_maps if env_maps is not None else IBL.default()
        hm = np.asarray(heightmap, np.float32)
        if hm.ndim != 2 or hm.shape[0] < 2 or hm.shape[1] < 2:
            raise UploadError("heightmap must be 2D, at least 2x2")
        if not np.isfinite(hm).all():
            raise UploadError("heightmap contains non-finite values")

        if p.camera_mode == "screen":
            # The reference's default camera mode: the fullscreen-triangle
            # forward pass (terrain_pbr_pom.wgsl shade_main via
            # py_api.rs:247), evaluated by the jitted screen pipeline.
            return self._render_screen(p, hm, env_maps, water_mask,
                                       want_aov)

        W = max(1, int(round(p.size_px[0] * p.render_scale)))
        H = max(1, int(round(p.size_px[1] * p.render_scale)))
        span = p.terrain_span if p.terrain_span > 0 else float(hm.shape[1] - 1)

        t0 = _time.perf_counter()
        scene, static, spacing, hmin, hmax, _ = self._scene_for(hm, span, p.z_scale)

        has_env = p.ibl.enabled and (p.ibl.env_map is not None or env.env_map is not None)
        env_rgb = None
        if has_env:
            env_rgb = jnp.asarray(
                p.ibl.env_map if p.ibl.env_map is not None else env.env_map, _F32
            )
        elif p.ibl.enabled and getattr(p.ibl, "sky_model", "hosek") == "hosek":
            # bake the reference's analytic sky (Hosek-Wilkie RGB) as the
            # environment when IBL is on but no explicit map is bound
            from ..sky import hosek_environment_map

            env_rgb = jnp.asarray(hosek_environment_map(
                p.light.azimuth_deg, p.light.elevation_deg,
                turbidity=p.ibl.turbidity,
                ground_albedo=p.ibl.ground_albedo, width=128, height=64), _F32)
            has_env = True
        wm = None
        if water_mask is not None:
            wm = np.asarray(water_mask, np.float32)
            if wm.shape != hm.shape:
                raise UploadError("water_mask must match heightmap shape")

        t_scene = _time.perf_counter()
        vt_static = None
        vt_uni = None
        vt = getattr(material_set, "vt_store", None) \
            if material_set is not None else None
        if vt is not None:
            vt_static, vt_uni = self._vt_residency(
                vt, p, span, W, H,
                budget=getattr(material_set, "vt_budget_bytes",
                               64 * 1024 * 1024))

        key = _static_key(p, has_env, wm is not None, W, H, hm.shape,
                          vt_static)
        if key not in self._fn_cache:
            self._fn_cache[key] = jax.jit(
                self._build_program(p, static, W, H, has_env, wm is not None,
                                    vt_static)
            )
        fn = self._fn_cache[key]
        self.last_consumed_settings, self.last_ignored_settings = \
            self._settings_report(p, has_env, wm is not None, vt is not None)

        uni = self._uniforms(p, hm, span, hmin, hmax, W, H, time_seconds)
        if env_rgb is not None:
            uni["env_rgb"] = env_rgb
        if wm is not None:
            uni["water_mask"] = jnp.asarray(wm.ravel())
        if vt_uni is not None:
            uni.update(vt_uni)

        t_prep = _time.perf_counter()
        out = fn(scene, uni)
        # scalar readback waits for the device program to finish, so the
        # main-pass timing excludes the host readback of the image
        vt_fallback = float(out["vt_fallback"])
        t_exec = _time.perf_counter()
        if vt is not None:
            self.last_vt_stats = {
                **vt.stats(),
                "fallback_texels_frame": vt_fallback,
            }
        ldr = np.asarray(out["ldr"])
        rgba = np.concatenate(
            [
                (np.clip(ldr, 0, 1) * 255 + 0.5).astype(np.uint8),
                np.full((H, W, 1), 255, np.uint8),
            ],
            axis=-1,
        )
        t_read = _time.perf_counter()
        ms = (t_read - t0) * 1000.0
        # per-pass wall timings (compile included on first use of a config;
        # ref: src/core/gpu_timing.rs scopes + certificates-with-timing)
        self.last_gpu_timings = {
            "terrain_main_pass_ms": (t_exec - t_prep) * 1000.0,
            "prepare_ms": (t_scene - t0) * 1000.0,
            "vt_residency_ms": (t_prep - t_scene) * 1000.0,
            "readback_ms": (t_read - t_exec) * 1000.0,
            "total_ms": ms,
        }
        from ..assurance.certificate import current_capture

        cap = current_capture()
        if cap is not None:
            for name, v in self.last_gpu_timings.items():
                if name != "total_ms":
                    cap.record_pass(name, v)
        meta = {
            "width": W, "height": H, "aa_samples": p.sampling.aa_samples,
            "albedo_mode": p.albedo_mode, "tonemap": p.tonemap.mode,
            "render_ms": ms, "gpu_timings": dict(self.last_gpu_timings),
        }
        frame = Frame(rgba=rgba, metadata=meta)
        aov_frame = None
        if want_aov:
            aov_frame = AovFrame(
                aovs={
                    "albedo": np.asarray(out["albedo"], np.float32),
                    "normal": np.asarray(out["normal"], np.float32),
                    "depth": np.asarray(out["depth"], np.float32),
                    "visibility": np.asarray(out["visibility"], np.float32),
                    "hdr": np.asarray(out["hdr"], np.float32),
                },
                metadata=meta,
            )
        return frame, aov_frame

    def _render_screen(self, p: TerrainRenderParams, hm, env_maps,
                       water_mask, want_aov: bool):
        """camera_mode="screen": dispatch to the jitted screen pipeline
        (terrain/screen.py), mapping TerrainRenderParams onto the
        reference shade_main contract (py_api.rs:247, A.4)."""
        import time as _time

        from .. import colormaps
        from . import screen as scr

        t0 = _time.perf_counter()
        env: IBL = env_maps if env_maps is not None else IBL.default()
        env_rgb = p.ibl.env_map if p.ibl.env_map is not None else env.env_map
        if env_rgb is None:
            # product default: the reference MapScene's minimal clear-sky
            # Radiance env (map_scene.py _write_minimal_hdr: 2x2 constant
            # (180,190,205) @ e=128 -> byte/256)
            env_rgb = np.full((2, 2, 3), 0.0, np.float32)
            env_rgb[:] = np.array([180.0, 190.0, 205.0], np.float32) / 256.0

        dom = p.domain
        if dom is None:
            dom = (float(hm.min()), float(hm.max()))
            if dom[0] == dom[1]:
                dom = (dom[0], dom[0] + 1.0)

        albedo_mode = p.albedo_mode
        material_albedo = None
        if albedo_mode == "constant":
            albedo_mode = "material"
            material_albedo = np.broadcast_to(
                np.asarray(p.constant_albedo, np.float32), (1, 1, 3))

        lut = np.asarray(colormaps.get_lut(p.colormap), np.float32)[:, :3]

        mats = None
        if p.material_layers is not None and p.material_layers.enabled:
            mats = p.material_layers.to_layer_dict()
        pom = None
        if p.pom is not None and p.pom.enabled and float(p.pom.scale) > 0.0:
            pom = p.pom.to_screen_cfg()
        refl = None
        if p.reflection is not None and p.reflection.enabled:
            refl = dict(enabled=True,
                        intensity=float(p.reflection.intensity),
                        fresnel_power=float(p.reflection.fresnel_power),
                        wave_strength=float(p.reflection.wave_strength),
                        shore_atten_width=float(
                            p.reflection.shore_atten_width),
                        water_plane_height=float(
                            p.reflection.water_plane_height))
        sky = p.sky.to_dict_cfg() if p.sky is not None else None

        W_out, H_out = int(p.size_px[0]), int(p.size_px[1])
        W = max(1, int(round(W_out * p.render_scale)))
        H = max(1, int(round(H_out * p.render_scale)))
        span = p.terrain_span if p.terrain_span > 0 \
            else float(hm.shape[1] - 1)

        kw = dict(
            size_px=(W, H), terrain_span=span, z_scale=p.z_scale,
            exposure=p.exposure,
            light_azimuth_deg=p.light.azimuth_deg,
            light_elevation_deg=p.light.elevation_deg,
            sun_intensity=p.light.intensity,
            sun_color=tuple(p.light.color),
            ibl_intensity=p.ibl.intensity if p.ibl.enabled else 0.0,
            cam_radius=p.cam_radius, cam_phi_deg=p.cam_phi_deg,
            cam_theta_deg=p.cam_theta_deg, fov_y_deg=p.fov_y_deg,
            clip=tuple(p.clip), albedo_mode=albedo_mode,
            colormap_strength=p.colormap_strength,
            hue_variation_strength=p.hue_variation_strength,
            water_mask=water_mask, sky=sky, hdr_rgb=env_rgb,
            material_albedo_rgb=material_albedo, materials=mats,
            pom=pom, reflection=refl, domain=dom,
        )
        if want_aov:
            rgba, aovs = scr.render_screen_scene(hm, lut, return_aov=True,
                                                 **kw)
        else:
            rgba = scr.render_screen_scene(hm, lut, **kw)
            aovs = None
        if (W, H) != (W_out, H_out):
            rgba = scr.blit_resolve(rgba, W_out, H_out)
        ms = (_time.perf_counter() - t0) * 1000.0
        self.last_gpu_timings = {
            "terrain_main_pass_ms": ms, "prepare_ms": 0.0,
            "vt_residency_ms": 0.0, "readback_ms": 0.0, "total_ms": ms,
        }
        self.last_consumed_settings, self.last_ignored_settings = \
            self._settings_report(p, True, water_mask is not None, False)
        meta = {
            "width": W_out, "height": H_out, "camera_mode": "screen",
            "albedo_mode": p.albedo_mode, "render_ms": ms,
            "gpu_timings": dict(self.last_gpu_timings),
        }
        frame = Frame(rgba=rgba, metadata=meta)
        aov_frame = None
        if want_aov:
            aov_frame = AovFrame(aovs=aovs, metadata=meta)
        return frame, aov_frame

    def _uniforms(self, p: TerrainRenderParams, hm, span, hmin, hmax, W, H,
                  time_seconds) -> dict:
        # Orbit camera (Y-up): the reference's screen/mesh orbit modes both
        # reduce to this basis for the primary-visibility engine.
        target = np.asarray(p.cam_target, np.float64)
        if not np.any(target):
            # default: center of the terrain footprint
            target = np.array([span * 0.5, 0.0, span * 0.5 * (hm.shape[0] - 1) / (hm.shape[1] - 1)])
        origin = orbit_camera_origin(target, p.cam_radius, p.cam_phi_deg, p.cam_theta_deg)
        right, up, fwd = camera_basis(origin, target, (0.0, 1.0, 0.0))
        if abs(p.cam_gamma_deg) > 1e-6:
            g = math.radians(p.cam_gamma_deg)
            c, s = math.cos(g), math.sin(g)
            right, up = (c * right + s * up), (-s * right + c * up)

        az = math.radians(p.light.azimuth_deg)
        el = math.radians(p.light.elevation_deg)
        sun = np.array([math.cos(az) * math.cos(el), math.sin(el),
                        math.sin(az) * math.cos(el)], np.float32)
        f = lambda v: jnp.asarray(v, _F32)
        layers = p.material_layers
        uni = {
            "cam_origin": f(origin), "cam_right": f(right), "cam_up": f(up),
            "cam_fwd": f(fwd),
            "half_h": f(math.tan(math.radians(p.fov_y_deg) * 0.5)),
            "sun_dir": f(sun),
            "sun_rgb": f(np.asarray(p.light.color) * p.light.intensity),
            "ambient_rgb": f(np.asarray(p.light.ambient_color) * p.light.ambient),
            "ibl_intensity": f(p.ibl.intensity),
            "hmin": f(hmin * p.z_scale), "hmax": f(hmax * p.z_scale),
            "exposure": f(p.tonemap.exposure * p.exposure),
            "inv_gamma": f(1.0 / p.gamma),
            "colormap_strength": f(p.colormap_strength),
            "constant_albedo": f(p.constant_albedo),
            "lambert_contrast": f(p.lambert_contrast),
            "lut": jnp.asarray(colormaps.get_lut(p.colormap)),
            "shadow_softness": f(math.radians(p.shadows.softness)),
            "shadow_intensity": f(p.shadows.intensity),
            "shadow_bias": f(p.shadows.bias),
            "aa_seed": jnp.uint32(p.sampling.aa_seed),
            "height_curve_power": f(p.height_curve_power),
            "height_curve_strength": f(p.height_curve_strength),
            "ao_weight": f(p.ao_weight),
            "white_point": f(p.tonemap.white_point),
            "time": f(time_seconds),
        }
        if p.fog and p.fog.enabled:
            uni["fog_density"] = f(p.fog.density)
            uni["fog_rgb"] = f(p.fog.color)
            uni["fog_falloff"] = f(p.fog.height_falloff)
            uni["fog_start"] = f(p.fog.start_distance)
        if p.water and p.water.enabled:
            uni["water_level"] = f(p.water.level * p.z_scale)
            uni["water_rgb"] = f(p.water.color)
            uni["water_reflectivity"] = f(p.water.reflectivity)
        if p.clouds and p.clouds.enabled:
            uni["cloud_coverage"] = f(p.clouds.coverage)
            uni["cloud_strength"] = f(p.clouds.shadow_strength)
            uni["cloud_scale"] = f(p.clouds.scale)
        if p.height_ao and p.height_ao.enabled:
            uni["ao_radius"] = f(p.height_ao.radius)
            uni["ao_strength"] = f(p.height_ao.strength)
        if p.triplanar and p.triplanar.enabled:
            uni["tri_scale"] = f(p.triplanar.scale)
            uni["tri_sharp"] = f(p.triplanar.blend_sharpness)
        if p.detail and p.detail.enabled:
            uni["det_strength"] = f(p.detail.strength)
            uni["det_scale"] = f(p.detail.scale)
            # distance fade: detail fades out by ~3 terrain spans (camera
            # orbits at ~1.2 spans, so near terrain keeps ~60% strength)
            uni["det_fade"] = f(max(span * 3.0, 1.0))
        if p.pom and p.pom.enabled:
            uni["pom_scale"] = f(p.pom.scale)
        if p.reflection and p.reflection.enabled:
            uni["refl_intensity"] = f(p.reflection.intensity)
        if layers and layers.enabled:
            uni["snow_h"] = f(layers.snow_height)
            uni["snow_blend"] = f(max(layers.snow_blend, 1e-4))
            uni["snow_rgb"] = f(layers.snow_color)
            uni["rock_cos"] = f(math.cos(math.radians(layers.rock_slope_deg)))
            uni["rock_blend"] = f(max(math.radians(layers.rock_blend_deg), 1e-4))
            uni["rock_rgb"] = f(layers.rock_color)
        return uni

    def _vt_residency(self, vt, p: TerrainRenderParams, span, W, H, *,
                      budget: int):
        """Analytic residency pass: pick the albedo pages whose mip level
        matches their on-screen footprint from this camera, decode them
        under the budget into a fixed-capacity atlas, and build the page
        table (ref: src/terrain/vt/{store,requests}.rs + in-shader resolve
        terrain_pbr_pom.wgsl:1939-2283). Returns (vt_static, uniforms)."""
        from .vt import PAGE_SIZE

        levels = sorted({k[1] for k in vt.index if k[0] == "albedo"})
        if not levels:
            raise UploadError("VT store has no albedo pages")
        tiles = []
        for lv in levels:
            n = max(k[2] for k in vt.index if k[0] == "albedo"
                    and k[1] == lv) + 1
            tiles.append(int(n))
        level_offs = []
        acc = 0
        for n in tiles:
            level_offs.append(acc)
            acc += n * n
        capacity = max(int(budget) // (PAGE_SIZE * PAGE_SIZE * 3 * 4), 1)

        origin = orbit_camera_origin(p.cam_target, p.cam_radius,
                                     p.cam_phi_deg, p.cam_theta_deg)
        pix_angle = 2.0 * math.tan(math.radians(p.fov_y_deg) * 0.5) / H
        tpw0 = tiles[0] * PAGE_SIZE / max(span, 1e-6)

        # desired level per candidate page from its center's distance
        cands = []
        for li, lv in enumerate(levels):
            n = tiles[li]
            for (kind, lvv, x, y) in vt.index:
                if kind != "albedo" or lvv != lv:
                    continue
                cx = (x + 0.5) / n * span
                cz = (y + 0.5) / n * span
                d = math.dist((cx, 0.0, cz),
                              (origin[0], origin[1], origin[2]))
                desired = math.log2(max(d * pix_angle * tpw0, 1e-9))
                # the shader clamps per-pixel levels into the pyramid
                # range, so clamp the estimate the same way
                desired = min(max(desired, levels[0]), levels[-1])
                prio = abs(desired - lv)
                cands.append((prio, d, li, x, y))
        cands.sort()
        table = np.full(acc, -1, np.int32)
        atlas = np.zeros((capacity, PAGE_SIZE, PAGE_SIZE, 3), np.float32)
        slot = 0
        for prio, d, li, x, y in cands:
            if slot >= capacity or prio > 1.0:
                break
            page = vt.request("albedo", levels[li], x, y)
            rgb = np.asarray(page, np.float32)
            if rgb.dtype != np.float32 or rgb.max() > 1.5:
                rgb = rgb.astype(np.float32) / 255.0
            atlas[slot] = rgb[..., :3]
            table[level_offs[li] + y * tiles[li] + x] = slot
            slot += 1

        vt_static = (tuple(levels), tuple(tiles), tuple(level_offs),
                     PAGE_SIZE)
        vt_uni = {
            "vt_atlas": jnp.asarray(atlas.reshape(-1, 3)),
            "vt_table": jnp.asarray(table),
            "vt_pix_angle": jnp.asarray(pix_angle, _F32),
            "vt_tpw0": jnp.asarray(tpw0, _F32),
            "vt_inv_span": jnp.asarray(1.0 / max(span, 1e-6), _F32),
        }
        return vt_static, vt_uni

    def _make_shade(self, p: TerrainRenderParams, static, W, H, has_env,
                    has_water_mask, vt_static=None):
        """Build the shared per-sample shading closure used by both the
        one-shot program and the offline accumulation step."""
        aa = int(p.sampling.aa_samples)
        use_colormap = p.albedo_mode == "colormap"
        tonemap_mode = p.tonemap.mode
        srgb_out = bool(p.output_srgb_eotf)
        shadows_on = bool(p.shadows.enabled)
        shadow_samples = max(1, int(p.shadows.samples)) if shadows_on else 0
        fog_on = p.fog is not None and p.fog.enabled
        water_on = p.water is not None and p.water.enabled
        clouds_on = p.clouds is not None and p.clouds.enabled
        ao_on = p.height_ao is not None and p.height_ao.enabled
        ao_samples = int(p.height_ao.samples) if ao_on else 0
        layers_on = p.material_layers is not None and p.material_layers.enabled
        curve_mode = p.height_curve_mode
        debug_mode = p.debug_mode
        tri_on = p.triplanar is not None and p.triplanar.enabled
        det_on = p.detail is not None and p.detail.enabled
        pom_on = (p.pom is not None and p.pom.enabled
                  and float(p.pom.scale) > 0.0)
        wrefl_on = (water_on and p.reflection is not None
                    and p.reflection.enabled)

        def vnoise2(x, z):
            """Deterministic 2-D value noise (hash lattice + smoothstep)."""
            xi = jnp.floor(x)
            zi = jnp.floor(z)
            xf = x - xi
            zf = z - zi

            def h(ix, iz):
                n = (ix.astype(jnp.int32) * 374761393
                     + iz.astype(jnp.int32) * 668265263) ^ 1274126177
                n = (n ^ (n >> 13)) * 1103515245
                return ((n >> 8) & 0xFFFF).astype(_F32) / 65535.0

            sx = xf * xf * (3 - 2 * xf)
            sz = zf * zf * (3 - 2 * zf)
            a = h(xi, zi) * (1 - sx) + h(xi + 1, zi) * sx
            b = h(xi, zi + 1) * (1 - sx) + h(xi + 1, zi + 1) * sx
            return a * (1 - sz) + b * sz

        def sky_rgb(u, dy):
            t = jnp.clip(0.5 * (dy + 1.0), 0.0, 1.0)
            horizon = jnp.asarray([0.95, 0.97, 1.0])
            zenith = u["ambient_rgb"] / jnp.maximum(luminance(*u["ambient_rgb"]), 1e-4) * 0.9
            out = []
            for c in range(3):
                out.append(horizon[c] * (1 - t) + zenith[c] * t)
            return out

        def env_sample(u, dx, dy, dz):
            if has_env:
                from ..ops.shading import EnvMap, env_radiance

                em = EnvMap(rgb=u["env_rgb"], intensity=u["ibl_intensity"])
                return env_radiance(em, dx, dy, dz)
            s = sky_rgb(u, dy)
            return s[0] * u["ibl_intensity"], s[1] * u["ibl_intensity"], s[2] * u["ibl_intensity"]

        def cloud_shadow(u, px, pz):
            # cheap two-octave value noise, time-scrolled
            sc = u["cloud_scale"]
            tshift = u["time"] * 0.02
            n = 0.65 * vnoise2(px * sc + tshift, pz * sc) + 0.35 * vnoise2(
                px * sc * 2.7 + 13.7 + tshift * 1.7, pz * sc * 2.7
            )
            cov = jnp.clip((n - (1.0 - u["cloud_coverage"])) / jnp.maximum(u["cloud_coverage"], 1e-4), 0.0, 1.0)
            return 1.0 - u["cloud_strength"] * cov

        def shade(scene, u, jx, jy, st):
            xs = jax.lax.broadcasted_iota(_F32, (H, W), 1)
            ys = jax.lax.broadcasted_iota(_F32, (H, W), 0)
            ndc_x = ((xs + 0.5 + jx) / W) * 2.0 - 1.0
            ndc_y = (1.0 - (ys + 0.5 + jy) / H) * 2.0 - 1.0
            cx = ndc_x * (W / H) * u["half_h"]
            cy = ndc_y * u["half_h"]
            dx = cx * u["cam_right"][0] + cy * u["cam_up"][0] + u["cam_fwd"][0]
            dy = cx * u["cam_right"][1] + cy * u["cam_up"][1] + u["cam_fwd"][1]
            dz = cx * u["cam_right"][2] + cy * u["cam_up"][2] + u["cam_fwd"][2]
            inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
            dx, dy, dz = dx * inv, dy * inv, dz * inv
            ox = jnp.full((H, W), u["cam_origin"][0])
            oy = jnp.full((H, W), u["cam_origin"][1])
            oz = jnp.full((H, W), u["cam_origin"][2])

            hit = trace(scene, static, (ox, oy, oz), (dx, dy, dz))
            t = hit.t
            px_ = ox + t * dx
            py_ = oy + t * dy
            pz_ = oz + t * dz
            nx, ny, nz = normal_at(scene, static, (px_, py_, pz_), hit.cell_x, hit.cell_z)

            # shading-sample position (POM: parallax-offset material
            # lookups by the procedural micro-relief along the view ray;
            # geometry-scale displacement is already ray-true — this adds
            # the reference's sub-texel relief. ref terrain_pbr_pom.wgsl
            # :2660)
            if pom_on or det_on or tri_on:
                dsc = u.get("det_scale", jnp.asarray(8.0, _F32))
                dfreq = dsc / jnp.maximum(u["hmax"] - u["hmin"], 1e-6)
            if pom_on:
                hdet = (vnoise2(px_ * dfreq, pz_ * dfreq) - 0.5) \
                    * u["pom_scale"]
                px_s = px_ - dx * hdet
                pz_s = pz_ - dz * hdet
            else:
                px_s, pz_s = px_, pz_

            # detail field: triplanar-blended procedural texture (the
            # reference triplanar-samples material textures weighted by
            # |n|^k — ref :1897-1916, :2313); with triplanar off, a single
            # top-down projection is used.
            if det_on or tri_on:
                d_top = vnoise2(px_s * dfreq, pz_s * dfreq)
                if tri_on:
                    sharp = u["tri_sharp"]
                    wx_ = jnp.power(jnp.abs(nx), sharp)
                    wy_ = jnp.power(jnp.abs(ny), sharp)
                    wz_ = jnp.power(jnp.abs(nz), sharp)
                    wsum = jnp.maximum(wx_ + wy_ + wz_, 1e-6)
                    d_x = vnoise2(py_ * dfreq * u["tri_scale"],
                                  pz_s * dfreq * u["tri_scale"])
                    d_z = vnoise2(px_s * dfreq * u["tri_scale"],
                                  py_ * dfreq * u["tri_scale"])
                    detail = (wx_ * d_x + wy_ * d_top + wz_ * d_z) / wsum
                else:
                    detail = d_top
                dist_fade = jnp.clip(
                    1.0 - t / u.get("det_fade", jnp.asarray(1e9, _F32)),
                    0.0, 1.0)

            # detail normals: gradient of the detail field, RNM-blended
            # onto the geometric normal, distance-faded (ref :2427-2649)
            if det_on:
                eps_d = 0.5 / dfreq
                gdx = (vnoise2((px_s + eps_d) * dfreq, pz_s * dfreq)
                       - vnoise2((px_s - eps_d) * dfreq, pz_s * dfreq)) \
                    / (2 * eps_d)
                gdz = (vnoise2(px_s * dfreq, (pz_s + eps_d) * dfreq)
                       - vnoise2(px_s * dfreq, (pz_s - eps_d) * dfreq)) \
                    / (2 * eps_d)
                s_d = u["det_strength"] * dist_fade
                tinv = jax.lax.rsqrt(1.0 + (gdx * s_d) ** 2
                                     + (gdz * s_d) ** 2)
                tnx = -gdx * s_d * tinv
                tny = tinv
                tnz = -gdz * s_d * tinv
                # reoriented normal mapping for a y-up base frame
                qx, qy, qz = nx, ny + 1.0, nz
                qdot = qx * tnx + qy * tny + qz * tnz
                qy_safe = jnp.maximum(qy, 1e-4)
                bnx = qx * qdot / qy_safe - tnx
                bny = qy * qdot / qy_safe - tny
                bnz = qz * qdot / qy_safe - tnz
                binv = jax.lax.rsqrt(bnx * bnx + bny * bny + bnz * bnz)
                nx = bnx * binv
                ny = bny * binv
                nz = bnz * binv

            # --- albedo ---
            hn = jnp.clip((py_ - u["hmin"]) / jnp.maximum(u["hmax"] - u["hmin"], 1e-6), 0.0, 1.0)
            if curve_mode == "pow":
                hn = jnp.power(hn, u["height_curve_power"])
            elif curve_mode == "smoothstep":
                s = hn * hn * (3.0 - 2.0 * hn)
                hn = hn + (s - hn) * u["height_curve_strength"]
            if use_colormap:
                ar, ag, ab = colormaps.sample_lut_jnp(u["lut"], hn)
                cs = u["colormap_strength"]
                ar = ar * cs + u["constant_albedo"][0] * (1 - cs)
                ag = ag * cs + u["constant_albedo"][1] * (1 - cs)
                ab = ab * cs + u["constant_albedo"][2] * (1 - cs)
            else:
                ar = jnp.full((H, W), u["constant_albedo"][0])
                ag = jnp.full((H, W), u["constant_albedo"][1])
                ab = jnp.full((H, W), u["constant_albedo"][2])

            vt_fallback = jnp.zeros((), _F32)
            if vt_static is not None:
                # virtual-texture albedo resolve: desired mip from the
                # pixel footprint at the hit distance, page-table lookup,
                # atlas fetch; non-resident pages fall back to the
                # colormap/constant albedo and are counted (TESSELLA
                # evidence metric; ref terrain_pbr_pom.wgsl:1939-2283)
                levels, tiles, level_offs, page = vt_static
                L = len(levels)
                tiles_arr = jnp.asarray(tiles, jnp.int32)
                offs_arr = jnp.asarray(level_offs, jnp.int32)
                foot = t * u["vt_pix_angle"]
                des = jnp.log2(jnp.maximum(foot * u["vt_tpw0"], 1e-9))
                lvl = jnp.clip(jnp.round(des), levels[0], levels[-1])
                lvl_i = (lvl - levels[0]).astype(jnp.int32)
                ntl = jnp.take(tiles_arr, lvl_i)
                offs = jnp.take(offs_arr, lvl_i)
                ntl_f = ntl.astype(_F32)
                uu = jnp.clip(px_ * u["vt_inv_span"], 0.0, 0.9999990)
                vv = jnp.clip(pz_ * u["vt_inv_span"], 0.0, 0.9999990)
                gx = uu * ntl_f * page
                gz = vv * ntl_f * page
                tx = jnp.floor(uu * ntl_f).astype(jnp.int32)
                tz = jnp.floor(vv * ntl_f).astype(jnp.int32)
                tix = jnp.clip(gx - tx.astype(_F32) * page, 0,
                               page - 1).astype(jnp.int32)
                tiz = jnp.clip(gz - tz.astype(_F32) * page, 0,
                               page - 1).astype(jnp.int32)
                flat_tile = offs + tz * ntl + tx
                slot = jnp.take(u["vt_table"], flat_tile)
                addr = jnp.maximum(slot, 0) * (page * page) + tiz * page + tix
                var = jnp.take(u["vt_atlas"][:, 0], addr)
                vag = jnp.take(u["vt_atlas"][:, 1], addr)
                vab = jnp.take(u["vt_atlas"][:, 2], addr)
                resident = (slot >= 0) & hit.hit
                ar = jnp.where(resident, var, ar)
                ag = jnp.where(resident, vag, ag)
                ab = jnp.where(resident, vab, ab)
                vt_fallback = jnp.sum((hit.hit & ~resident).astype(_F32))

            if layers_on:
                snow = jnp.clip((hn - u["snow_h"]) / u["snow_blend"], 0.0, 1.0)
                # prefer snow on flatter ground
                snow = snow * jnp.clip((ny - 0.6) / 0.4, 0.0, 1.0)
                rock = jnp.clip((u["rock_cos"] - ny) / u["rock_blend"] + 1.0, 0.0, 1.0) * (ny < u["rock_cos"])
                ar = ar * (1 - rock) + u["rock_rgb"][0] * rock
                ag = ag * (1 - rock) + u["rock_rgb"][1] * rock
                ab = ab * (1 - rock) + u["rock_rgb"][2] * rock
                ar = ar * (1 - snow) + u["snow_rgb"][0] * snow
                ag = ag * (1 - snow) + u["snow_rgb"][1] * snow
                ab = ab * (1 - snow) + u["snow_rgb"][2] * snow

            if det_on:
                # albedo micro-variation from the (triplanar) detail field
                mod = 1.0 + u["det_strength"] * (detail - 0.5) * dist_fade
                ar = ar * mod
                ag = ag * mod
                ab = ab * mod

            # --- sun term ---
            sd = u["sun_dir"]
            ndl = jnp.maximum(nx * sd[0] + ny * sd[1] + nz * sd[2], 0.0)
            lc = u["lambert_contrast"]
            ndl = ndl + (ndl * ndl * (3.0 - 2.0 * ndl) - ndl) * lc

            vis = jnp.ones((H, W))
            if shadows_on:
                acc = jnp.zeros((H, W))
                sro = (px_ + nx * 1e-3 + sd[0] * u["shadow_bias"],
                       py_ + ny * 1e-3 + sd[1] * u["shadow_bias"],
                       pz_ + nz * 1e-3 + sd[2] * u["shadow_bias"])
                for s_i in range(shadow_samples):
                    if shadow_samples > 1:
                        st, u1 = xorshift32(st)
                        st, u2 = xorshift32(st)
                        # jitter sun dir in a cone of shadow_softness
                        ox_, oy_, oz_ = cosine_dir(sd[0], sd[1], sd[2], u1, u2)
                        soft = u["shadow_softness"]
                        jdx = sd[0] + (ox_ - sd[0]) * soft
                        jdy = sd[1] + (oy_ - sd[1]) * soft
                        jdz = sd[2] + (oz_ - sd[2]) * soft
                        jinv = jax.lax.rsqrt(jdx * jdx + jdy * jdy + jdz * jdz)
                        sdir = (jdx * jinv, jdy * jinv, jdz * jinv)
                    else:
                        sdir = (jnp.broadcast_to(sd[0], (H, W)),
                                jnp.broadcast_to(sd[1], (H, W)),
                                jnp.broadcast_to(sd[2], (H, W)))
                    occ = trace(scene, static, sro, sdir).hit
                    acc = acc + jnp.where(occ, 0.0, 1.0)
                vis = acc / shadow_samples
                vis = 1.0 - u["shadow_intensity"] * (1.0 - vis)

            if clouds_on:
                vis = vis * cloud_shadow(u, px_, pz_)

            # --- ambient / AO / IBL ---
            ao = jnp.ones((H, W))
            if ao_on:
                occf = jnp.zeros((H, W))
                for s_i in range(ao_samples):
                    st, u1 = xorshift32(st)
                    st, u2 = xorshift32(st)
                    adx, ady, adz = cosine_dir(nx, ny, nz, u1, u2)
                    aro = (px_ + nx * 1e-3, py_ + ny * 1e-3, pz_ + nz * 1e-3)
                    occ = trace(scene, static, aro, (adx, ady, adz),
                                tmax=u["ao_radius"]).hit
                    occf = occf + jnp.where(occ, 1.0, 0.0)
                ao = 1.0 - u["ao_strength"] * occf / ao_samples
            ao_mix = 1.0 + (ao - 1.0) * jnp.maximum(u["ao_weight"], ao_on * 1.0)

            er, eg, eb = env_sample(u, nx, ny, nz)
            amb_r = u["ambient_rgb"][0] + er
            amb_g = u["ambient_rgb"][1] + eg
            amb_b = u["ambient_rgb"][2] + eb

            lit = ndl * vis
            r = ar * (u["sun_rgb"][0] * lit + amb_r * ao_mix)
            g = ag * (u["sun_rgb"][1] * lit + amb_g * ao_mix)
            b = ab * (u["sun_rgb"][2] * lit + amb_b * ao_mix)

            # --- water plane ---
            if water_on:
                twp = (u["water_level"] - oy) / jnp.where(jnp.abs(dy) > 1e-7, dy, 1e-7)
                water_first = (twp > 0) & (twp < t)
                wx = ox + twp * dx
                wz = oz + twp * dz
                # fresnel with view angle
                cosv = jnp.clip(-dy, 0.0, 1.0)
                fres = 0.02 + 0.98 * jnp.power(1.0 - cosv, 5.0)
                skyr, skyg, skyb = env_sample(u, dx, jnp.abs(dy), dz)
                refl = u["water_reflectivity"]
                if wrefl_on:
                    # TRUE planar reflection: reflect the view ray at the
                    # water plane and trace the terrain again (the ray
                    # engine replaces the reference's reflection sample/
                    # Fresnel/blend pass, terrain_pbr_pom.wgsl:852-941);
                    # sky fills reflected misses.
                    rro = (wx, jnp.full((H, W), u["water_level"] + 1e-3),
                           wz)
                    rdy = jnp.abs(dy)
                    rhit = trace(scene, static, rro, (dx, rdy, dz))
                    rpx = wx + rhit.t * dx
                    rpy = u["water_level"] + rhit.t * rdy
                    rpz = wz + rhit.t * dz
                    rnx, rny, rnz = normal_at(scene, static,
                                              (rpx, rpy, rpz),
                                              rhit.cell_x, rhit.cell_z)
                    rhn = jnp.clip((rpy - u["hmin"])
                                   / jnp.maximum(u["hmax"] - u["hmin"],
                                                 1e-6), 0.0, 1.0)
                    if use_colormap:
                        rar, rag, rab = colormaps.sample_lut_jnp(u["lut"],
                                                                 rhn)
                    else:
                        rar = jnp.full((H, W), u["constant_albedo"][0])
                        rag = jnp.full((H, W), u["constant_albedo"][1])
                        rab = jnp.full((H, W), u["constant_albedo"][2])
                    rndl = jnp.maximum(rnx * sd[0] + rny * sd[1]
                                       + rnz * sd[2], 0.0)
                    ri = u["refl_intensity"]
                    trr = rar * (u["sun_rgb"][0] * rndl + u["ambient_rgb"][0])
                    trg = rag * (u["sun_rgb"][1] * rndl + u["ambient_rgb"][1])
                    trb = rab * (u["sun_rgb"][2] * rndl + u["ambient_rgb"][2])
                    skyr = jnp.where(rhit.hit, trr * ri, skyr)
                    skyg = jnp.where(rhit.hit, trg * ri, skyg)
                    skyb = jnp.where(rhit.hit, trb * ri, skyb)
                wr = u["water_rgb"][0] * (1 - fres) + skyr * fres * refl * 4.0
                wg = u["water_rgb"][1] * (1 - fres) + skyg * fres * refl * 4.0
                wb = u["water_rgb"][2] * (1 - fres) + skyb * fres * refl * 4.0
                sun_glint = jnp.power(jnp.maximum(
                    dx * sd[0] + jnp.abs(dy) * sd[1] + dz * sd[2], 0.0), 64.0)
                wr = wr + sun_glint * u["sun_rgb"][0] * refl
                wg = wg + sun_glint * u["sun_rgb"][1] * refl
                wb = wb + sun_glint * u["sun_rgb"][2] * refl
                r = jnp.where(water_first, wr, r)
                g = jnp.where(water_first, wg, g)
                b = jnp.where(water_first, wb, b)
                t = jnp.where(water_first, twp, t)
                hit_any = hit.hit | water_first
            else:
                hit_any = hit.hit

            # --- fog ---
            if fog_on:
                d = jnp.maximum(t - u["fog_start"], 0.0)
                dens = u["fog_density"] * jnp.exp(-u["fog_falloff"] * jnp.maximum(py_, 0.0))
                fogf = 1.0 - jnp.exp(-dens * d)
                r = r + (u["fog_rgb"][0] - r) * fogf
                g = g + (u["fog_rgb"][1] - g) * fogf
                b = b + (u["fog_rgb"][2] - b) * fogf

            # --- sky ---
            sr, sg, sb = sky_rgb(u, dy)
            r = jnp.where(hit_any, r, sr)
            g = jnp.where(hit_any, g, sg)
            b = jnp.where(hit_any, b, sb)
            return (r, g, b), st, {"hit": hit, "t": t,
                                    "n": (nx, ny, nz),
                                    "albedo": (ar, ag, ab),
                                    "vt_fallback": vt_fallback}

        return shade

    def _build_program(self, p: TerrainRenderParams, static, W, H, has_env,
                       has_water_mask, vt_static=None):
        aa = int(p.sampling.aa_samples)
        tonemap_mode = p.tonemap.mode
        srgb_out = bool(p.output_srgb_eotf)
        debug_mode = p.debug_mode
        shade = self._make_shade(p, static, W, H, has_env, has_water_mask,
                                 vt_static)

        def program(scene, u):
            xs = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 1)
            ys = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 0)
            st = seed_state(u["aa_seed"], 0x9E3779B9, xs, ys, 0)
            racc = jnp.zeros((H, W))
            gacc = jnp.zeros((H, W))
            bacc = jnp.zeros((H, W))
            aux = None
            for s_i in range(aa):
                if aa > 1:
                    st, u1 = xorshift32(st)
                    st, u2 = xorshift32(st)
                    jx = u1 - 0.5
                    jy = u2 - 0.5
                else:
                    jx = jnp.zeros((H, W))
                    jy = jnp.zeros((H, W))
                (r, g, b), st, aux_s = shade(scene, u, jx, jy, st)
                if s_i == 0:
                    aux = aux_s
                racc += r
                gacc += g
                bacc += b
            r = racc / aa
            g = gacc / aa
            b = bacc / aa
            hdr = jnp.stack([r, g, b], axis=-1)

            if debug_mode == "normals":
                nx, ny, nz = aux["n"]
                ldr = jnp.stack([nx, ny, nz], -1) * 0.5 + 0.5
            else:
                if tonemap_mode == "off":
                    ldr = jnp.clip(hdr * u["exposure"], 0.0, 1.0)
                elif tonemap_mode == "reinhard_extended":
                    ldr = tm.reinhard_extended(hdr, u["exposure"], u["white_point"])
                else:
                    ldr = tm.apply(tonemap_mode, hdr, exposure=u["exposure"])
                if srgb_out:
                    ldr = tm.srgb_eotf_inv(ldr)
                else:
                    ldr = jnp.power(jnp.clip(ldr, 0.0, 1.0), u["inv_gamma"])

            hit = aux["hit"]
            t = aux["t"]
            nx, ny, nz = aux["n"]
            ar, ag, ab = aux["albedo"]
            return {
                "vt_fallback": aux["vt_fallback"],
                "ldr": ldr,
                "hdr": hdr,
                "albedo": jnp.stack([ar, ag, ab], -1) * hit.hit[..., None],
                "normal": jnp.stack([nx, ny, nz], -1) * hit.hit[..., None],
                "depth": jnp.where(hit.hit, t, jnp.nan),
                "visibility": jnp.where(hit.hit, 1.0, 0.0),
            }

        return program

    # ------------------------------------------------------------------
    # Offline progressive accumulation (reference: TV12 pipeline,
    # src/terrain/renderer/offline.rs:81-2131 — begin/accumulate_batch/
    # read_accumulation_metrics/resolve/tonemap/end; per-sample projection
    # jitter accumulates into an RGBA32F buffer, tile-luminance metrics
    # drive convergence).
    # ------------------------------------------------------------------

    _TILE = 32  # metric tile size in pixels

    def offline_session_active(self) -> bool:
        return getattr(self, "_offline", None) is not None

    def begin_offline_accumulation(self, material_set=None, env_maps=None,
                                   params=None, heightmap=None,
                                   water_mask=None) -> None:
        if self.offline_session_active():
            raise RenderError("an offline accumulation session is already active")
        if heightmap is None:
            raise UploadError("heightmap is required")
        p = params if params is not None else make_terrain_params()
        p.validate()
        envw: IBL = env_maps if env_maps is not None else IBL.default()
        hm = np.asarray(heightmap, np.float32)
        W = max(1, int(round(p.size_px[0] * p.render_scale)))
        H = max(1, int(round(p.size_px[1] * p.render_scale)))
        span = p.terrain_span if p.terrain_span > 0 else float(hm.shape[1] - 1)
        scene, static, spacing, hmin, hmax, _ = self._scene_for(hm, span, p.z_scale)
        has_env = p.ibl.enabled and (p.ibl.env_map is not None or envw.env_map is not None)
        uni = self._uniforms(p, hm, span, hmin, hmax, W, H, 0.0)
        if has_env:
            uni["env_rgb"] = jnp.asarray(
                p.ibl.env_map if p.ibl.env_map is not None else envw.env_map, _F32
            )

        shade = self._make_shade(p, static, W, H, has_env, False)
        tile = self._TILE
        th = (H + tile - 1) // tile
        tw = (W + tile - 1) // tile

        def tile_means(lum):
            pad_h = th * tile - H
            pad_w = tw * tile - W
            lp = jnp.pad(lum, ((0, pad_h), (0, pad_w)), mode="edge")
            return lp.reshape(th, tile, tw, tile).mean(axis=(1, 3))

        def step(scene, u, accum, sample_idx):
            xs = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 1)
            ys = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 0)
            st = seed_state(u["aa_seed"], 0x85EBCA6B, xs, ys, 0) ^ (
                jnp.uint32(sample_idx) * jnp.uint32(92837111)
            )
            st, u1 = xorshift32(st)
            st, u2 = xorshift32(st)
            (r, g, b), st, aux = shade(scene, u, u1 - 0.5, u2 - 0.5, st)
            accum = accum + jnp.stack([r, g, b, jnp.ones_like(r)], axis=-1)
            mean = accum[..., :3] / accum[..., 3:4]
            lum = luminance(mean[..., 0], mean[..., 1], mean[..., 2])
            return accum, tile_means(lum), aux

        self._offline = {
            "params": p, "scene": scene, "static": static, "uni": uni,
            "W": W, "H": H,
            "accum": jnp.zeros((H, W, 4), _F32),
            "tiles": np.zeros((th, tw), np.float32),
            "step": jax.jit(step, donate_argnums=(2,)),
            "samples": 0,
            "last_metrics": None,
            "aux": None,
            "threshold": 1e-3,
        }
        global_tracker().track("offline.accum", H * W * 16, "buffer")

    def accumulate_batch(self, n_samples: int):
        sess = getattr(self, "_offline", None)
        if sess is None:
            raise RenderError("no offline accumulation session is active")
        if n_samples <= 0:
            raise ValueError("n_samples must be >= 1")
        accum = sess["accum"]
        tiles = sess["tiles"]
        aux = sess["aux"]
        for i in range(int(n_samples)):
            accum, new_tiles, aux = sess["step"](
                sess["scene"], sess["uni"], accum, jnp.uint32(sess["samples"])
            )
            sess["samples"] += 1
        new_tiles = np.asarray(new_tiles)
        delta = np.abs(new_tiles - tiles)
        sess["accum"] = accum
        sess["tiles"] = new_tiles
        sess["aux"] = aux
        thr = sess["threshold"]
        sess["last_metrics"] = {
            "total_samples": sess["samples"],
            "mean_delta": float(delta.mean()),
            "p95_delta": float(np.percentile(delta, 95)),
            "max_tile_delta": float(delta.max()),
            "converged_tile_ratio": float((delta < thr).mean()),
        }
        return dict(sess["last_metrics"])

    def read_accumulation_metrics(self, convergence_threshold: float = 1e-3):
        sess = getattr(self, "_offline", None)
        if sess is None:
            raise RenderError("no offline accumulation session is active")
        sess["threshold"] = float(convergence_threshold)
        if sess["last_metrics"] is None:
            return {
                "total_samples": 0, "mean_delta": float("inf"),
                "p95_delta": float("inf"), "max_tile_delta": float("inf"),
                "converged_tile_ratio": 0.0,
            }
        return dict(sess["last_metrics"])

    def resolve_offline_hdr(self):
        sess = getattr(self, "_offline", None)
        if sess is None:
            raise RenderError("no offline accumulation session is active")
        if sess["samples"] == 0:
            raise RenderError("no samples accumulated")
        accum = np.asarray(sess["accum"])
        hdr = accum[..., :3] / accum[..., 3:4]
        aux = sess["aux"]
        hit = aux["hit"]
        t = aux["t"]
        nx, ny, nz = aux["n"]
        ar, ag, ab = aux["albedo"]
        hitm = np.asarray(hit.hit)[..., None]
        aov = AovFrame(
            aovs={
                "albedo": np.stack([np.asarray(ar), np.asarray(ag), np.asarray(ab)], -1) * hitm,
                "normal": np.stack([np.asarray(nx), np.asarray(ny), np.asarray(nz)], -1) * hitm,
                "depth": np.where(hitm[..., 0], np.asarray(t), np.nan).astype(np.float32),
                "visibility": hitm[..., 0].astype(np.float32),
            },
            metadata={"samples": sess["samples"]},
        )
        return HdrFrame(rgb=hdr.astype(np.float32),
                        metadata={"samples": sess["samples"]}), aov

    def tonemap_offline_hdr(self, hdr_frame: HdrFrame) -> Frame:
        sess = getattr(self, "_offline", None)
        p = sess["params"] if sess else make_terrain_params()
        ldr = tm.apply(
            p.tonemap.mode if p.tonemap.mode != "off" else "reinhard",
            jnp.asarray(hdr_frame.rgb),
            exposure=p.tonemap.exposure * p.exposure,
        )
        if p.output_srgb_eotf:
            ldr = tm.srgb_eotf_inv(ldr)
        else:
            ldr = jnp.power(jnp.clip(ldr, 0.0, 1.0), 1.0 / p.gamma)
        ldr = np.asarray(ldr)
        rgba = np.concatenate(
            [
                (np.clip(ldr, 0, 1) * 255 + 0.5).astype(np.uint8),
                np.full((*ldr.shape[:2], 1), 255, np.uint8),
            ],
            axis=-1,
        )
        return Frame(rgba=rgba, metadata=dict(hdr_frame.metadata))

    def end_offline_accumulation(self) -> None:
        self._offline = None
