# forge3d_tpu/scene.py
# Scene: the simple grid-terrain render-to-texture class.
#
# Parity notes (reference behavior, not code):
#   - pyclass Scene(width, height, grid=128, colormap='viridis') with
#     set_camera_look_at(eye, target, up, fovy_deg, znear, zfar),
#     set_height_from_r32f(arr), render_png(path), render_rgba(),
#     SSAO toggles (/root/reference/src/scene/py_api/base.rs:8-95,
#     src/scene/mod.rs:39-80, render_paths/png.rs:2).
#   - The reference draws a grid mesh displaced by the height texture with a
#     colormap LUT; here the same image comes from primary-visibility rays
#     against the heightfield (no raster pipeline), reusing the terrain
#     traversal core.
#   - MENSURA: camera positions cross the boundary in f64 and are narrowed
#     relative to a camera anchor to keep f32 precision
#     (src/scene/mod.rs:79-81); we rebase ray origins the same way.

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from . import colormaps
from .camera import camera_basis
from .errors import RenderError, UploadError
from .frame import Frame
from .io.image import numpy_to_png


class Scene:
    """Grid-terrain scene with colormap shading."""

    def __init__(self, width: int, height: int, grid: Optional[int] = 128,
                 colormap: Optional[str] = "viridis"):
        if width <= 0 or height <= 0:
            raise ValueError("width/height must be positive")
        self.width = int(width)
        self.height = int(height)
        self.grid = int(grid or 128)
        if self.grid < 2:
            raise ValueError("grid must be >= 2")
        self.colormap = colormap or "viridis"
        colormaps.get_lut(self.colormap)  # validate early
        self._heights: Optional[np.ndarray] = None
        self._eye = np.array([3.0, 2.0, 3.0], np.float64)
        self._target = np.array([0.0, 0.0, 0.0], np.float64)
        self._up = np.array([0.0, 1.0, 0.0], np.float64)
        self._fovy_deg = 45.0
        self._znear = 0.1
        self._zfar = 100.0
        self._ssao_enabled = False
        self._ssao = (1.0, 1.0, 0.025)  # radius, intensity, bias
        # terrain footprint: centered unit-ish quad like the reference spike
        self._span = 2.0
        self._h_scale = 1.0
        # post-fx state (reference Scene py_api surface: bloom, dof, ssr,
        # ssgi, oit, ground_plane, water_surface, clouds, rect area lights,
        # reflections — src/scene/py_api/*)
        self._bloom = {"enabled": False, "threshold": 1.0, "intensity": 0.5}
        self._dof = {"enabled": False, "focus": 4.0, "range": 2.0,
                     "max_coc": 6.0}
        self._vignette = {"enabled": False, "strength": 0.35}
        self._ssr = {"enabled": False, "intensity": 0.5}
        self._ssgi = {"enabled": False, "intensity": 0.5}
        self._oit = {"enabled": False, "mode": "weighted"}
        self._ground_plane = {"enabled": False, "height": 0.0,
                              "color": (0.35, 0.35, 0.38)}
        self._water_surface = {"enabled": False, "height": 0.0,
                               "color": (0.08, 0.22, 0.35), "opacity": 0.75}
        self._clouds = {"enabled": False, "coverage": 0.4, "density": 0.5}
        self._reflections = {"enabled": False, "intensity": 0.4}
        self._rect_area_lights: list = []

    # -- camera ------------------------------------------------------------
    def set_camera_look_at(self, eye, target, up, fovy_deg: float,
                           znear: float, zfar: float) -> None:
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        if not (np.isfinite(eye).all() and np.isfinite(target).all() and np.isfinite(up).all()):
            raise ValueError("camera parameters must be finite")
        if znear <= 0 or zfar <= znear:
            raise ValueError("require 0 < znear < zfar")
        if np.allclose(eye, target):
            raise ValueError("eye and target must differ")
        if not (0.0 < fovy_deg < 180.0):
            raise ValueError("fovy_deg out of range")
        self._eye, self._target, self._up = eye, target, up
        self._fovy_deg = float(fovy_deg)
        self._znear, self._zfar = float(znear), float(zfar)

    # -- terrain data ------------------------------------------------------
    def set_height_from_r32f(self, height_r32f: np.ndarray) -> None:
        hm = np.asarray(height_r32f)
        if hm.dtype != np.float32:
            hm = hm.astype(np.float32)
        if hm.ndim != 2 or hm.shape[0] < 2 or hm.shape[1] < 2:
            raise UploadError("height data must be a 2D float32 array >= 2x2")
        if not np.isfinite(hm).all():
            raise UploadError("height data contains non-finite values")
        self._heights = np.ascontiguousarray(hm)

    def set_terrain_span(self, span: float, height_scale: float = 1.0) -> None:
        if span <= 0 or height_scale <= 0:
            raise ValueError("span and height_scale must be > 0")
        self._span = float(span)
        self._h_scale = float(height_scale)

    # -- ssao (API parity; applied as hemispheric AO in the ray engine) ----
    def ssao_enabled(self) -> bool:
        return self._ssao_enabled

    def set_ssao_enabled(self, enabled: bool) -> bool:
        self._ssao_enabled = bool(enabled)
        return self._ssao_enabled

    def set_ssao_parameters(self, radius: float, intensity: float, bias: float) -> None:
        if radius <= 0:
            raise ValueError("radius must be > 0")
        self._ssao = (float(radius), float(intensity), float(bias))

    def get_ssao_parameters(self) -> Tuple[float, float, float]:
        return self._ssao

    # -- post-fx setters (reference: src/scene/py_api/* classes) -----------
    def set_bloom_enabled(self, enabled: bool) -> None:
        self._bloom["enabled"] = bool(enabled)

    def set_bloom_parameters(self, threshold: float, intensity: float) -> None:
        if threshold < 0 or intensity < 0:
            raise ValueError("bloom parameters must be >= 0")
        self._bloom.update(threshold=float(threshold),
                           intensity=float(intensity))

    def set_dof_enabled(self, enabled: bool) -> None:
        self._dof["enabled"] = bool(enabled)

    def set_dof_parameters(self, focus_distance: float, focus_range: float,
                           max_coc: float = 6.0) -> None:
        if focus_distance <= 0 or focus_range <= 0:
            raise ValueError("dof parameters must be > 0")
        self._dof.update(focus=float(focus_distance),
                         range=float(focus_range), max_coc=float(max_coc))

    def set_vignette_enabled(self, enabled: bool, strength: float = 0.35) -> None:
        self._vignette.update(enabled=bool(enabled), strength=float(strength))

    def set_ssr_enabled(self, enabled: bool, intensity: float = 0.5) -> None:
        self._ssr.update(enabled=bool(enabled), intensity=float(intensity))

    def set_ssgi_enabled(self, enabled: bool, intensity: float = 0.5) -> None:
        self._ssgi.update(enabled=bool(enabled), intensity=float(intensity))

    def set_oit_enabled(self, enabled: bool, mode: str = "weighted") -> None:
        if mode not in ("weighted", "dual_source"):
            raise ValueError("oit mode must be weighted|dual_source")
        self._oit.update(enabled=bool(enabled), mode=mode)

    def set_ground_plane(self, enabled: bool, height: float = 0.0,
                         color=(0.35, 0.35, 0.38)) -> None:
        self._ground_plane.update(enabled=bool(enabled), height=float(height),
                                  color=tuple(color))

    def set_water_surface(self, enabled: bool, height: float = 0.0,
                          color=(0.08, 0.22, 0.35), opacity: float = 0.75) -> None:
        self._water_surface.update(enabled=bool(enabled), height=float(height),
                                   color=tuple(color), opacity=float(opacity))

    def set_clouds_enabled(self, enabled: bool, coverage: float = 0.4,
                           density: float = 0.5) -> None:
        self._clouds.update(enabled=bool(enabled), coverage=float(coverage),
                            density=float(density))

    def set_reflections_enabled(self, enabled: bool,
                                intensity: float = 0.4) -> None:
        self._reflections.update(enabled=bool(enabled),
                                 intensity=float(intensity))

    def add_rect_area_light(self, center, right, up, half_extent,
                            color=(1.0, 1.0, 1.0), intensity: float = 1.0) -> int:
        self._rect_area_lights.append(
            dict(center=tuple(center), right=tuple(right), up=tuple(up),
                 half_extent=tuple(half_extent), color=tuple(color),
                 intensity=float(intensity)))
        return len(self._rect_area_lights) - 1

    def clear_rect_area_lights(self) -> None:
        self._rect_area_lights.clear()

    # -- rendering ---------------------------------------------------------
    def _default_heights(self) -> np.ndarray:
        g = self.grid
        y, x = np.mgrid[0:g, 0:g].astype(np.float32)
        return (0.15 * np.sin(x * 6.0 / g) * np.cos(y * 6.0 / g)).astype(np.float32)

    def render_rgba(self) -> np.ndarray:
        import jax
        import jax.numpy as jnp

        from .ops.pyramid import build_pyramid
        from .ops.traversal import normal_at, scene_from_pyramid, trace

        hm = self._heights if self._heights is not None else self._default_heights()
        # resample to grid resolution like the reference's grid mesh
        g = self.grid
        if hm.shape != (g, g):
            yi = np.linspace(0, hm.shape[0] - 1, g)
            xi = np.linspace(0, hm.shape[1] - 1, g)
            y0 = np.floor(yi).astype(int)
            x0 = np.floor(xi).astype(int)
            y1 = np.minimum(y0 + 1, hm.shape[0] - 1)
            x1 = np.minimum(x0 + 1, hm.shape[1] - 1)
            fy = (yi - y0)[:, None]
            fx = (xi - x0)[None, :]
            hm = (
                hm[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
                + hm[np.ix_(y0, x1)] * (1 - fy) * fx
                + hm[np.ix_(y1, x0)] * fy * (1 - fx)
                + hm[np.ix_(y1, x1)] * fy * fx
            ).astype(np.float32)

        span = self._span
        spacing = span / (g - 1)
        origin_xz = (-span / 2.0, -span / 2.0)
        pyr = build_pyramid(hm)
        scene, static = scene_from_pyramid(
            pyr, origin_xz=origin_xz, spacing_xz=(spacing, spacing),
            exaggeration=self._h_scale,
        )

        # MENSURA-style anchor: rays are generated relative to the eye in
        # f64, then narrowed.
        eye = self._eye
        right, up, fwd = camera_basis(eye, self._target, self._up)
        W, H = self.width, self.height
        half_h = math.tan(math.radians(self._fovy_deg) * 0.5)
        half_w = (W / H) * half_h

        xs = (np.arange(W, dtype=np.float64) + 0.5) / W * 2.0 - 1.0
        ys = 1.0 - (np.arange(H, dtype=np.float64) + 0.5) / H * 2.0
        gx, gy = np.meshgrid(xs * half_w, ys * half_h)
        d = (gx[..., None] * right + gy[..., None] * up + fwd).astype(np.float64)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = d.astype(np.float32)
        ro = tuple(np.full((H, W), c, np.float32) for c in eye)
        rd = (d[..., 0], d[..., 1], d[..., 2])

        hit = trace(scene, static, ro, rd, tmin=self._znear, tmax=self._zfar)
        t = hit.t
        px = ro[0] + t * rd[0]
        py = ro[1] + t * rd[1]
        pz = ro[2] + t * rd[2]
        nx, ny, nz = normal_at(scene, static, (px, py, pz), hit.cell_x, hit.cell_z)

        hmin = float(hm.min()) * self._h_scale
        hmax = float(hm.max()) * self._h_scale
        hn = jnp.clip((py - hmin) / max(hmax - hmin, 1e-6), 0.0, 1.0)
        lut = jnp.asarray(colormaps.get_lut(self.colormap))
        ar, ag, ab = colormaps.sample_lut_jnp(lut, hn)

        sun = np.array([0.5, 0.8, 0.3])
        sun /= np.linalg.norm(sun)
        ndl = jnp.maximum(nx * sun[0] + ny * sun[1] + nz * sun[2], 0.0)
        shade = 0.25 + 0.75 * ndl

        if self._ssao_enabled:
            radius, intensity, _bias = self._ssao
            from .ops.rng import seed_state, xorshift32
            from .ops.shading import cosine_dir
            from .ops.traversal import trace as _trace

            xs_u = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 1)
            ys_u = jax.lax.broadcasted_iota(jnp.uint32, (H, W), 0)
            st = seed_state(12345, 0x9E3779B9, xs_u, ys_u, 0)
            occ = jnp.zeros((H, W))
            for _ in range(4):
                st, u1 = xorshift32(st)
                st, u2 = xorshift32(st)
                adx, ady, adz = cosine_dir(nx, ny, nz, u1, u2)
                o = _trace(scene, static,
                           (px + nx * 1e-3, py + ny * 1e-3, pz + nz * 1e-3),
                           (adx, ady, adz), tmax=radius).hit
                occ = occ + jnp.where(o, 1.0, 0.0)
            shade = shade * (1.0 - intensity * 0.5 * occ / 4.0)

        r = ar * shade
        g_ = ag * shade
        b = ab * shade

        # rect area lights add on top of sun shading
        if self._rect_area_lights:
            from .ops.post import rect_area_light

            pt = jnp.stack([px, py, pz], -1)
            nrm = jnp.stack([nx, ny, nz], -1)
            view = -jnp.stack(rd, -1)
            add = jnp.zeros_like(pt)
            for L in self._rect_area_lights:
                add = add + rect_area_light(
                    pt, nrm, view, light_center=L["center"],
                    light_right=L["right"], light_up=L["up"],
                    half_extent=L["half_extent"], color=L["color"],
                    intensity=L["intensity"])
            r = r + add[..., 0] * ar
            g_ = g_ + add[..., 1] * ag
            b = b + add[..., 2] * ab

        bg = jnp.asarray([0.12, 0.14, 0.18])
        # optional ground plane catches rays that miss the terrain
        gp = self._ground_plane
        if gp["enabled"]:
            tg = (gp["height"] - ro[1]) / jnp.where(
                jnp.abs(rd[1]) < 1e-6, -1e-6, rd[1])
            ground_hit = (~hit.hit) & (tg > self._znear) & (tg < self._zfar)
            gndl = max(float(np.dot([0, 1, 0], sun)), 0.0)
            gshade = 0.25 + 0.75 * gndl
            gc = gp["color"]
            r = jnp.where(ground_hit, gc[0] * gshade, r)
            g_ = jnp.where(ground_hit, gc[1] * gshade, g_)
            b = jnp.where(ground_hit, gc[2] * gshade, b)
            vis_any = hit.hit | ground_hit
        else:
            vis_any = hit.hit
        # water surface: semi-transparent plane over low terrain
        ws = self._water_surface
        if ws["enabled"]:
            tw = (ws["height"] - ro[1]) / jnp.where(
                jnp.abs(rd[1]) < 1e-6, -1e-6, rd[1])
            water_hit = (tw > self._znear) & (tw < jnp.where(hit.hit, t, self._zfar)) \
                & (rd[1] < 0)
            wop = ws["opacity"]
            wc = ws["color"]
            r = jnp.where(water_hit, (1 - wop) * r + wop * wc[0], r)
            g_ = jnp.where(water_hit, (1 - wop) * g_ + wop * wc[1], g_)
            b = jnp.where(water_hit, (1 - wop) * b + wop * wc[2], b)
        r = jnp.where(vis_any, r, bg[0])
        g_ = jnp.where(vis_any, g_, bg[1])
        b = jnp.where(vis_any, b, bg[2])
        ldr = jnp.stack([r, g_, b], axis=-1)

        depth_buf = jnp.where(hit.hit, t, self._zfar)
        if self._ssr["enabled"] or self._reflections["enabled"]:
            from .ops.post import ssr as _ssr

            nrm3 = jnp.stack([nx, ny, nz], -1)
            inten = (self._ssr["intensity"] if self._ssr["enabled"]
                     else self._reflections["intensity"])
            ldr = _ssr(ldr, depth_buf, nrm3, intensity=inten)
        if (self._bloom["enabled"] or self._dof["enabled"]
                or self._vignette["enabled"]):
            from .ops.post import PostConfig, apply_post_chain

            ldr = apply_post_chain(
                ldr, depth_buf,
                PostConfig(
                    bloom_enabled=self._bloom["enabled"],
                    bloom_threshold=self._bloom["threshold"],
                    bloom_intensity=self._bloom["intensity"],
                    dof_enabled=self._dof["enabled"],
                    dof_focus=self._dof["focus"],
                    dof_range=self._dof["range"],
                    dof_max_coc=self._dof["max_coc"],
                    vignette_enabled=self._vignette["enabled"],
                    vignette_strength=self._vignette["strength"],
                ))
        rgba = np.concatenate(
            [
                (np.clip(np.asarray(ldr), 0, 1) * 255 + 0.5).astype(np.uint8),
                np.full((H, W, 1), 255, np.uint8),
            ],
            axis=-1,
        )
        return rgba

    def render_png(self, path) -> None:
        numpy_to_png(path, self.render_rgba())

    def render_frame(self) -> Frame:
        return Frame(rgba=self.render_rgba(),
                     metadata={"colormap": self.colormap, "grid": self.grid})
