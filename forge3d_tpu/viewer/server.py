# forge3d_tpu/viewer/server.py
# Headless interactive viewer: TCP JSON-IPC server around the JAX render
# engine.
#
# Parity notes (reference behavior, not code): /root/reference/src/viewer/
# runs a winit window + TCP JSON IPC server that prints
# "FORGE3D_VIEWER_READY port=N" on stdout and accepts one JSON object per
# command with a snake_case `cmd` tag (ipc/server.rs,
# ipc/protocol/request.rs:19-142 — 78 request variants, SURVEY §A.5);
# the Python client connects a socket per command. Design: the
# viewer is headless-first (every reference test drives it by IPC);
# interactive rendering happens through the same JAX engine at reduced
# sample counts, and `snapshot` re-renders offscreen at the requested size.

from __future__ import annotations

import json
import math
import socket
import sys
import threading
import traceback
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["ViewerServer", "main"]

READY_PREFIX = "FORGE3D_VIEWER_READY port="


class _ViewerState:
    """All mutable viewer state; plain data, snapshot reads it."""

    def __init__(self) -> None:
        self.width = 1024
        self.height = 768
        self.terrain: Optional[np.ndarray] = None
        self.terrain_span: float = 0.0
        self.z_scale: float = 1.0
        # orbit camera
        self.cam = {"target": [0.0, 0.0, 0.0], "radius": 150.0,
                    "phi_deg": 225.0, "theta_deg": 35.0, "fov_y_deg": 45.0}
        self.sun = {"azimuth_deg": 135.0, "elevation_deg": 45.0,
                    "intensity": 3.0}
        self.ibl = {"enabled": True, "intensity": 0.35}
        self.exposure = 1.0
        self.colormap = "terrain"
        self.meshes: Dict[str, Any] = {}          # name -> MeshData
        self.pointcloud: Optional[np.ndarray] = None
        self.pointcloud_params = {"point_size": 2.0, "edl": False}
        self.labels: Dict[int, dict] = {}
        self.next_label_id = 1
        self.labels_enabled = True
        self.max_visible_labels: Optional[int] = None
        self.declutter_algorithm = "greedy"
        self.label_typography = {"size": 16.0, "tracking": 0.0,
                                 "halo_width": 1.5}
        self.label_zoom = 1.0
        self.callouts: Dict[int, dict] = {}
        self.overlays: Dict[str, dict] = {}       # raster overlays
        self.vector_overlays: Dict[str, dict] = {}
        self.overlays_enabled = True
        self.vector_overlays_enabled = True
        self.global_overlay_opacity = 1.0
        self.global_vector_overlay_opacity = 1.0
        self.taa = {"enabled": False, "blend": 0.1, "sharpen": 0.0}
        self.oit = {"enabled": False, "mode": "weighted"}
        self.lasso_mode = False
        self.lasso_points: list = []
        self.selection: set = set()
        self.scene_variants: Dict[str, dict] = {}
        self.active_scene_variant: Optional[str] = None
        self.review_layers: Dict[str, bool] = {}
        self.scene_review_state: dict = {}
        self.observation: dict = {}
        self.terrain_pbr: dict = {}
        self.terrain_scatter: Optional[dict] = None
        self.transforms: Dict[str, list] = {}
        self.pick_events: list = []
        self.pending_bundle_load: Optional[dict] = None
        self.pending_bundle_save: Optional[dict] = None
        self.volumetrics: dict = {}
        self.denoise: dict = {}
        self.stats = {"frames_rendered": 0, "snapshots": 0}


def _require(req: dict, *keys: str) -> list:
    missing = [k for k in keys if k not in req]
    if missing:
        raise ValueError(f"missing field(s): {', '.join(missing)}")
    return [req[k] for k in keys]


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.state = _ViewerState()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._closing = threading.Event()
        self._renderer = None
        self._render_lock = threading.Lock()

    # ------------------------------------------------------------------ run
    def announce(self) -> None:
        print(f"{READY_PREFIX}{self.port}", flush=True)

    def serve_forever(self) -> None:
        self._sock.settimeout(0.5)
        while not self._closing.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()
        self._sock.close()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            buf = b""
            conn.settimeout(30.0)
            while not self._closing.is_set():
                try:
                    chunk = conn.recv(1 << 20)
                except (socket.timeout, OSError):
                    return
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    resp = self.handle_json(line.decode("utf-8"))
                    try:
                        conn.sendall(json.dumps(resp).encode() + b"\n")
                    except OSError:
                        return

    # ------------------------------------------------------------- dispatch
    def handle_json(self, raw: str) -> dict:
        try:
            req = json.loads(raw)
        except json.JSONDecodeError as e:
            return {"ok": False, "error": f"bad json: {e}"}
        cmd = req.get("cmd")
        if not isinstance(cmd, str):
            return {"ok": False, "error": "missing cmd"}
        handler = getattr(self, f"_cmd_{cmd}", None)
        if handler is None:
            return {"ok": False, "error": f"unknown cmd: {cmd}"}
        try:
            out = handler(req)
            resp = {"ok": True}
            if out:
                resp.update(out)
            return resp
        except Exception as e:  # noqa: BLE001 — report to client, keep serving
            traceback.print_exc()
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # ------------------------------------------------------------ rendering
    def _get_renderer(self):
        if self._renderer is None:
            from ..terrain.renderer import TerrainRenderer

            self._renderer = TerrainRenderer()
        return self._renderer

    def _render_params(self, width: int, height: int):
        from ..terrain.params import make_terrain_params

        s = self.state
        p = make_terrain_params()
        p.size_px = (int(width), int(height))
        p.z_scale = float(s.z_scale)
        p.cam_target = tuple(map(float, s.cam["target"]))
        p.cam_radius = float(s.cam["radius"])
        p.cam_phi_deg = float(s.cam["phi_deg"])
        p.cam_theta_deg = float(s.cam["theta_deg"])
        p.fov_y_deg = float(s.cam["fov_y_deg"])
        p.exposure = float(s.exposure)
        p.colormap = s.colormap
        if s.terrain_span:
            p.terrain_span = float(s.terrain_span)
        p.light.azimuth_deg = float(s.sun["azimuth_deg"])
        p.light.elevation_deg = float(s.sun["elevation_deg"])
        p.light.intensity = float(s.sun["intensity"])
        p.ibl.enabled = bool(s.ibl["enabled"])
        p.ibl.intensity = float(s.ibl["intensity"])
        for k, v in self.state.terrain_pbr.items():
            if hasattr(p, k):
                setattr(p, k, v)
        return p

    def render_frame(self, width: Optional[int] = None,
                     height: Optional[int] = None) -> np.ndarray:
        s = self.state
        W = int(width or s.width)
        H = int(height or s.height)
        with self._render_lock:
            has_content = bool(s.meshes) or s.pointcloud is not None
            if s.terrain is None:
                # no terrain: sky-only gradient placeholder frame
                y = np.linspace(0, 1, H, dtype=np.float32)[:, None]
                rgba = np.empty((H, W, 4), np.uint8)
                rgba[..., 0] = (120 + 80 * y) .astype(np.uint8)
                rgba[..., 1] = (160 + 60 * y).astype(np.uint8)
                rgba[..., 2] = (210 + 40 * y).astype(np.uint8)
                rgba[..., 3] = 255
                frame = rgba
                depth = np.full((H, W), np.inf)
                p = self._render_params(W, H)
            else:
                renderer = self._get_renderer()
                p = self._render_params(W, H)
                if has_content:
                    fr, aov = renderer.render_with_aov(
                        params=p, heightmap=s.terrain)
                    frame = fr.rgba.copy()
                    depth = np.asarray(aov["depth"], np.float64).copy()
                    depth[~np.isfinite(depth)] = np.inf
                else:
                    frame = renderer.render_terrain_pbr_pom(
                        params=p, heightmap=s.terrain).rgba.copy()
                    depth = None
            if has_content:
                frame = self._composite_content(frame, depth, p)
            frame = self._composite_overlays(frame)
            frame = self._composite_labels(frame, W, H)
            s.stats["frames_rendered"] += 1
            return frame

    def _composite_content(self, frame, depth, p):
        """Loaded meshes (BVH-traced, lambert shaded) and point clouds
        (depth-tested splats) composited against the terrain depth — the
        viewer renders what it loads, not just terrain (ref: the
        interactive viewer's full scene pipeline, src/viewer/render)."""
        import math as _math

        from ..camera import camera_basis, orbit_camera_origin
        from ..ops.shading import sun_direction

        s = self.state
        H, W = frame.shape[:2]
        origin = np.asarray(orbit_camera_origin(
            p.cam_target, p.cam_radius, p.cam_phi_deg, p.cam_theta_deg),
            np.float64)
        right, up, fwd = camera_basis(origin, p.cam_target, (0, 1, 0))
        half_h = _math.tan(_math.radians(p.fov_y_deg) * 0.5)
        half_w = (W / H) * half_h

        if s.meshes:
            import jax.numpy as jnp

            from ..io.mesh import merge_meshes
            from ..ops.bvh import build_sah_bvh, mesh_scene, trace_mesh

            meshes = []
            for name, m in sorted(s.meshes.items()):
                v = np.asarray(m.vertices, np.float64)
                t = s.transforms.get(name)
                if t is not None:
                    t = np.asarray(t, np.float64).reshape(4, 4)
                    v = v @ t[:3, :3].T + t[:3, 3]
                mm = type(m)(vertices=v.astype(np.float32),
                             indices=np.asarray(m.indices, np.uint32))
                meshes.append(mm)
            mesh = merge_meshes(meshes) if len(meshes) > 1 else meshes[0]
            if mesh.indices.size:
                bvh = build_sah_bvh(np.asarray(mesh.vertices, np.float32),
                                    np.asarray(mesh.indices, np.uint32))
                scene, n_nodes = mesh_scene(bvh)
                xs = (np.arange(W) + 0.5) / W * 2.0 - 1.0
                ys = 1.0 - (np.arange(H) + 0.5) / H * 2.0
                d = (fwd[None, None, :]
                     + xs[None, :, None] * half_w * right[None, None, :]
                     + ys[:, None, None] * half_h * up[None, None, :])
                d /= np.linalg.norm(d, axis=-1, keepdims=True)
                hit = trace_mesh(
                    scene, n_nodes,
                    tuple(jnp.full((H, W), c, jnp.float32) for c in origin),
                    tuple(jnp.asarray(d[..., i], jnp.float32)
                          for i in range(3)))
                hitm = np.asarray(hit.hit)
                t = np.asarray(hit.t)
                prim = np.asarray(hit.prim)
                e1 = np.asarray(scene.tri_e1)[prim]
                e2 = np.asarray(scene.tri_e2)[prim]
                n = np.cross(e1, e2)
                n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                                1e-12)
                n = np.where((n * d).sum(-1)[..., None] > 0, -n, n)
                sx, sy, sz = (float(np.asarray(c)) for c in sun_direction(
                    s.sun["azimuth_deg"], s.sun["elevation_deg"]))
                ndl = np.maximum(n[..., 0] * sx + n[..., 1] * sy
                                 + n[..., 2] * sz, 0.0)
                shade = 0.75 * (s.sun["intensity"] * ndl[..., None]
                                * np.array([1.0, 0.97, 0.92]) + 0.25)
                ldr = np.clip(shade / (1 + shade), 0, 1)
                nearer = hitm & (t < depth)
                frame[..., :3] = np.where(
                    nearer[..., None], (ldr * 255 + 0.5).astype(np.uint8),
                    frame[..., :3])
                np.copyto(depth, np.where(nearer, t, depth))

        if s.pointcloud is not None and len(s.pointcloud):
            pp = np.asarray(s.pointcloud, np.float64)
            rel = pp - origin
            zc = rel @ np.asarray(fwd)
            xc = rel @ np.asarray(right)
            yc = rel @ np.asarray(up)
            ok = zc > 1e-6
            zs = np.where(ok, zc, 1.0)
            px = ((xc / (zs * half_w) + 1) * 0.5 * W - 0.5).round().astype(int)
            py = ((1 - yc / (zs * half_h)) * 0.5 * H - 0.5).round().astype(int)
            tdist = np.linalg.norm(rel, axis=-1)
            size = int(self.state.pointcloud_params.get("point_size", 2))
            r = max(size // 2, 0)
            order = np.argsort(-tdist)
            col = np.asarray(self.state.pointcloud_params.get(
                "color", (250, 170, 60)), np.uint8)
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    gx = px[order] + dx
                    gy = py[order] + dy
                    sel = (ok[order] & (gx >= 0) & (gx < W)
                           & (gy >= 0) & (gy < H))
                    gxx, gyy = gx[sel], gy[sel]
                    closer = tdist[order][sel] < depth[gyy, gxx] + 1e-6
                    gxx, gyy = gxx[closer], gyy[closer]
                    frame[gyy, gxx, :3] = col
        return frame

    def _composite_overlays(self, frame: np.ndarray) -> np.ndarray:
        s = self.state
        if not s.overlays_enabled:
            return frame
        H, W = frame.shape[:2]
        for name, ov in sorted(s.overlays.items()):
            if not ov.get("visible", True) or ov.get("image") is None:
                continue
            img = ov["image"]
            if img.shape[0] != H or img.shape[1] != W:
                continue
            a = (img[..., 3:4].astype(np.float32) / 255.0
                 * float(ov.get("opacity", 1.0)) * s.global_overlay_opacity)
            frame = frame.copy()
            frame[..., :3] = (frame[..., :3] * (1 - a)
                              + img[..., :3] * a).astype(np.uint8)
        return frame

    def _composite_labels(self, frame: np.ndarray, W: int, H: int) -> np.ndarray:
        s = self.state
        if not s.labels_enabled or not s.labels:
            return frame
        from ..labels import plan_labels, point_label_candidates, render_label_overlay

        cands = []
        curved = []
        for lid, lab in sorted(s.labels.items()):
            size = float(lab.get("size", s.label_typography["size"])) \
                * s.label_zoom
            if lab.get("kind") == "curved" and lab.get("polyline"):
                curved.append((lab, size))
                continue
            cands += point_label_candidates(
                lid, lab["text"], float(lab["x"]), float(lab["y"]),
                priority=float(lab.get("priority", 1.0)),
                size=size)
        plan = plan_labels(cands, frame_size=(W, H),
                           algorithm=s.declutter_algorithm,
                           max_visible=s.max_visible_labels)
        ov = render_label_overlay(W, H, plan.placements)
        if curved:
            from ..labels.render import draw_text_along_path

            for lab, size in curved:
                draw_text_along_path(ov, lab["text"], lab["polyline"],
                                     size=size)
        a = ov[..., 3:4].astype(np.float32) / 255.0
        out = frame.copy()
        out[..., :3] = (frame[..., :3] * (1 - a) + ov[..., :3] * a).astype(np.uint8)
        return out

    # ------------------------------------------------- commands: lifecycle
    def _cmd_close(self, req):
        self._closing.set()
        return {"closing": True}

    def _cmd_get_stats(self, req):
        s = self.state
        return {"stats": {**s.stats, "labels": len(s.labels),
                          "overlays": len(s.overlays),
                          "vector_overlays": len(s.vector_overlays),
                          "has_terrain": s.terrain is not None}}

    def _cmd_snapshot(self, req):
        path, = _require(req, "path")
        W = int(req.get("width", self.state.width))
        H = int(req.get("height", self.state.height))
        # reference clamps snapshots to a max megapixel budget
        max_mp = float(req.get("max_megapixels", 16.0))
        if W * H > max_mp * 1e6:
            scale = math.sqrt(max_mp * 1e6 / (W * H))
            W, H = max(1, int(W * scale)), max(1, int(H * scale))
        frame = self.render_frame(W, H)
        from ..io.image import numpy_to_png

        numpy_to_png(path, frame)
        self.state.stats["snapshots"] += 1
        return {"path": str(path), "width": W, "height": H}

    # -------------------------------------------------- commands: terrain
    def _cmd_load_terrain(self, req):
        path, = _require(req, "path")
        from ..gis.geotiff import read_raster

        arr = read_raster(path)
        self.state.terrain = np.asarray(arr, np.float32)
        return {"shape": list(self.state.terrain.shape)}

    def _cmd_set_terrain(self, req):
        heights, = _require(req, "heights")
        arr = np.asarray(heights, np.float32)
        if arr.ndim != 2:
            raise ValueError("heights must be 2D")
        self.state.terrain = arr
        if "span" in req:
            self.state.terrain_span = float(req["span"])
        return {"shape": list(arr.shape)}

    def _cmd_set_terrain_camera(self, req):
        cam = self.state.cam
        for k in ("target", "radius", "phi_deg", "theta_deg", "fov_y_deg"):
            if k in req:
                cam[k] = req[k]
        return {}

    def _cmd_cam_lookat(self, req):
        eye, target = _require(req, "eye", "target")
        ex, ey, ez = map(float, eye)
        tx, ty, tz = map(float, target)
        dx, dy, dz = ex - tx, ey - ty, ez - tz
        r = math.sqrt(dx * dx + dy * dy + dz * dz)
        self.state.cam["target"] = [tx, ty, tz]
        self.state.cam["radius"] = r
        self.state.cam["theta_deg"] = math.degrees(math.asin(
            max(-1.0, min(1.0, dy / max(r, 1e-9)))))
        self.state.cam["phi_deg"] = math.degrees(math.atan2(dz, dx))
        return {"radius": r}

    def _cmd_set_terrain_sun(self, req):
        for k in ("azimuth_deg", "elevation_deg", "intensity"):
            if k in req:
                self.state.sun[k] = float(req[k])
        return {}

    def _cmd_lit_sun(self, req):
        return self._cmd_set_terrain_sun(req)

    def _cmd_lit_ibl(self, req):
        if "enabled" in req:
            self.state.ibl["enabled"] = bool(req["enabled"])
        if "intensity" in req:
            self.state.ibl["intensity"] = float(req["intensity"])
        return {}

    def _cmd_set_z_scale(self, req):
        value, = _require(req, "value")
        v = float(value)
        if not (v > 0):
            raise ValueError("z_scale must be positive")
        self.state.z_scale = v
        return {}

    def _cmd_set_fov(self, req):
        value, = _require(req, "value")
        self.state.cam["fov_y_deg"] = float(value)
        return {}

    def _cmd_set_terrain_pbr(self, req):
        cfg = dict(req)
        cfg.pop("cmd", None)
        self.state.terrain_pbr.update(cfg)
        return {}

    def _cmd_get_terrain_params(self, req):
        s = self.state
        return {"params": {"z_scale": s.z_scale, "cam": dict(s.cam),
                           "sun": dict(s.sun), "ibl": dict(s.ibl),
                           "pbr": dict(s.terrain_pbr)}}

    def _cmd_set_terrain_scatter(self, req):
        cfg = dict(req)
        cfg.pop("cmd", None)
        self.state.terrain_scatter = cfg
        return {}

    def _cmd_clear_terrain_scatter(self, req):
        self.state.terrain_scatter = None
        return {}

    def _cmd_get_terrain_volumetrics_report(self, req):
        return {"report": dict(self.state.volumetrics)}

    # ---------------------------------------------------- commands: assets
    def _cmd_load_obj(self, req):
        path, = _require(req, "path")
        from ..io.mesh import load_obj

        mesh = load_obj(path)
        name = req.get("name", mesh.name or "obj")
        self.state.meshes[name] = mesh
        return {"name": name, "triangles": mesh.triangle_count}

    def _cmd_load_gltf(self, req):
        path, = _require(req, "path")
        from ..io.mesh import load_gltf, merge_meshes

        meshes = load_gltf(path)
        mesh = merge_meshes(meshes) if len(meshes) > 1 else meshes[0]
        name = req.get("name", mesh.name or "gltf")
        self.state.meshes[name] = mesh
        return {"name": name, "triangles": mesh.triangle_count}

    def _cmd_load_point_cloud(self, req):
        # reference wire spelling (LoadPointCloud -> load_point_cloud)
        return self._cmd_load_pointcloud(req)

    def _cmd_load_pointcloud(self, req):
        path, = _require(req, "path")
        from ..pointcloud import read_point_file

        pts = read_point_file(path)
        self.state.pointcloud = pts.positions
        return {"points": int(len(pts.positions))}

    def _cmd_clear_point_cloud(self, req):
        self.state.pointcloud = None
        return {}

    def _cmd_set_point_cloud_params(self, req):
        cfg = dict(req)
        cfg.pop("cmd", None)
        self.state.pointcloud_params.update(cfg)
        return {}

    def _cmd_set_transform(self, req):
        name, matrix = _require(req, "name", "matrix")
        m = np.asarray(matrix, np.float64).reshape(4, 4)
        self.state.transforms[str(name)] = m.tolist()
        return {}

    # ---------------------------------------------------- commands: labels
    def _cmd_add_label(self, req):
        text, x, y = _require(req, "text", "x", "y")
        s = self.state
        lid = s.next_label_id
        s.next_label_id += 1
        s.labels[lid] = {"text": str(text), "x": float(x), "y": float(y),
                         "priority": float(req.get("priority", 1.0)),
                         "size": float(req.get("size",
                                               s.label_typography["size"])),
                         "kind": "point"}
        return {"id": lid}

    def _cmd_add_line_label(self, req):
        text, polyline = _require(req, "text", "polyline")
        s = self.state
        lid = s.next_label_id
        s.next_label_id += 1
        s.labels[lid] = {"text": str(text), "polyline": polyline,
                         "x": float(polyline[0][0]), "y": float(polyline[0][1]),
                         "priority": float(req.get("priority", 1.0)),
                         "kind": "line"}
        return {"id": lid}

    def _cmd_add_curved_label(self, req):
        text, polyline = _require(req, "text", "polyline")
        s = self.state
        lid = s.next_label_id
        s.next_label_id += 1
        s.labels[lid] = {"text": str(text), "polyline": polyline,
                         "x": float(polyline[0][0]),
                         "y": float(polyline[0][1]),
                         "priority": float(req.get("priority", 1.0)),
                         "kind": "curved"}   # per-glyph path placement
        return {"id": lid}

    def _cmd_remove_label(self, req):
        lid, = _require(req, "id")
        removed = self.state.labels.pop(int(lid), None) is not None
        return {"removed": removed}

    def _cmd_clear_labels(self, req):
        n = len(self.state.labels)
        self.state.labels.clear()
        return {"cleared": n}

    def _cmd_update_labels(self, req):
        updates, = _require(req, "labels")
        count = 0
        for u in updates:
            lid = int(u["id"])
            if lid in self.state.labels:
                self.state.labels[lid].update(
                    {k: v for k, v in u.items() if k != "id"})
                count += 1
        return {"updated": count}

    def _cmd_set_labels_enabled(self, req):
        enabled, = _require(req, "enabled")
        self.state.labels_enabled = bool(enabled)
        return {}

    def _cmd_set_max_visible_labels(self, req):
        value, = _require(req, "value")
        self.state.max_visible_labels = None if value is None else int(value)
        return {}

    def _cmd_set_declutter_algorithm(self, req):
        algorithm, = _require(req, "algorithm")
        if algorithm not in ("greedy", "annealing", "optimal"):
            raise ValueError(f"unknown declutter algorithm: {algorithm}")
        self.state.declutter_algorithm = algorithm
        return {}

    def _cmd_set_label_typography(self, req):
        cfg = dict(req)
        cfg.pop("cmd", None)
        self.state.label_typography.update(cfg)
        return {}

    def _cmd_set_label_zoom(self, req):
        value, = _require(req, "value")
        self.state.label_zoom = float(value)
        return {}

    def _cmd_load_label_atlas(self, req):
        # atlas is baked in-process; accept for protocol parity
        return {"loaded": True}

    def _cmd_add_callout(self, req):
        text, x, y, ax, ay = _require(req, "text", "x", "y", "anchor_x",
                                      "anchor_y")
        s = self.state
        cid = s.next_label_id
        s.next_label_id += 1
        s.callouts[cid] = {"text": str(text), "x": float(x), "y": float(y),
                           "anchor": [float(ax), float(ay)]}
        return {"id": cid}

    def _cmd_remove_callout(self, req):
        cid, = _require(req, "id")
        return {"removed": self.state.callouts.pop(int(cid), None) is not None}

    # -------------------------------------------------- commands: overlays
    def _cmd_load_overlay(self, req):
        name, path = _require(req, "name", "path")
        from ..io.image import png_to_numpy

        img = png_to_numpy(path)
        if img.ndim == 2:
            img = np.stack([img] * 3 + [np.full_like(img, 255)], -1)
        if img.shape[2] == 3:
            img = np.concatenate(
                [img, np.full((*img.shape[:2], 1), 255, img.dtype)], -1)
        self.state.overlays[str(name)] = {
            "image": img.astype(np.uint8), "opacity": 1.0, "visible": True,
            "solid": False, "preserve_colors": False}
        return {"name": name, "shape": list(img.shape)}

    def _cmd_remove_overlay(self, req):
        name, = _require(req, "name")
        return {"removed": self.state.overlays.pop(str(name), None) is not None}

    def _cmd_list_overlays(self, req):
        return {"overlays": sorted(self.state.overlays)}

    def _cmd_set_overlay_opacity(self, req):
        name, value = _require(req, "name", "value")
        self.state.overlays[str(name)]["opacity"] = float(value)
        return {}

    def _cmd_set_overlay_visible(self, req):
        name, visible = _require(req, "name", "visible")
        self.state.overlays[str(name)]["visible"] = bool(visible)
        return {}

    def _cmd_set_overlay_solid(self, req):
        name, solid = _require(req, "name", "solid")
        self.state.overlays[str(name)]["solid"] = bool(solid)
        return {}

    def _cmd_set_overlay_preserve_colors(self, req):
        name, value = _require(req, "name", "value")
        self.state.overlays[str(name)]["preserve_colors"] = bool(value)
        return {}

    def _cmd_set_overlays_enabled(self, req):
        enabled, = _require(req, "enabled")
        self.state.overlays_enabled = bool(enabled)
        return {}

    def _cmd_set_global_overlay_opacity(self, req):
        value, = _require(req, "value")
        self.state.global_overlay_opacity = float(value)
        return {}

    def _cmd_add_vector_overlay(self, req):
        name, = _require(req, "name")
        self.state.vector_overlays[str(name)] = {
            "geojson": req.get("geojson"), "style": req.get("style", {}),
            "opacity": 1.0, "visible": True}
        return {"name": name}

    def _cmd_remove_vector_overlay(self, req):
        name, = _require(req, "name")
        return {"removed":
                self.state.vector_overlays.pop(str(name), None) is not None}

    def _cmd_list_vector_overlays(self, req):
        return {"vector_overlays": sorted(self.state.vector_overlays)}

    def _cmd_set_vector_overlay_opacity(self, req):
        name, value = _require(req, "name", "value")
        self.state.vector_overlays[str(name)]["opacity"] = float(value)
        return {}

    def _cmd_set_vector_overlay_visible(self, req):
        name, visible = _require(req, "name", "visible")
        self.state.vector_overlays[str(name)]["visible"] = bool(visible)
        return {}

    def _cmd_set_vector_overlays_enabled(self, req):
        enabled, = _require(req, "enabled")
        self.state.vector_overlays_enabled = bool(enabled)
        return {}

    def _cmd_set_global_vector_overlay_opacity(self, req):
        value, = _require(req, "value")
        self.state.global_vector_overlay_opacity = float(value)
        return {}

    # ------------------------------------------------- commands: TAA / OIT
    def _cmd_set_taa_enabled(self, req):
        enabled, = _require(req, "enabled")
        self.state.taa["enabled"] = bool(enabled)
        return {}

    def _cmd_set_taa_params(self, req):
        for k in ("blend", "sharpen"):
            if k in req:
                self.state.taa[k] = float(req[k])
        return {}

    def _cmd_get_taa_status(self, req):
        return {"taa": dict(self.state.taa)}

    def _cmd_set_oit_enabled(self, req):
        enabled, = _require(req, "enabled")
        self.state.oit["enabled"] = bool(enabled)
        return {}

    def _cmd_get_oit_mode(self, req):
        return {"mode": self.state.oit["mode"],
                "enabled": self.state.oit["enabled"]}

    # ------------------------------------------------- commands: picking
    def _cmd_pick_at(self, req):
        x, y = _require(req, "x", "y")
        s = self.state
        if s.terrain is None:
            return {"hit": False}
        from ..camera import PinholeCamera, orbit_camera_origin
        from ..ops.pyramid import build_pyramid
        from ..ops.traversal import scene_from_pyramid
        from ..picking import pick_terrain

        pyr = build_pyramid(s.terrain)
        scene, static = scene_from_pyramid(pyr, exaggeration=s.z_scale)
        origin = orbit_camera_origin(
            s.cam["target"], s.cam["radius"], s.cam["phi_deg"],
            s.cam["theta_deg"])
        cam = PinholeCamera.from_lookat(
            origin, s.cam["target"], fov_y_deg=s.cam["fov_y_deg"],
            aspect=s.width / s.height)
        res = pick_terrain(scene, static, cam, s.width, s.height,
                           float(x), float(y))
        event = {"x": float(x), "y": float(y), "hit": bool(res.hit),
                 "world": [float(v) for v in res.world] if res.hit else None,
                 "normal": [float(v) for v in res.normal] if res.hit else None,
                 "depth": float(res.t) if res.hit else None}
        s.pick_events.append(event)
        return event

    def _cmd_poll_pick_events(self, req):
        events = self.state.pick_events
        self.state.pick_events = []
        return {"events": events}

    def _cmd_set_lasso_mode(self, req):
        enabled, = _require(req, "enabled")
        self.state.lasso_mode = bool(enabled)
        if not enabled:
            self.state.lasso_points = []
        return {}

    def _cmd_get_lasso_state(self, req):
        return {"enabled": self.state.lasso_mode,
                "points": list(self.state.lasso_points)}

    def _cmd_clear_selection(self, req):
        n = len(self.state.selection)
        self.state.selection.clear()
        return {"cleared": n}

    # ------------------------------------------- commands: scene variants
    def _cmd_apply_scene_variant(self, req):
        name, = _require(req, "name")
        if name not in self.state.scene_variants:
            raise ValueError(f"unknown scene variant: {name}")
        self.state.active_scene_variant = str(name)
        cfg = self.state.scene_variants[str(name)]
        for k, v in cfg.items():
            if k == "sun":
                self.state.sun.update(v)
            elif k == "camera":
                self.state.cam.update(v)
        return {}

    def _cmd_get_active_scene_variant(self, req):
        return {"name": self.state.active_scene_variant}

    def _cmd_list_scene_variants(self, req):
        return {"variants": sorted(self.state.scene_variants)}

    def _cmd_set_scene_review_state(self, req):
        cfg = dict(req)
        cfg.pop("cmd", None)
        self.state.scene_review_state.update(cfg)
        if "variants" in req:
            for name, v in req["variants"].items():
                self.state.scene_variants[str(name)] = v
        return {}

    def _cmd_list_review_layers(self, req):
        return {"layers": sorted(self.state.review_layers)}

    def _cmd_set_review_layer_visible(self, req):
        name, visible = _require(req, "name", "visible")
        self.state.review_layers[str(name)] = bool(visible)
        return {}

    def _cmd_set_observation(self, req):
        cfg = dict(req)
        cfg.pop("cmd", None)
        self.state.observation.update(cfg)
        return {}

    # ------------------------------------------------- commands: bundles
    def _cmd_save_bundle(self, req):
        path, = _require(req, "path")
        from ..bundle import save_bundle

        s = self.state
        save_bundle(path, terrain=s.terrain, state={
            "cam": s.cam, "sun": s.sun, "z_scale": s.z_scale,
            "labels": {str(k): v for k, v in s.labels.items()}})
        self.state.pending_bundle_save = {"path": str(path), "done": True}
        return {"path": str(path)}

    def _cmd_load_bundle(self, req):
        path, = _require(req, "path")
        from ..bundle import load_bundle

        data = load_bundle(path)
        s = self.state
        if data.get("terrain") is not None:
            s.terrain = data["terrain"]
        st = data.get("state", {})
        if "cam" in st:
            s.cam.update(st["cam"])
        if "sun" in st:
            s.sun.update(st["sun"])
        if "z_scale" in st:
            s.z_scale = float(st["z_scale"])
        if "labels" in st:
            s.labels = {int(k): v for k, v in st["labels"].items()}
            s.next_label_id = max(s.labels, default=0) + 1
        self.state.pending_bundle_load = {"path": str(path), "done": True}
        return {"loaded": True}

    def _cmd_poll_pending_bundle_load(self, req):
        return {"pending": self.state.pending_bundle_load}

    def _cmd_poll_pending_bundle_save(self, req):
        return {"pending": self.state.pending_bundle_save}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="forge3d_tpu.viewer")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=768)
    args = ap.parse_args(argv)
    server = ViewerServer(port=args.port)
    server.state.width = args.width
    server.state.height = args.height
    server.announce()
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
