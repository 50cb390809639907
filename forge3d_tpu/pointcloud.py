# forge3d_tpu/pointcloud.py
# Point clouds: LAS read, PLY/XYZ points, octree LOD traversal, EDL-shaded
# splat render.
#
# Parity notes (reference behavior, not code): /root/reference/src/
# pointcloud/ (mod.rs:1-13) parses COPC/EPT/LAS(LAZ), traverses an octree
# by screen-space error, and renders instanced points with eye-dome
# lighting. Here: points render by splatting into a depth-tested
# image with jnp scatter ops (no raster pipeline); EDL is a screen-space
# depth filter. LAZ decompression needs an external codec and is gated
# (LazUnsupported) like other optional deps.

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .errors import RenderError

__all__ = ["PointBuffer", "read_las_points", "read_point_file",
           "read_laz_points_info", "PointOctree", "render_points",
           "LazUnsupported", "write_las", "write_copc",
           "copc_read_node_points", "copc_hierarchy"]


class LazUnsupported(RenderError):
    """LAZ (compressed LAS) needs an external decoder; not available."""


@dataclass
class PointBuffer:
    """Loaded point data (positions in file CRS; colors/intensity in [0,1])."""

    positions: np.ndarray                     # (N, 3) float64
    colors: Optional[np.ndarray] = None       # (N, 3) float32
    intensity: Optional[np.ndarray] = None    # (N,) float32
    classification: Optional[np.ndarray] = None
    attributes: Dict[str, np.ndarray] = field(default_factory=dict)
    header: Dict[str, object] = field(default_factory=dict)

    @property
    def count(self) -> int:
        return int(self.positions.shape[0])


_LAS_FORMAT_SIZE = {0: 20, 1: 28, 2: 26, 3: 34, 4: 57, 5: 63,
                    6: 30, 7: 36, 8: 38, 9: 59, 10: 67}
_LAS_HAS_RGB = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}  # fmt -> rgb offset


def read_laz_points_info(path) -> dict:
    """Header probe for LAS/LAZ (reference seam: read_laz_points_info_py)."""
    with open(path, "rb") as fh:
        head = fh.read(375)
    if head[:4] != b"LASF":
        raise RenderError(f"not a LAS file: {path}")
    ver_major, ver_minor = head[24], head[25]
    fmt = head[104]
    compressed = bool(fmt & 0x80)
    fmt &= 0x7F
    if ver_minor >= 4 and len(head) >= 375:
        (n_legacy,) = struct.unpack_from("<I", head, 107)
        (n64,) = struct.unpack_from("<Q", head, 247)
        count = n64 or n_legacy
    else:
        (count,) = struct.unpack_from("<I", head, 107)
    scale = struct.unpack_from("<3d", head, 131)
    offset = struct.unpack_from("<3d", head, 155)
    bounds = struct.unpack_from("<6d", head, 179)  # maxx minx maxy miny maxz minz
    return {
        "version": f"{ver_major}.{ver_minor}",
        "point_format": int(fmt),
        "compressed": compressed,
        "count": int(count),
        "scale": list(scale),
        "offset": list(offset),
        "bounds": {"min": [bounds[1], bounds[3], bounds[5]],
                   "max": [bounds[0], bounds[2], bounds[4]]},
        "has_rgb": int(fmt) in _LAS_HAS_RGB,
    }


def _read_vlrs(fh, head) -> list:
    """Read the VLR block following the header: [(user_id, record_id,
    payload)]."""
    (header_size,) = struct.unpack_from("<H", head, 94)
    (n_vlrs,) = struct.unpack_from("<I", head, 100)
    fh.seek(header_size)
    out = []
    for _ in range(n_vlrs):
        rec = fh.read(54)
        if len(rec) < 54:
            break
        user_id = rec[2:18].rstrip(b"\x00")
        (record_id,) = struct.unpack_from("<H", rec, 18)
        (length,) = struct.unpack_from("<H", rec, 20)
        out.append((user_id, record_id, fh.read(length)))
    return out


def _decode_records(raw: np.ndarray, fmt: int, rec_len: int, info: dict,
                    count: int) -> PointBuffer:
    xyz_i = raw[:, 0:12].copy().view("<i4").reshape(count, 3)
    scale = np.asarray(info["scale"])
    offset = np.asarray(info["offset"])
    positions = xyz_i.astype(np.float64) * scale + offset
    intensity = (raw[:, 12:14].copy().view("<u2").reshape(count)
                 .astype(np.float32) / 65535.0)
    cls_off = 15 if fmt < 6 else 16
    classification = raw[:, cls_off].copy()
    colors = None
    if fmt in _LAS_HAS_RGB:
        off = _LAS_HAS_RGB[fmt]
        if rec_len >= off + 6:
            rgb = raw[:, off:off + 6].copy().view("<u2").reshape(count, 3)
            colors = rgb.astype(np.float32) / 65535.0
    return PointBuffer(positions=positions, colors=colors,
                       intensity=intensity, classification=classification,
                       header=info)


def read_las_points(path, *, max_points: Optional[int] = None) -> PointBuffer:
    """LAS/compressed-LAS reader (XYZ + intensity + class + RGB when
    present). Compressed streams decode through the native point codec
    (codec/laz.py) for point formats 0-3; genuine foreign-LASzip item
    versions fail closed with LazUnsupported (no silent misdecode)."""
    info = read_laz_points_info(path)
    fmt = info["point_format"]
    with open(path, "rb") as fh:
        head = fh.read(375)
        (point_offset,) = struct.unpack_from("<I", head, 96)
        (rec_len,) = struct.unpack_from("<H", head, 105)
        if rec_len == 0:
            rec_len = _LAS_FORMAT_SIZE.get(fmt, 20)
        count = info["count"]
        want = count if max_points is None else min(count, int(max_points))
        if info["compressed"]:
            from .codec.laz import (LAZ_VLR_RECORD_ID, LazCodecError,
                                    decompress_point_records,
                                    parse_laz_vlr_payload)

            # COPC-layout containers are octree-paged: assemble all nodes
            fh.seek(-4, 2)
            if fh.read(4) == b"F3CP":
                bufs = [copc_read_node_points(path, key)
                        for key in sorted(copc_hierarchy(path))]
                pos = np.concatenate([b.positions for b in bufs])
                cols = (np.concatenate([b.colors for b in bufs])
                        if bufs and bufs[0].colors is not None else None)
                inten = (np.concatenate([b.intensity for b in bufs])
                         if bufs and bufs[0].intensity is not None else None)
                cls = (np.concatenate([b.classification for b in bufs])
                       if bufs and bufs[0].classification is not None
                       else None)
                if max_points is not None:
                    pos = pos[: int(max_points)]
                    cols = cols[: int(max_points)] if cols is not None else None
                    inten = (inten[: int(max_points)]
                             if inten is not None else None)
                    cls = cls[: int(max_points)] if cls is not None else None
                return PointBuffer(positions=pos, colors=cols,
                                   intensity=inten, classification=cls,
                                   header=info)
            laz_vlr = next((p for u, r, p in _read_vlrs(fh, head)
                            if r == LAZ_VLR_RECORD_ID), None)
            if laz_vlr is None:
                raise LazUnsupported("compressed LAS without a LAZ VLR")
            meta = parse_laz_vlr_payload(laz_vlr)
            if meta["foreign"]:
                raise LazUnsupported(
                    "genuine LASzip item versions are not cross-validated "
                    "in this environment; refusing to misdecode "
                    "(fail-closed). Re-encode with forge3d_tpu.pointcloud."
                    "write_las(compress=True) or decompress externally.")
            if fmt not in (0, 1, 2, 3):
                raise LazUnsupported(
                    f"compressed point format {fmt} not supported yet "
                    "(formats 0-3)")
            fh.seek(point_offset)
            stream = fh.read()
            try:
                rec_bytes = decompress_point_records(
                    stream, count, fmt, meta["chunk_size"])
            except LazCodecError as e:
                raise LazUnsupported(str(e)) from None
            raw = np.frombuffer(rec_bytes, np.uint8).reshape(count, rec_len)
            raw = raw[:want]
            buf = _decode_records(raw, fmt, rec_len, info, want)
            _bounds_check(buf, info)
            return buf
        fh.seek(point_offset)
        raw = np.frombuffer(fh.read(rec_len * want), np.uint8)
    count = want
    if len(raw) < rec_len * count:
        count = len(raw) // rec_len
    raw = raw[: rec_len * count].reshape(count, rec_len)

    xyz_i = raw[:, 0:12].copy().view("<i4").reshape(count, 3)
    scale = np.asarray(info["scale"])
    offset = np.asarray(info["offset"])
    positions = xyz_i.astype(np.float64) * scale + offset

    intensity = raw[:, 12:14].copy().view("<u2").reshape(count).astype(np.float32) / 65535.0
    cls_off = 15 if fmt < 6 else 16
    classification = raw[:, cls_off].copy()

    colors = None
    if fmt in _LAS_HAS_RGB:
        off = _LAS_HAS_RGB[fmt]
        if rec_len >= off + 6:
            rgb = raw[:, off:off + 6].copy().view("<u2").reshape(count, 3)
            colors = rgb.astype(np.float32) / 65535.0

    return PointBuffer(positions=positions, colors=colors,
                       intensity=intensity, classification=classification,
                       header=info)


def read_point_file(path, **kw) -> PointBuffer:
    """Dispatch: .las/.laz, .ply (points), .xyz/.txt, .npy."""
    ext = Path(str(path)).suffix.lower()
    if ext in (".las", ".laz"):
        return read_las_points(path, **kw)
    if ext == ".ply":
        from .io.mesh import load_ply

        try:
            m = load_ply(path)
            return PointBuffer(positions=m.vertices.astype(np.float64),
                               colors=m.colors)
        except ValueError:
            return _read_ply_points(path)
    if ext in (".xyz", ".txt", ".csv"):
        arr = np.loadtxt(path, ndmin=2, delimiter="," if ext == ".csv" else None)
        return PointBuffer(positions=arr[:, :3].astype(np.float64),
                           colors=arr[:, 3:6].astype(np.float32) / 255.0
                           if arr.shape[1] >= 6 else None)
    if ext == ".npy":
        arr = np.load(path)
        return PointBuffer(positions=np.asarray(arr, np.float64)[:, :3])
    raise RenderError(f"unsupported point cloud format: {ext}")


def _read_ply_points(path) -> PointBuffer:
    """PLY vertex cloud with no faces."""
    from .io.mesh import MeshData  # noqa: F401 — parser internals reused

    # minimal ascii/binary vertex-only read via the mesh parser's header
    # logic: re-parse accepting zero faces
    import io

    with open(path, "rb") as fh:
        data = fh.read()
    # patch: append a fake empty face element if absent is unnecessary —
    # parse manually for xyz columns
    text = data[:4096].decode("ascii", "replace")
    if "format ascii" in text:
        lines = data.decode("ascii", "replace").splitlines()
        n = 0
        props: List[str] = []
        i = 0
        for i, ln in enumerate(lines):
            t = ln.split()
            if t[:2] == ["element", "vertex"]:
                n = int(t[2])
            elif t and t[0] == "property" and n and "element" not in t[0]:
                props.append(t[-1])
            elif t and t[0] == "end_header":
                break
        rows = [list(map(float, lines[j].split()))
                for j in range(i + 1, i + 1 + n)]
        arr = np.asarray(rows)
        ix = [props.index(c) for c in ("x", "y", "z")]
        return PointBuffer(positions=arr[:, ix].astype(np.float64))
    raise RenderError("unsupported PLY points layout")


class PointOctree:
    """Static octree over points with screen-space-error LOD selection
    (the reference's COPC/EPT traversal model)."""

    def __init__(self, positions: np.ndarray, *, leaf_size: int = 4096,
                 max_depth: int = 10):
        self.positions = np.asarray(positions, np.float64)
        lo = self.positions.min(0)
        hi = self.positions.max(0)
        center = (lo + hi) / 2
        half = float(np.max(hi - lo) / 2) or 1.0
        self.nodes: List[dict] = []
        self._build(np.arange(len(self.positions)), center, half, 0,
                    leaf_size, max_depth)

    def _build(self, idx, center, half, depth, leaf_size, max_depth) -> int:
        node_id = len(self.nodes)
        node = {"center": center, "half": half, "depth": depth,
                "children": [-1] * 8, "points": None}
        self.nodes.append(node)
        if len(idx) <= leaf_size or depth >= max_depth:
            node["points"] = idx
            return node_id
        # sample for coarse LOD at this node, push the rest down
        keep = idx[:: max(1, len(idx) // leaf_size)][:leaf_size]
        node["points"] = keep
        rest = np.setdiff1d(idx, keep, assume_unique=False)
        if len(rest) == 0:
            return node_id
        p = self.positions[rest]
        octant = ((p[:, 0] > center[0]).astype(int)
                  | ((p[:, 1] > center[1]).astype(int) << 1)
                  | ((p[:, 2] > center[2]).astype(int) << 2))
        for o in range(8):
            sub = rest[octant == o]
            if len(sub) == 0:
                continue
            off = np.array([half / 2 if o & 1 else -half / 2,
                            half / 2 if o & 2 else -half / 2,
                            half / 2 if o & 4 else -half / 2])
            child = self._build(sub, center + off, half / 2, depth + 1,
                                leaf_size, max_depth)
            node["children"][o] = child
        return node_id

    def select(self, eye, *, sse_threshold: float = 1.0,
               fov_y_deg: float = 45.0, screen_height: int = 1080) -> np.ndarray:
        """Indices of points whose octree nodes pass the screen-space-error
        refinement test (node half-size projected > threshold px)."""
        import math

        eye = np.asarray(eye, np.float64)
        k = screen_height / (2 * math.tan(math.radians(fov_y_deg) / 2))
        out = []
        stack = [0]
        while stack:
            node = self.nodes[stack.pop()]
            dist = float(np.linalg.norm(node["center"] - eye))
            sse = k * node["half"] / max(dist, 1e-6)
            if node["points"] is not None:
                out.append(node["points"])
            if sse > sse_threshold:
                stack.extend(c for c in node["children"] if c >= 0)
        return np.concatenate(out) if out else np.empty(0, np.int64)


def render_points(width: int, height: int, positions, cam, *,
                  colors=None, point_size: int = 1,
                  edl: bool = False, edl_strength: float = 1.0,
                  background=(12, 16, 24, 255)) -> np.ndarray:
    """Depth-tested point splat render + optional eye-dome lighting.

    Here: project all points, z-buffer via np.minimum.at scatter
    (deterministic), EDL = depth-difference shading pass.
    """
    from .camera import PinholeCamera

    if not isinstance(cam, PinholeCamera):
        cam = PinholeCamera.from_lookat(
            cam.get("origin", (0, 0, 10)), cam.get("look_at", (0, 0, 0)),
            fov_y_deg=cam.get("fov_y", 45.0), aspect=width / height)
    p = np.asarray(positions, np.float64)
    o = np.asarray(cam.origin)
    fwd = np.asarray(cam.forward)
    right = np.asarray(cam.right)
    up = np.asarray(cam.up)
    rel = p - o
    z = rel @ fwd
    x = rel @ right
    y = rel @ up
    import math

    tan_half = math.tan(cam.fov_y_rad / 2)
    valid = z > 1e-6
    sx = (x / (z * tan_half * cam.aspect) * 0.5 + 0.5) * width
    sy = (1 - (y / (z * tan_half) * 0.5 + 0.5)) * height
    px = np.floor(sx).astype(np.int64)
    py = np.floor(sy).astype(np.int64)
    valid &= (px >= 0) & (px < width) & (py >= 0) & (py < height)

    depth = np.full((height, width), np.inf, np.float64)
    cidx = np.full((height, width), -1, np.int64)
    ids = np.nonzero(valid)[0]
    flat = py[ids] * width + px[ids]
    np.minimum.at(depth.reshape(-1), flat, z[ids])
    # winner-takes-pixel: second pass matches ids to the winning depth
    win = depth.reshape(-1)[flat] == z[ids]
    cidx.reshape(-1)[flat[win]] = ids[win]

    if point_size > 1:
        # dilate the winner buffer by shifting (square splats)
        r = int(point_size) // 2
        base_d = depth.copy()
        base_c = cidx.copy()
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dx == 0 and dy == 0:
                    continue
                sd = np.roll(base_d, (dy, dx), (0, 1))
                sc = np.roll(base_c, (dy, dx), (0, 1))
                closer = sd < depth
                depth = np.where(closer, sd, depth)
                cidx = np.where(closer, sc, cidx)

    img = np.empty((height, width, 4), np.uint8)
    img[:] = np.asarray(background, np.uint8)
    hit = cidx >= 0
    if colors is not None:
        cols = (np.clip(np.asarray(colors, np.float32), 0, 1) * 255).astype(np.uint8)
        img[hit, :3] = cols[cidx[hit]]
    else:
        # height-tinted default
        if hit.any():
            hgt = p[cidx[hit], 1]
            t = ((hgt - hgt.min()) / max(np.ptp(hgt), 1e-9))
            img[hit, 0] = (60 + 180 * t).astype(np.uint8)
            img[hit, 1] = (90 + 120 * t).astype(np.uint8)
            img[hit, 2] = (140 + 60 * (1 - t)).astype(np.uint8)
    img[hit, 3] = 255

    if edl and hit.any():
        d = np.where(np.isfinite(depth), depth, 0.0)
        logd = np.log2(np.maximum(d, 1e-6))
        shade = np.zeros_like(logd)
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nb = np.roll(logd, (dy, dx), (0, 1))
            shade += np.maximum(0.0, logd - nb)
        factor = np.exp(-edl_strength * 300.0 * shade / 4.0)
        img[..., :3] = (img[..., :3] * np.where(hit, factor, 1.0)[..., None]
                        ).astype(np.uint8)
    return img


def _bounds_check(buf: PointBuffer, info: dict, slack: float = 1.0) -> None:
    """Fail closed if decoded positions violate the header bounds (a
    misdecoded compressed stream produces wild coordinates)."""
    b = info.get("bounds")
    if not b or buf.count == 0:
        return
    lo = np.asarray(b["min"], np.float64) - slack
    hi = np.asarray(b["max"], np.float64) + slack
    span = np.maximum(hi - lo, 1.0)
    lo = lo - 0.01 * span
    hi = hi + 0.01 * span
    if (buf.positions < lo).any() or (buf.positions > hi).any():
        raise LazUnsupported(
            "decoded points violate header bounds — stream corrupt or "
            "foreign encoding; refusing (fail-closed)")


def _build_records(positions, *, intensity=None, classification=None,
                   colors=None, gps_time=None, scale, offset,
                   point_format: int):
    """Raw LAS point records (formats 0-3) from arrays."""
    p = np.asarray(positions, np.float64).reshape(-1, 3)
    n = len(p)
    rec_len = _LAS_FORMAT_SIZE[point_format]
    raw = np.zeros((n, rec_len), np.uint8)
    xyz = np.round((p - np.asarray(offset)) / np.asarray(scale)).astype("<i4")
    raw[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    if intensity is not None:
        ii = (np.clip(np.asarray(intensity, np.float64), 0, 1)
              * 65535).astype("<u2")
        raw[:, 12:14] = ii.view(np.uint8).reshape(n, 2)
    raw[:, 14] = 1 | (1 << 3)  # return 1 of 1
    if classification is not None:
        raw[:, 15] = np.asarray(classification, np.uint8)
    off = 20
    if point_format in (1, 3):
        t = (np.asarray(gps_time, "<f8") if gps_time is not None
             else np.zeros(n, "<f8"))
        raw[:, off:off + 8] = t.view(np.uint8).reshape(n, 8)
        off += 8
    if point_format in (2, 3):
        if colors is not None:
            c = (np.clip(np.asarray(colors, np.float64), 0, 1)
                 * 65535).astype("<u2").reshape(n, 3)
        else:
            c = np.zeros((n, 3), "<u2")
        raw[:, off:off + 6] = c.view(np.uint8).reshape(n, 6)
    return raw.tobytes(), rec_len


def _las_header(n: int, point_format: int, rec_len: int, scale, offset,
                bounds_min, bounds_max, point_offset: int, n_vlrs: int,
                compressed: bool) -> bytes:
    head = bytearray(227)
    head[0:4] = b"LASF"
    head[24] = 1
    head[25] = 2
    struct.pack_into("<32s", head, 26, b"forge3d_tpu")
    struct.pack_into("<H", head, 94, 227)          # header size
    struct.pack_into("<I", head, 96, point_offset)
    struct.pack_into("<I", head, 100, n_vlrs)
    head[104] = point_format | (0x80 if compressed else 0)
    struct.pack_into("<H", head, 105, rec_len)
    struct.pack_into("<I", head, 107, n)
    struct.pack_into("<3d", head, 131, *scale)
    struct.pack_into("<3d", head, 155, *offset)
    struct.pack_into("<6d", head, 179,
                     bounds_max[0], bounds_min[0], bounds_max[1],
                     bounds_min[1], bounds_max[2], bounds_min[2])
    return bytes(head)


def write_las(path, positions, *, colors=None, intensity=None,
              classification=None, gps_time=None, compress: bool = False,
              scale=(0.001, 0.001, 0.001), point_format: Optional[int] = None,
              chunk_size: int = 50000) -> dict:
    """Write LAS 1.2 (optionally compressed with the native point codec).

    Returns {count, point_format, compressed, bytes}."""
    p = np.asarray(positions, np.float64).reshape(-1, 3)
    if point_format is None:
        has_rgb = colors is not None
        has_t = gps_time is not None
        point_format = (3 if has_rgb and has_t else
                        2 if has_rgb else 1 if has_t else 0)
    offset = np.floor(p.min(0))
    records, rec_len = _build_records(
        p, intensity=intensity, classification=classification,
        colors=colors, gps_time=gps_time, scale=scale, offset=offset,
        point_format=point_format)
    n = len(p)
    vlrs = b""
    n_vlrs = 0
    body = records
    if compress:
        from .codec.laz import (LAZ_VLR_RECORD_ID, LAZ_VLR_USER_ID,
                                build_laz_vlr_payload,
                                compress_point_records)

        payload = build_laz_vlr_payload(point_format, chunk_size)
        vlr_head = struct.pack("<H16sHH32s", 0, LAZ_VLR_USER_ID,
                               LAZ_VLR_RECORD_ID, len(payload),
                               b"forge3d_tpu laz")
        vlrs = vlr_head + payload
        n_vlrs = 1
        body = compress_point_records(records, n, point_format, chunk_size)
    point_offset = 227 + len(vlrs)
    head = _las_header(n, point_format, rec_len, scale, offset,
                       p.min(0), p.max(0), point_offset, n_vlrs, compress)
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(vlrs)
        fh.write(body)
    return {"count": n, "point_format": point_format,
            "compressed": compress, "bytes": point_offset + len(body)}


# -- COPC-layout container ---------------------------------------------------
# Octree-paged compressed point clouds: LAS header + copc info VLR + LAZ
# VLR + one compressed chunk per octree node + a copc hierarchy block of
# entries {key D-X-Y-Z, offset, byte_size, point_count}. Matches the COPC
# container architecture (reference reads COPC via src/pointcloud/); point
# records here are formats 0-3 (genuine COPC mandates 6-8 — those fail
# closed until the extended item codec lands).

_COPC_USER_ID = b"copc"


def write_copc(path, positions, *, colors=None, intensity=None,
               classification=None, leaf_size: int = 8192,
               max_depth: int = 6, scale=(0.001, 0.001, 0.001)) -> dict:
    """Write a COPC-layout octree-paged compressed point cloud."""
    from .codec.laz import (LAZ_VLR_RECORD_ID, LAZ_VLR_USER_ID,
                            build_laz_vlr_payload, compress_point_records)

    p = np.asarray(positions, np.float64).reshape(-1, 3)
    point_format = 2 if colors is not None else 0
    offset = np.floor(p.min(0))
    tree = PointOctree(p, leaf_size=leaf_size, max_depth=max_depth)

    # assign D-X-Y-Z keys by walking the tree the way it was built
    keys = {0: (0, 0, 0, 0)}
    order = []
    stack = [0]
    while stack:
        ni = stack.pop()
        order.append(ni)
        node = tree.nodes[ni]
        d, kx, ky, kz = keys[ni]
        for o, ci in enumerate(node["children"]):
            if ci >= 0:
                keys[ci] = (d + 1, 2 * kx + (o & 1), 2 * ky + ((o >> 1) & 1),
                            2 * kz + ((o >> 2) & 1))
                stack.append(ci)

    chunks = []
    entries = []
    for ni in order:
        idx = tree.nodes[ni]["points"]
        if idx is None or len(idx) == 0:
            continue
        sub = p[idx]
        cols = (np.asarray(colors)[idx] if colors is not None else None)
        inten = (np.asarray(intensity)[idx] if intensity is not None else None)
        cls = (np.asarray(classification)[idx]
               if classification is not None else None)
        records, rec_len = _build_records(
            sub, intensity=inten, classification=cls, colors=cols,
            scale=scale, offset=offset, point_format=point_format)
        blob = compress_point_records(records, len(sub), point_format,
                                      chunk_size=max(len(sub), 1))
        entries.append([keys[ni], len(blob), len(sub)])
        chunks.append(blob)

    laz_payload = build_laz_vlr_payload(point_format, chunk_size=1 << 30)
    laz_vlr = struct.pack("<H16sHH32s", 0, LAZ_VLR_USER_ID,
                          LAZ_VLR_RECORD_ID, len(laz_payload),
                          b"forge3d_tpu laz") + laz_payload
    # copc info VLR: center/halfsize/spacing + hierarchy root location
    lo, hi = p.min(0), p.max(0)
    center = (lo + hi) / 2
    halfsize = float(np.max(hi - lo) / 2) or 1.0
    info_payload = bytearray(160)
    struct.pack_into("<3d", info_payload, 0, *center)
    struct.pack_into("<d", info_payload, 24, halfsize)
    struct.pack_into("<d", info_payload, 32, halfsize / 128)
    copc_vlr = struct.pack("<H16sHH32s", 0, _COPC_USER_ID.ljust(16, b"\x00"),
                           1, len(info_payload),
                           b"copc info") + bytes(info_payload)
    vlrs = copc_vlr + laz_vlr
    point_offset = 227 + len(vlrs)

    # layout: chunks, then the hierarchy block
    offsets = []
    pos = point_offset
    for blob in chunks:
        offsets.append(pos)
        pos += len(blob)
    hier = bytearray()
    for (key, nbytes, npts), off in zip(entries, offsets):
        hier += struct.pack("<4i q i i", key[0], key[1], key[2], key[3],
                            off, nbytes, npts)
    rec_len = _LAS_FORMAT_SIZE[point_format]
    head = _las_header(len(p), point_format, rec_len, scale, offset,
                       lo, hi, point_offset, 2, True)
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(vlrs)
        for blob in chunks:
            fh.write(blob)
        hier_off = fh.tell()
        fh.write(struct.pack("<4sIQ", b"F3HB", len(entries), 0))
        fh.write(bytes(hier))
        # trailer pointing at the hierarchy block
        fh.write(struct.pack("<Q4s", hier_off, b"F3CP"))
    return {"count": len(p), "nodes": len(entries),
            "point_format": point_format}


def copc_hierarchy(path) -> dict:
    """Parse the COPC hierarchy: {key 'D-X-Y-Z': (offset, bytes, count)}."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"LASF":
        raise RenderError(f"not a LAS file: {path}")
    if data[-4:] != b"F3CP":
        raise LazUnsupported(
            "COPC hierarchy trailer missing — genuine COPC files (point "
            "formats 6-8, laszip layered chunks) are not supported yet; "
            "re-encode with forge3d_tpu.pointcloud.write_copc")
    (hier_off,) = struct.unpack_from("<Q", data, len(data) - 12)
    magic, n_entries, _ = struct.unpack_from("<4sIQ", data, hier_off)
    if magic != b"F3HB":
        raise LazUnsupported("corrupt COPC hierarchy block")
    out = {}
    pos = hier_off + 16
    for _ in range(n_entries):
        d, x, y, z, off, nbytes, npts = struct.unpack_from("<4iqii", data, pos)
        pos += 32
        out[f"{d}-{x}-{y}-{z}"] = (off, nbytes, npts)
    return out


def copc_read_node_points(path, node: str = "0-0-0-0", **kw) -> PointBuffer:
    """Read one octree node's points from a COPC-layout file
    (reference seam: copc_read_node_points_py)."""
    info = read_laz_points_info(path)
    if not info["compressed"]:
        # plain LAS masquerading as COPC: serve the points directly
        return read_las_points(path, **kw)
    from .codec.laz import (LAZ_VLR_RECORD_ID, LazCodecError,
                            decompress_point_records, parse_laz_vlr_payload)

    hier = copc_hierarchy(path)
    if node not in hier:
        raise RenderError(f"COPC node {node} not present; "
                          f"have {sorted(hier)[:8]}...")
    off, nbytes, npts = hier[node]
    fmt = info["point_format"]
    if fmt not in (0, 1, 2, 3):
        raise LazUnsupported(
            f"COPC point format {fmt} not supported yet (formats 0-3)")
    with open(path, "rb") as fh:
        head = fh.read(375)
        vlr = next((p for u, r, p in _read_vlrs(fh, head)
                    if r == LAZ_VLR_RECORD_ID), None)
        if vlr is None:
            raise LazUnsupported("COPC without LAZ VLR")
        meta = parse_laz_vlr_payload(vlr)
        if meta["foreign"]:
            raise LazUnsupported(
                "genuine LASzip item versions are refused (fail-closed)")
        fh.seek(off)
        blob = fh.read(nbytes)
    try:
        rec = decompress_point_records(blob, npts, fmt, max(npts, 1))
    except LazCodecError as e:
        raise LazUnsupported(str(e)) from None
    rec_len = _LAS_FORMAT_SIZE[fmt]
    raw = np.frombuffer(rec, np.uint8).reshape(npts, rec_len)
    buf = _decode_records(raw, fmt, rec_len, info, npts)
    _bounds_check(buf, info)
    return buf


def read_laz_point_attributes(path) -> dict:
    """Attribute schema probe (reference seam:
    read_laz_point_attributes_py): names/types available per point format."""
    info = read_laz_points_info(path)
    fmt = info["point_format"]
    attrs = ["x", "y", "z", "intensity", "return_number", "classification"]
    if fmt in (1, 3, 4, 5) or fmt >= 6:
        attrs.append("gps_time")
    if info["has_rgb"]:
        attrs += ["red", "green", "blue"]
    return {**info, "attributes": attrs}
