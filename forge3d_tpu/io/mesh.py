# forge3d_tpu/io/mesh.py
# Mesh file I/O: OBJ, PLY (ascii + binary), STL (ascii + binary), glTF/GLB.
#
# Parity notes (reference behavior, not code): /root/reference/src/io/mod.rs
# registers OBJ read/write, PLY read/write, STL write, glTF read (KHR
# extensions per Cargo.toml:88). Host-side and device-independent; meshes feed
# the SAH BVH (ops/bvh.py) and the mesh path tracer.

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "MeshData",
    "load_obj", "save_obj",
    "load_ply", "save_ply",
    "load_stl", "save_stl",
    "load_gltf",
    "load_mesh", "save_mesh",
]


@dataclass
class MeshData:
    """Triangle mesh interchange container.

    vertices: (N,3) float32; indices: (M,3) uint32; optional normals (N,3),
    uvs (N,2), vertex colors (N,3|4) in [0,1].
    """

    vertices: np.ndarray
    indices: np.ndarray
    normals: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    name: str = ""
    materials: Dict[str, dict] = field(default_factory=dict)

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, np.float32).reshape(-1, 3)
        self.indices = np.ascontiguousarray(self.indices, np.uint32).reshape(-1, 3)
        if self.normals is not None:
            self.normals = np.ascontiguousarray(self.normals, np.float32).reshape(-1, 3)
        if self.uvs is not None:
            self.uvs = np.ascontiguousarray(self.uvs, np.float32).reshape(-1, 2)

    @property
    def triangle_count(self) -> int:
        return int(self.indices.shape[0])

    @property
    def vertex_count(self) -> int:
        return int(self.vertices.shape[0])

    def compute_normals(self) -> np.ndarray:
        """Area-weighted smooth vertex normals (deterministic accumulation)."""
        v, f = self.vertices, self.indices.astype(np.int64)
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, f[:, k], fn)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        self.normals = (n / np.maximum(norm, 1e-20)).astype(np.float32)
        return self.normals


# ---------------------------------------------------------------------------
# OBJ


def load_obj(path) -> MeshData:
    """Wavefront OBJ reader: v/vt/vn + f with arbitrary polygon fan
    triangulation and negative-index support."""
    verts: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    # OBJ indexes v/vt/vn independently; re-index to a single vertex stream.
    corner_map: Dict[tuple, int] = {}
    out_v: List[List[float]] = []
    out_vt: List[List[float]] = []
    out_vn: List[List[float]] = []
    faces: List[List[int]] = []
    has_vt = has_vn = False
    name = ""

    def corner(tok: str) -> int:
        nonlocal has_vt, has_vn
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(verts) + vi
        ti = ni = -1
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(uvs) + ti
            has_vt = True
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(normals) + ni
            has_vn = True
        key = (vi, ti, ni)
        idx = corner_map.get(key)
        if idx is None:
            idx = len(out_v)
            corner_map[key] = idx
            out_v.append(verts[vi])
            out_vt.append(uvs[ti] if ti >= 0 else [0.0, 0.0])
            out_vn.append(normals[ni] if ni >= 0 else [0.0, 0.0, 0.0])
        return idx

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if tok[0] == "v" and len(tok) >= 4:
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "vt" and len(tok) >= 3:
                uvs.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "vn" and len(tok) >= 4:
                normals.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "f" and len(tok) >= 4:
                ids = [corner(t) for t in tok[1:]]
                for k in range(1, len(ids) - 1):  # fan triangulation
                    faces.append([ids[0], ids[k], ids[k + 1]])
            elif tok[0] in ("o", "g") and len(tok) > 1 and not name:
                name = tok[1]

    if not faces:
        raise ValueError(f"OBJ has no faces: {path}")
    return MeshData(
        vertices=np.asarray(out_v, np.float32),
        indices=np.asarray(faces, np.uint32),
        normals=np.asarray(out_vn, np.float32) if has_vn else None,
        uvs=np.asarray(out_vt, np.float32) if has_vt else None,
        name=name or Path(str(path)).stem,
    )


def save_obj(path, mesh: MeshData) -> None:
    with open(path, "w") as fh:
        fh.write("# forge3d_tpu OBJ export\n")
        if mesh.name:
            fh.write(f"o {mesh.name}\n")
        for v in mesh.vertices:
            fh.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        if mesh.uvs is not None:
            for t in mesh.uvs:
                fh.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        if mesh.normals is not None:
            for n in mesh.normals:
                fh.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        has_t, has_n = mesh.uvs is not None, mesh.normals is not None
        for f in mesh.indices:
            ids = [int(i) + 1 for i in f]
            if has_t and has_n:
                fh.write("f " + " ".join(f"{i}/{i}/{i}" for i in ids) + "\n")
            elif has_n:
                fh.write("f " + " ".join(f"{i}//{i}" for i in ids) + "\n")
            elif has_t:
                fh.write("f " + " ".join(f"{i}/{i}" for i in ids) + "\n")
            else:
                fh.write("f " + " ".join(str(i) for i in ids) + "\n")


# ---------------------------------------------------------------------------
# PLY


def load_ply(path) -> MeshData:
    """PLY reader: format ascii 1.0 and binary_little_endian 1.0; vertex
    x/y/z (+nx/ny/nz, u/v|s/t, red/green/blue[/alpha]) and face
    vertex_indices lists."""
    with open(path, "rb") as fh:
        magic = fh.readline().strip()
        if magic != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements: List[tuple] = []  # (name, count, [(type, name) or ('list', ctype, itype, name)])
        cur_props: List[tuple] = []
        while True:
            line = fh.readline()
            if not line:
                raise ValueError("PLY: unexpected EOF in header")
            tok = line.decode("ascii", "replace").split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur_props = []
                elements.append((tok[1], int(tok[2]), cur_props))
            elif tok[0] == "property":
                if tok[1] == "list":
                    cur_props.append(("list", tok[2], tok[3], tok[4]))
                else:
                    cur_props.append((tok[1], tok[2]))
            elif tok[0] == "end_header":
                break

        _NP = {"char": np.int8, "int8": np.int8, "uchar": np.uint8, "uint8": np.uint8,
               "short": np.int16, "int16": np.int16, "ushort": np.uint16,
               "uint16": np.uint16, "int": np.int32, "int32": np.int32,
               "uint": np.uint32, "uint32": np.uint32, "float": np.float32,
               "float32": np.float32, "double": np.float64, "float64": np.float64}

        data: Dict[str, dict] = {}
        if fmt == "ascii":
            for ename, count, props in elements:
                cols: Dict[str, list] = {p[-1]: [] for p in props}
                for _ in range(count):
                    tok = fh.readline().split()
                    i = 0
                    for p in props:
                        if p[0] == "list":
                            n = int(tok[i]); i += 1
                            cols[p[3]].append([float(t) for t in tok[i:i + n]])
                            i += n
                        else:
                            cols[p[1]].append(float(tok[i])); i += 1
                data[ename] = cols
        elif fmt == "binary_little_endian":
            for ename, count, props in elements:
                cols = {p[-1]: [] for p in props}
                fixed = all(p[0] != "list" for p in props)
                if fixed:
                    dt = np.dtype([(p[1], np.dtype(_NP[p[0]]).newbyteorder("<")) for p in props])
                    arr = np.frombuffer(fh.read(dt.itemsize * count), dtype=dt, count=count)
                    for p in props:
                        cols[p[1]] = arr[p[1]]
                else:
                    for _ in range(count):
                        for p in props:
                            if p[0] == "list":
                                cdt = np.dtype(_NP[p[1]]).newbyteorder("<")
                                n = int(np.frombuffer(fh.read(cdt.itemsize), cdt)[0])
                                idt = np.dtype(_NP[p[2]]).newbyteorder("<")
                                cols[p[3]].append(
                                    np.frombuffer(fh.read(idt.itemsize * n), idt, n).tolist())
                            else:
                                pdt = np.dtype(_NP[p[0]]).newbyteorder("<")
                                cols[p[1]].append(float(np.frombuffer(fh.read(pdt.itemsize), pdt)[0]))
                data[ename] = cols
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")

    vcols = data.get("vertex", {})
    if not vcols:
        raise ValueError("PLY has no vertex element")
    verts = np.stack([np.asarray(vcols[k], np.float32) for k in ("x", "y", "z")], axis=1)
    normals = None
    if all(k in vcols for k in ("nx", "ny", "nz")):
        normals = np.stack([np.asarray(vcols[k], np.float32) for k in ("nx", "ny", "nz")], axis=1)
    uvs = None
    for ku, kv in (("u", "v"), ("s", "t")):
        if ku in vcols and kv in vcols:
            uvs = np.stack([np.asarray(vcols[ku], np.float32),
                            np.asarray(vcols[kv], np.float32)], axis=1)
            break
    colors = None
    if all(k in vcols for k in ("red", "green", "blue")):
        colors = np.stack([np.asarray(vcols[k], np.float32) for k in ("red", "green", "blue")],
                          axis=1) / 255.0

    faces: List[List[int]] = []
    fcols = data.get("face", {})
    lists = fcols.get("vertex_indices", fcols.get("vertex_index", []))
    for poly in lists:
        ids = [int(i) for i in poly]
        for k in range(1, len(ids) - 1):
            faces.append([ids[0], ids[k], ids[k + 1]])
    if not faces:
        raise ValueError("PLY has no faces")
    return MeshData(vertices=verts, indices=np.asarray(faces, np.uint32),
                    normals=normals, uvs=uvs, colors=colors,
                    name=Path(str(path)).stem)


def save_ply(path, mesh: MeshData, *, binary: bool = True) -> None:
    n, m = mesh.vertex_count, mesh.triangle_count
    props = ["property float x", "property float y", "property float z"]
    cols = [mesh.vertices]
    if mesh.normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(mesh.normals)
    if mesh.uvs is not None:
        props += ["property float u", "property float v"]
        cols.append(mesh.uvs)
    vdata = np.concatenate(cols, axis=1).astype("<f4")
    fmt = "binary_little_endian" if binary else "ascii"
    header = (f"ply\nformat {fmt} 1.0\ncomment forge3d_tpu\n"
              f"element vertex {n}\n" + "\n".join(props) + "\n"
              f"element face {m}\nproperty list uchar uint vertex_indices\n"
              "end_header\n")
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if binary:
            fh.write(vdata.tobytes())
            face_dt = np.dtype([("n", np.uint8), ("i", "<u4", (3,))])
            farr = np.empty(m, face_dt)
            farr["n"] = 3
            farr["i"] = mesh.indices
            fh.write(farr.tobytes())
        else:
            for row in vdata:
                fh.write((" ".join(f"{x:.9g}" for x in row) + "\n").encode())
            for f in mesh.indices:
                fh.write(f"3 {f[0]} {f[1]} {f[2]}\n".encode())


# ---------------------------------------------------------------------------
# STL


def load_stl(path) -> MeshData:
    with open(path, "rb") as fh:
        head = fh.read(84)
        if len(head) >= 84:
            (ntri,) = struct.unpack_from("<I", head, 80)
            expect = 84 + ntri * 50
            import os
            if os.path.getsize(path) == expect and not head[:5] == b"solid":
                return _load_stl_binary(path, ntri)
            if os.path.getsize(path) == expect and ntri > 0:
                return _load_stl_binary(path, ntri)  # 'solid'-prefixed binary
    return _load_stl_ascii(path)


def _load_stl_binary(path, ntri: int) -> MeshData:
    dt = np.dtype([("n", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")])
    with open(path, "rb") as fh:
        fh.seek(84)
        rec = np.frombuffer(fh.read(ntri * 50), dtype=dt, count=ntri)
    verts = rec["v"].reshape(-1, 3)
    idx = np.arange(ntri * 3, dtype=np.uint32).reshape(-1, 3)
    return MeshData(vertices=verts.copy(), indices=idx, name=Path(str(path)).stem)


def _load_stl_ascii(path) -> MeshData:
    verts: List[List[float]] = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            tok = line.split()
            if tok and tok[0] == "vertex":
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
    if len(verts) < 3:
        raise ValueError(f"STL has no triangles: {path}")
    ntri = len(verts) // 3
    idx = np.arange(ntri * 3, dtype=np.uint32).reshape(-1, 3)
    return MeshData(vertices=np.asarray(verts[: ntri * 3], np.float32), indices=idx,
                    name=Path(str(path)).stem)


def save_stl(path, mesh: MeshData, *, binary: bool = True) -> None:
    v = mesh.vertices[mesh.indices.astype(np.int64)]  # (M,3,3)
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    if binary:
        dt = np.dtype([("n", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")])
        rec = np.zeros(len(v), dt)
        rec["n"], rec["v"] = fn, v
        with open(path, "wb") as fh:
            fh.write(b"forge3d_tpu binary STL".ljust(80, b"\0"))
            fh.write(struct.pack("<I", len(v)))
            fh.write(rec.tobytes())
    else:
        with open(path, "w") as fh:
            fh.write(f"solid {mesh.name or 'mesh'}\n")
            for i in range(len(v)):
                fh.write(f"  facet normal {fn[i,0]:.9g} {fn[i,1]:.9g} {fn[i,2]:.9g}\n")
                fh.write("    outer loop\n")
                for k in range(3):
                    fh.write(f"      vertex {v[i,k,0]:.9g} {v[i,k,1]:.9g} {v[i,k,2]:.9g}\n")
                fh.write("    endloop\n  endfacet\n")
            fh.write(f"endsolid {mesh.name or 'mesh'}\n")


# ---------------------------------------------------------------------------
# glTF 2.0 (.gltf JSON + .bin, data: URIs, and .glb binary container)

_GLTF_COMPONENT = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
                   5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


def load_gltf(path) -> List[MeshData]:
    """glTF 2.0 reader returning one MeshData per mesh primitive, with node
    transforms applied (scene-graph flattened; KHR punctual lights ignored)."""
    path = Path(str(path))
    if path.suffix.lower() == ".glb":
        gltf, buffers = _read_glb(path)
    else:
        gltf = json.loads(path.read_text())
        buffers = []
        for buf in gltf.get("buffers", []):
            uri = buf.get("uri", "")
            if uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                buffers.append((path.parent / uri).read_bytes())

    def accessor(idx: int) -> np.ndarray:
        acc = gltf["accessors"][idx]
        bv = gltf["bufferViews"][acc["bufferView"]]
        dtype = np.dtype(_GLTF_COMPONENT[acc["componentType"]]).newbyteorder("<")
        ncomp = _GLTF_NCOMP[acc["type"]]
        count = acc["count"]
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or dtype.itemsize * ncomp
        raw = buffers[bv["buffer"]]
        if stride == dtype.itemsize * ncomp:
            arr = np.frombuffer(raw, dtype, count * ncomp, offset)
        else:  # interleaved
            rows = [np.frombuffer(raw, dtype, ncomp, offset + i * stride) for i in range(count)]
            arr = np.concatenate(rows)
        return arr.reshape(count, ncomp) if ncomp > 1 else arr

    def node_matrix(node: dict) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        M = np.eye(4)
        t = node.get("translation", [0, 0, 0])
        q = node.get("rotation", [0, 0, 0, 1])  # x y z w
        s = node.get("scale", [1, 1, 1])
        x, y, z, w = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        M[:3, :3] = R @ np.diag(s)
        M[:3, 3] = t
        return M

    out: List[MeshData] = []

    def emit(mesh_idx: int, M: np.ndarray, name: str):
        mesh = gltf["meshes"][mesh_idx]
        for pi, prim in enumerate(mesh.get("primitives", [])):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = prim["attributes"]
            pos = accessor(attrs["POSITION"]).astype(np.float32)
            pos_h = pos @ M[:3, :3].T + M[:3, 3]
            if "indices" in prim:
                idx = accessor(prim["indices"]).astype(np.uint32).reshape(-1, 3)
            else:
                idx = np.arange(len(pos), dtype=np.uint32).reshape(-1, 3)
            normals = None
            if "NORMAL" in attrs:
                NM = np.linalg.inv(M[:3, :3]).T
                nrm = accessor(attrs["NORMAL"]).astype(np.float32) @ NM.T
                normals = (nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                                            1e-20)).astype(np.float32)
            uvs = accessor(attrs["TEXCOORD_0"]).astype(np.float32) if "TEXCOORD_0" in attrs else None
            out.append(MeshData(vertices=pos_h.astype(np.float32), indices=idx,
                                normals=normals, uvs=uvs,
                                name=name or mesh.get("name", f"mesh{mesh_idx}.{pi}")))

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        M = parent @ node_matrix(node)
        if "mesh" in node:
            emit(node["mesh"], M, node.get("name", ""))
        for child in node.get("children", []):
            walk(child, M)

    scenes = gltf.get("scenes", [])
    scene = scenes[gltf.get("scene", 0)] if scenes else {"nodes": []}
    roots = scene.get("nodes", [])
    if roots:
        for r in roots:
            walk(r, np.eye(4))
    else:  # no scene graph: emit raw meshes
        for mi in range(len(gltf.get("meshes", []))):
            emit(mi, np.eye(4), "")
    if not out:
        raise ValueError(f"glTF contains no triangle primitives: {path}")
    return out


def _read_glb(path: Path):
    raw = path.read_bytes()
    magic, version, _length = struct.unpack_from("<III", raw, 0)
    if magic != 0x46546C67:
        raise ValueError(f"not a GLB file: {path}")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset, gltf, bin_chunk = 12, None, b""
    while offset + 8 <= len(raw):
        clen, ctype = struct.unpack_from("<II", raw, offset)
        chunk = raw[offset + 8: offset + 8 + clen]
        if ctype == 0x4E4F534A:  # JSON
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # BIN
            bin_chunk = chunk
        offset += 8 + clen + ((4 - clen % 4) % 4)  # chunks are 4-byte aligned
    if gltf is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf, [bin_chunk]


# ---------------------------------------------------------------------------
# dispatch

_LOADERS = {".obj": load_obj, ".ply": load_ply, ".stl": load_stl}


def load_mesh(path) -> MeshData:
    """Load a single mesh by extension (glTF returns the concatenation)."""
    ext = Path(str(path)).suffix.lower()
    if ext in (".gltf", ".glb"):
        meshes = load_gltf(path)
        if len(meshes) == 1:
            return meshes[0]
        return merge_meshes(meshes)
    try:
        loader = _LOADERS[ext]
    except KeyError:
        raise ValueError(f"unsupported mesh format: {ext}") from None
    return loader(path)


def save_mesh(path, mesh: MeshData, **kw) -> None:
    ext = Path(str(path)).suffix.lower()
    savers = {".obj": save_obj, ".ply": save_ply, ".stl": save_stl}
    try:
        saver = savers[ext]
    except KeyError:
        raise ValueError(f"unsupported mesh format: {ext}") from None
    saver(path, mesh, **kw)


def merge_meshes(meshes: List[MeshData]) -> MeshData:
    """Concatenate meshes into one buffer (index-offset correct)."""
    vs, fs, off = [], [], 0
    all_n = all(m.normals is not None for m in meshes)
    all_t = all(m.uvs is not None for m in meshes)
    ns, ts = [], []
    for m in meshes:
        vs.append(m.vertices)
        fs.append(m.indices.astype(np.uint64) + off)
        if all_n:
            ns.append(m.normals)
        if all_t:
            ts.append(m.uvs)
        off += m.vertex_count
    return MeshData(
        vertices=np.concatenate(vs),
        indices=np.concatenate(fs).astype(np.uint32),
        normals=np.concatenate(ns) if all_n else None,
        uvs=np.concatenate(ts) if all_t else None,
        name=meshes[0].name if meshes else "",
    )
