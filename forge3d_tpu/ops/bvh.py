# forge3d_tpu/ops/bvh.py
# Triangle-mesh BVH: host-side binned-SAH build + stackless device
# traversal.
#
# Parity notes (reference behavior, not code):
#   - CPU binned SAH build + refit: /root/reference/src/accel/sah_cpu.rs
#   - GPU LBVH (morton/radix-sort/link/refit): src/accel/lbvh_gpu.rs — on
#     this engine a host SAH build wins: builds are per-scene-change (rare), the
#     quality matters for traversal (every frame), and the flattened arrays
#     upload once.
#   - unified builder with CPU fallback: src/accel/mod.rs:31-60.
#
# Design: the tree is flattened depth-first and *threaded* —
# every node stores `miss_link` (where to go when its AABB is not hit; the
# DFS successor skipping the subtree). Traversal is then a single
# lax.while_loop with per-ray state = one node index: hit an interior node
# -> advance to node+1 (first child); miss -> jump to miss_link; leaf ->
# test its triangles, then jump to miss_link. No stack, uniform per-lane
# work, one gather per step — same design language as the heightfield DDA
# in ops/traversal.py.

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_LEAF_SIZE = 4
_N_BINS = 12


@dataclass(frozen=True)
class BvhArrays:
    """Flattened threaded BVH (host numpy; upload once for traversal)."""

    bounds_min: np.ndarray   # (n_nodes, 3) f32
    bounds_max: np.ndarray   # (n_nodes, 3) f32
    first: np.ndarray        # (n_nodes,) i32: first prim (leaf) | unused
    count: np.ndarray        # (n_nodes,) i32: prim count (0 = interior)
    miss_link: np.ndarray    # (n_nodes,) i32: DFS successor skipping subtree
    prim_index: np.ndarray   # (n_prims,) i32: permutation into triangles
    tri_v0: np.ndarray       # (n_prims, 3) f32 (reordered by prim_index)
    tri_e1: np.ndarray       # (n_prims, 3) f32: v1 - v0
    tri_e2: np.ndarray       # (n_prims, 3) f32: v2 - v0
    triangle_count: int
    node_count: int
    world_aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]
    stats: dict

    @property
    def nbytes(self) -> int:
        return sum(
            a.nbytes
            for a in (self.bounds_min, self.bounds_max, self.first, self.count,
                      self.miss_link, self.prim_index, self.tri_v0, self.tri_e1,
                      self.tri_e2)
        )


def build_sah_bvh(vertices: np.ndarray, indices: np.ndarray) -> BvhArrays:
    """Binned-SAH top-down build (host). vertices (V,3) f32, indices (T,3)."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.uint32)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError("vertices must be (V, 3)")
    if indices.ndim != 2 or indices.shape[1] != 3:
        raise ValueError("indices must be (T, 3)")
    if indices.size and int(indices.max()) >= len(vertices):
        raise ValueError("triangle index out of range")
    T = len(indices)
    if T == 0:
        raise ValueError("mesh has no triangles")

    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5

    order = np.arange(T, dtype=np.int32)

    # Nodes accumulated in DFS order: (min, max, first, count, parent_end)
    nmin, nmax, nfirst, ncount = [], [], [], []
    # children resolved by construction: interior node's first child is the
    # next DFS node; we record subtree sizes to thread miss links after.
    subtree_size = []

    def sah_split(lo: int, hi: int):
        """Return (axis, split_pos such that [lo,split) left) or None."""
        n = hi - lo
        idx = order[lo:hi]
        cmin = centroid[idx].min(0)
        cmax = centroid[idx].max(0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            return None
        # binned SAH along axis
        scale = _N_BINS * (1.0 - 1e-6) / ext[axis]
        bins = np.minimum(
            ((centroid[idx, axis] - cmin[axis]) * scale).astype(np.int32),
            _N_BINS - 1,
        )
        bin_counts = np.bincount(bins, minlength=_N_BINS)
        bmin = np.full((_N_BINS, 3), np.inf, np.float32)
        bmax = np.full((_N_BINS, 3), -np.inf, np.float32)
        for bi in range(_N_BINS):
            m = bins == bi
            if m.any():
                bmin[bi] = tmin[idx[m]].min(0)
                bmax[bi] = tmax[idx[m]].max(0)

        # prefix/suffix areas
        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

        lmin = np.minimum.accumulate(bmin, 0)
        lmax = np.maximum.accumulate(bmax, 0)
        rmin = np.minimum.accumulate(bmin[::-1], 0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], 0)[::-1]
        lcnt = np.cumsum(bin_counts)
        rcnt = np.cumsum(bin_counts[::-1])[::-1]
        cost = np.full(_N_BINS - 1, np.inf)
        for s in range(_N_BINS - 1):
            if lcnt[s] == 0 or rcnt[s + 1] == 0:
                continue
            cost[s] = lcnt[s] * area(lmin[s], lmax[s]) + rcnt[s + 1] * area(
                rmin[s + 1], rmax[s + 1]
            )
        leaf_cost = n * area(tmin[idx].min(0), tmax[idx].max(0))
        s = int(np.argmin(cost))
        if not np.isfinite(cost[s]) or (n <= _LEAF_SIZE and cost[s] >= leaf_cost):
            return None
        sel = bins <= s
        left = idx[sel]
        right = idx[~sel]
        if len(left) == 0 or len(right) == 0:
            return None
        order[lo:lo + len(left)] = left
        order[lo + len(left):hi] = right
        return lo + len(left)

    max_depth = 0

    def build(lo: int, hi: int, depth: int) -> int:
        """Emit node for range [lo, hi); return subtree node count."""
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        my = len(nmin)
        idx = order[lo:hi]
        nmin.append(tmin[idx].min(0))
        nmax.append(tmax[idx].max(0))
        nfirst.append(lo)
        ncount.append(0)
        subtree_size.append(0)
        n = hi - lo
        split = None
        if n > _LEAF_SIZE or n > 1:
            split = sah_split(lo, hi)
        if split is None and n > _LEAF_SIZE:
            split = lo + n // 2  # median fallback keeps depth bounded
        if split is None:
            ncount[my] = n
            subtree_size[my] = 1
            return 1
        left = build(lo, split, depth + 1)
        right = build(split, hi, depth + 1)
        subtree_size[my] = 1 + left + right
        return subtree_size[my]

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(0, T, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(nmin)
    miss = np.zeros(n_nodes, np.int32)

    def thread(node: int, succ: int) -> None:
        miss[node] = succ
        if ncount[node] == 0:
            left = node + 1
            right = left + subtree_size[left]
            thread(left, right)
            thread(right, succ)

    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        thread(0, n_nodes)
    finally:
        sys.setrecursionlimit(old_limit)

    perm = order.copy()
    rv0 = v0[perm]
    leaf_count = int(sum(1 for c in ncount if c > 0))
    return BvhArrays(
        bounds_min=np.asarray(nmin, np.float32),
        bounds_max=np.asarray(nmax, np.float32),
        first=np.asarray(nfirst, np.int32),
        count=np.asarray(ncount, np.int32),
        miss_link=miss,
        prim_index=perm,
        tri_v0=rv0,
        tri_e1=(v1 - v0)[perm],
        tri_e2=(v2 - v0)[perm],
        triangle_count=T,
        node_count=n_nodes,
        world_aabb=(tuple(map(float, tmin.min(0))), tuple(map(float, tmax.max(0)))),
        stats={"max_depth": int(max_depth), "leaf_count": leaf_count,
               "max_leaf_size": int(max(ncount) if ncount else 0)},
    )


def refit_bvh(bvh: BvhArrays, vertices: np.ndarray, indices: np.ndarray) -> BvhArrays:
    """Refit node bounds to moved vertices, keeping topology
    (reference: CpuSahBuilder::refit, sah_cpu.rs:99)."""
    vertices = np.asarray(vertices, np.float32)
    v0 = vertices[indices[:, 0]][bvh.prim_index]
    v1 = vertices[indices[:, 1]][bvh.prim_index]
    v2 = vertices[indices[:, 2]][bvh.prim_index]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    n = bvh.node_count
    bmin = bvh.bounds_min.copy()
    bmax = bvh.bounds_max.copy()
    # DFS order means children follow parents; walk backwards to refit.
    # Leaves refit from triangles; interiors from their two children.
    child_of = {}
    for i in range(n):
        if bvh.count[i] == 0:
            left = i + 1
            # right sibling = node whose miss_link-threaded DFS places it
            # after left's subtree; recover via miss threading:
            right = bvh.miss_link[left] if bvh.miss_link[left] != bvh.miss_link[i] else left
            child_of[i] = (left, right)
    for i in range(n - 1, -1, -1):
        c = bvh.count[i]
        if c > 0:
            f = bvh.first[i]
            bmin[i] = tmin[f:f + c].min(0)
            bmax[i] = tmax[f:f + c].max(0)
        else:
            l, r = child_of[i]
            bmin[i] = np.minimum(bmin[l], bmin[r])
            bmax[i] = np.maximum(bmax[l], bmax[r])
    return BvhArrays(
        bounds_min=bmin, bounds_max=bmax, first=bvh.first, count=bvh.count,
        miss_link=bvh.miss_link, prim_index=bvh.prim_index,
        tri_v0=v0, tri_e1=v1 - v0, tri_e2=v2 - v0,
        triangle_count=bvh.triangle_count, node_count=bvh.node_count,
        world_aabb=(tuple(map(float, tmin.min(0))), tuple(map(float, tmax.max(0)))),
        stats=bvh.stats,
    )


# ---------------------------------------------------------------------------
# Device traversal
# ---------------------------------------------------------------------------

class MeshScene(NamedTuple):
    """Device-resident flattened BVH + triangles."""

    bounds_min: jax.Array   # (n_nodes, 3)
    bounds_max: jax.Array
    first: jax.Array        # (n_nodes,)
    count: jax.Array
    miss_link: jax.Array
    tri_v0: jax.Array       # (n_prims, 3)
    tri_e1: jax.Array
    tri_e2: jax.Array


def mesh_scene(bvh: BvhArrays) -> Tuple[MeshScene, int]:
    scene = MeshScene(
        bounds_min=jnp.asarray(bvh.bounds_min),
        bounds_max=jnp.asarray(bvh.bounds_max),
        first=jnp.asarray(bvh.first),
        count=jnp.asarray(bvh.count),
        miss_link=jnp.asarray(bvh.miss_link),
        tri_v0=jnp.asarray(bvh.tri_v0),
        tri_e1=jnp.asarray(bvh.tri_e1),
        tri_e2=jnp.asarray(bvh.tri_e2),
    )
    return scene, bvh.node_count


class MeshHit(NamedTuple):
    hit: jax.Array    # bool
    t: jax.Array      # f32
    prim: jax.Array   # i32 (reordered-primitive id; map back via prim_index)
    u: jax.Array      # f32 barycentric
    v: jax.Array


def _moller_trumbore(scene: MeshScene, pid, ro, rd, tmin, tmax):
    """Watertight-enough Möller-Trumbore for one gathered triangle per lane."""
    v0 = tuple(jnp.take(scene.tri_v0[:, c], pid) for c in range(3))
    e1 = tuple(jnp.take(scene.tri_e1[:, c], pid) for c in range(3))
    e2 = tuple(jnp.take(scene.tri_e2[:, c], pid) for c in range(3))
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    # p = rd x e2
    px = rdy * e2[2] - rdz * e2[1]
    py = rdz * e2[0] - rdx * e2[2]
    pz = rdx * e2[1] - rdy * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    sx, sy, sz = rox - v0[0], roy - v0[1], roz - v0[2]
    u = (sx * px + sy * py + sz * pz) * inv_det
    # q = s x e1
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    ok = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin) & (t < tmax)
    )
    return ok, t, u, v


def trace_mesh(scene: MeshScene, n_nodes: int, ro, rd, tmin=1e-4, tmax=1e30,
               max_leaf_size: int = _LEAF_SIZE, max_iters: int = 0) -> MeshHit:
    """Stackless threaded-BVH traversal; any ray-array shape."""
    rox, roy, roz = (jnp.asarray(x, jnp.float32) for x in ro)
    rdx, rdy, rdz = (jnp.asarray(x, jnp.float32) for x in rd)
    shape = jnp.broadcast_shapes(rox.shape, rdx.shape)
    rox, roy, roz, rdx, rdy, rdz = (
        jnp.broadcast_to(a, shape) for a in (rox, roy, roz, rdx, rdy, rdz)
    )
    if max_iters <= 0:
        max_iters = 4 * n_nodes + 64

    inv = lambda d: jnp.where(
        jnp.abs(d) > 1e-12, 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1.0),
        jnp.where(d >= 0, 1e12, -1e12),
    )
    ix, iy, iz = inv(rdx), inv(rdy), inv(rdz)

    state = dict(
        node=jnp.zeros(shape, jnp.int32),
        best_t=jnp.full(shape, tmax, jnp.float32),
        prim=jnp.full(shape, -1, jnp.int32),
        u=jnp.zeros(shape, jnp.float32),
        v=jnp.zeros(shape, jnp.float32),
        iters=jnp.asarray(0, jnp.int32),
    )

    def cond(s):
        return (~jnp.all(s["node"] >= n_nodes)) & (s["iters"] < max_iters)

    def body(s):
        node = jnp.minimum(s["node"], n_nodes - 1)
        live = s["node"] < n_nodes
        g = lambda arr: jnp.take(arr, node)
        bminx = jnp.take(scene.bounds_min[:, 0], node)
        bminy = jnp.take(scene.bounds_min[:, 1], node)
        bminz = jnp.take(scene.bounds_min[:, 2], node)
        bmaxx = jnp.take(scene.bounds_max[:, 0], node)
        bmaxy = jnp.take(scene.bounds_max[:, 1], node)
        bmaxz = jnp.take(scene.bounds_max[:, 2], node)
        t0x = (bminx - rox) * ix
        t1x = (bmaxx - rox) * ix
        t0y = (bminy - roy) * iy
        t1y = (bmaxy - roy) * iy
        t0z = (bminz - roz) * iz
        t1z = (bmaxz - roz) * iz
        t_enter = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.maximum(jnp.minimum(t0z, t1z), tmin),
        )
        t_exit = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.minimum(jnp.maximum(t0z, t1z), s["best_t"]),
        )
        box_hit = t_enter <= t_exit

        cnt = g(scene.count)
        fst = g(scene.first)
        is_leaf = cnt > 0

        best_t, prim, uu, vv = s["best_t"], s["prim"], s["u"], s["v"]
        for k in range(max_leaf_size):
            pid = jnp.minimum(fst + k, scene.tri_v0.shape[0] - 1)
            active = live & box_hit & is_leaf & (k < cnt)
            ok, t, tu, tv = _moller_trumbore(
                scene, pid, (rox, roy, roz), (rdx, rdy, rdz), tmin, best_t
            )
            take = active & ok
            best_t = jnp.where(take, t, best_t)
            prim = jnp.where(take, pid, prim)
            uu = jnp.where(take, tu, uu)
            vv = jnp.where(take, tv, vv)

        descend = live & box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, g(scene.miss_link))
        nxt = jnp.where(live, nxt, s["node"])
        return dict(node=nxt, best_t=best_t, prim=prim, u=uu, v=vv,
                    iters=s["iters"] + 1)

    out = jax.lax.while_loop(cond, body, state)
    return MeshHit(hit=out["prim"] >= 0, t=out["best_t"], prim=out["prim"],
                   u=out["u"], v=out["v"])


def trace_mesh_bruteforce_numpy(vertices, indices, ro, rd, tmin=1e-4, tmax=1e30):
    """Oracle: test every triangle per ray (tests only)."""
    vertices = np.asarray(vertices, np.float64)
    indices = np.asarray(indices)
    ro = np.asarray(ro, np.float64).reshape(-1, 3)
    rd = np.asarray(rd, np.float64).reshape(-1, 3)
    v0 = vertices[indices[:, 0]]
    e1 = vertices[indices[:, 1]] - v0
    e2 = vertices[indices[:, 2]] - v0
    n = ro.shape[0]
    out_t = np.full(n, tmax)
    out_hit = np.zeros(n, bool)
    for i in range(n):
        p = np.cross(rd[i], e2)
        det = np.einsum("tj,tj->t", e1, p)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_det = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
        s = ro[i] - v0
        u = np.einsum("tj,tj->t", s, p) * inv_det
        q = np.cross(s, e1)
        v = q @ rd[i] * inv_det
        t = np.einsum("tj,tj->t", e2, q) * inv_det
        ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin) & (t < tmax)
        if ok.any():
            out_t[i] = t[ok].min()
            out_hit[i] = True
    return out_hit, out_t
