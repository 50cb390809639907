# forge3d_tpu/ops/tlas.py
# Two-level acceleration: transformed INSTANCES over shared BLASes.
#
# Parity notes (reference behavior, not code):
#   /root/reference/src/accel/instancing.rs +
#   src/path_tracing/wavefront/instances.rs — TLAS instances referencing
#   BLAS descriptors with per-instance object<->world transforms.
#
# Design: instance counts in cartographic scenes are small
# (buildings batches, repeated landmark meshes), so the instance loop is a
# STATIC unroll — each instance's rays transform into object space
# (direction left unnormalized so the hit parameter t stays world-scaled)
# and traverse its BLAS with the existing stackless threaded-BVH kernel;
# hits min-combine across instances. No divergent two-level pointer
# chasing, no gather-hostile TLAS nodes — XLA fuses the per-instance
# programs into one.

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .bvh import BvhArrays, MeshScene, build_sah_bvh, mesh_scene, trace_mesh


@dataclass(frozen=True)
class Instance:
    """One placement of a BLAS: object->world 4x4 (numpy, host-static)."""

    blas_index: int
    transform: np.ndarray

    def __post_init__(self):
        m = np.asarray(self.transform, np.float64)
        if m.shape != (4, 4):
            raise ValueError("instance transform must be 4x4")
        object.__setattr__(self, "transform", m)


class Tlas(NamedTuple):
    """Host-built two-level structure: shared device BLASes + per-instance
    static transforms (object->world, world->object, normal matrix)."""

    scenes: Tuple[Tuple[MeshScene, int], ...]   # (scene, n_nodes) per BLAS
    instances: Tuple[Instance, ...]
    inv_mats: Tuple[np.ndarray, ...]            # world->object
    nrm_mats: Tuple[np.ndarray, ...]            # inverse-transpose linear


class TlasHit(NamedTuple):
    hit: jax.Array
    t: jax.Array          # world-scaled ray parameter
    instance: jax.Array   # i32 instance index (-1 = miss)
    prim: jax.Array       # i32 reordered-primitive id in that instance's BLAS
    u: jax.Array
    v: jax.Array


def build_tlas(blases: Sequence[BvhArrays | Tuple[np.ndarray, np.ndarray]],
               instances: Sequence[Instance]) -> Tlas:
    """Assemble a TLAS from BLASes (BvhArrays or (vertices, indices) pairs
    built on the host SAH path) and instance placements."""
    scenes = []
    for b in blases:
        if not isinstance(b, BvhArrays):
            b = build_sah_bvh(np.asarray(b[0], np.float32),
                              np.asarray(b[1], np.uint32))
        scenes.append(mesh_scene(b))
    inv_mats = []
    nrm_mats = []
    for inst in instances:
        if not 0 <= inst.blas_index < len(scenes):
            raise ValueError(f"instance blas_index {inst.blas_index} out of "
                             f"range ({len(scenes)} BLASes)")
        inv = np.linalg.inv(inst.transform)
        inv_mats.append(inv)
        nrm_mats.append(np.linalg.inv(inst.transform[:3, :3]).T)
    return Tlas(scenes=tuple(scenes), instances=tuple(instances),
                inv_mats=tuple(inv_mats), nrm_mats=tuple(nrm_mats))


def trace_tlas(tlas: Tlas, ro, rd, tmin: float = 1e-4,
               tmax: float = 1e30) -> TlasHit:
    """Closest hit over all instances. ro/rd: world-space ray arrays
    (3-tuples of any broadcastable shape)."""
    rox, roy, roz = (jnp.asarray(a, jnp.float32) for a in ro)
    rdx, rdy, rdz = (jnp.asarray(a, jnp.float32) for a in rd)
    shape = jnp.broadcast_shapes(rox.shape, rdx.shape)
    best_t = jnp.full(shape, jnp.float32(tmax))
    best_hit = jnp.zeros(shape, bool)
    best_inst = jnp.full(shape, -1, jnp.int32)
    best_prim = jnp.zeros(shape, jnp.int32)
    best_u = jnp.zeros(shape, jnp.float32)
    best_v = jnp.zeros(shape, jnp.float32)

    for idx, inst in enumerate(tlas.instances):          # static unroll
        inv = tlas.inv_mats[idx]
        lin = jnp.asarray(inv[:3, :3], jnp.float32)
        trans = jnp.asarray(inv[:3, 3], jnp.float32)
        o = (lin[0, 0] * rox + lin[0, 1] * roy + lin[0, 2] * roz + trans[0],
             lin[1, 0] * rox + lin[1, 1] * roy + lin[1, 2] * roz + trans[1],
             lin[2, 0] * rox + lin[2, 1] * roy + lin[2, 2] * roz + trans[2])
        # direction NOT renormalized: keeps t world-scaled across instances
        d = (lin[0, 0] * rdx + lin[0, 1] * rdy + lin[0, 2] * rdz,
             lin[1, 0] * rdx + lin[1, 1] * rdy + lin[1, 2] * rdz,
             lin[2, 0] * rdx + lin[2, 1] * rdy + lin[2, 2] * rdz)
        scene, n_nodes = tlas.scenes[inst.blas_index]
        h = trace_mesh(scene, n_nodes, o, d, tmin=tmin, tmax=tmax)
        closer = h.hit & (h.t < best_t)
        best_t = jnp.where(closer, h.t, best_t)
        best_hit = best_hit | closer
        best_inst = jnp.where(closer, jnp.int32(idx), best_inst)
        best_prim = jnp.where(closer, h.prim, best_prim)
        best_u = jnp.where(closer, h.u, best_u)
        best_v = jnp.where(closer, h.v, best_v)
    return TlasHit(hit=best_hit, t=best_t, instance=best_inst,
                   prim=best_prim, u=best_u, v=best_v)


def instance_normal(tlas: Tlas, hit: TlasHit, object_normals) -> tuple:
    """Transform per-lane object-space normals into world space with each
    hit instance's inverse-transpose matrix. object_normals: 3-tuple of
    arrays (already gathered per lane)."""
    nx, ny, nz = (jnp.asarray(a, jnp.float32) for a in object_normals)
    wx = jnp.zeros_like(nx)
    wy = jnp.zeros_like(ny)
    wz = jnp.zeros_like(nz)
    for idx in range(len(tlas.instances)):               # static unroll
        m = jnp.asarray(tlas.nrm_mats[idx], jnp.float32)
        sel = hit.instance == idx
        wx = jnp.where(sel, m[0, 0] * nx + m[0, 1] * ny + m[0, 2] * nz, wx)
        wy = jnp.where(sel, m[1, 0] * nx + m[1, 1] * ny + m[1, 2] * nz, wy)
        wz = jnp.where(sel, m[2, 0] * nx + m[2, 1] * ny + m[2, 2] * nz, wz)
    inv = jax.lax.rsqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-20))
    return wx * inv, wy * inv, wz * inv
