# forge3d_tpu/ops/sdf.py
# Signed-distance-field primitives, CSG trees and a sphere-tracing
# raymarcher, all as fused jnp array programs.
#
# Parity notes (reference behavior, not code):
#   - primitives sphere/box/cylinder/plane/torus/capsule and CSG ops
#     union/intersection/subtraction (+ smooth variants with blend factor):
#     /root/reference/src/sdf/mod.rs:25-364, shaders sdf_primitives.wgsl /
#     sdf_operations.wgsl
#   - SdfSceneBuilder add_* returning node ids; evaluate(point) ->
#     (distance, material_id); hybrid traversal couples with mesh BVH
#     (src/sdf/hybrid.rs).
#
# Design: the CSG tree is flattened post-order into an
# instruction tape (SoA arrays). Evaluation runs the tape once per point
# batch with a fixed-size value stack held as a (stack_depth, ...) array —
# no recursion, no dynamic control flow, identical work across lanes, so
# one evaluation of a million points is one fused XLA program. Sphere
# tracing is a lax.while_loop over the batch.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_F32 = jnp.float32

# primitive kinds
SPHERE, BOX, CYLINDER, PLANE, TORUS, CAPSULE = range(6)
# op kinds
UNION, INTERSECTION, SUBTRACTION, SMOOTH_UNION, SMOOTH_INTERSECTION, SMOOTH_SUBTRACTION = range(6)


@dataclass
class _Prim:
    kind: int
    params: Tuple[float, ...]   # packed, kind-specific (8 floats)
    material_id: int


@dataclass
class _Op:
    kind: int
    left: int
    right: int
    smoothing: float
    material_id: int


@dataclass
class SdfSceneBuilder:
    """Builder with the reference's add_*/union/... node-id contract."""

    _prims: List[_Prim] = field(default_factory=list)
    _ops: List[_Op] = field(default_factory=list)

    # node ids: primitives are 0..P-1; operations are P..P+O-1 (assigned at
    # build; during building we track ids as ('p', i) / ('o', i) packed into
    # ints: prim ids are even-spaced first — simplest: id = index into
    # combined list where prims come first, matching add order guarantees.
    def _pid(self, i: int) -> int:
        return i

    def add_sphere(self, center, radius, material_id=0) -> int:
        if radius <= 0:
            raise ValueError("radius must be > 0")
        self._prims.append(_Prim(SPHERE, (*center, radius, 0, 0, 0, 0), material_id))
        return len(self._prims) - 1

    def add_box(self, center, half_extents, material_id=0) -> int:
        self._prims.append(_Prim(BOX, (*center, *half_extents, 0, 0), material_id))
        return len(self._prims) - 1

    def add_cylinder(self, center, radius, half_height, material_id=0) -> int:
        self._prims.append(
            _Prim(CYLINDER, (*center, radius, half_height, 0, 0, 0), material_id)
        )
        return len(self._prims) - 1

    def add_plane(self, normal, distance, material_id=0) -> int:
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self._prims.append(_Prim(PLANE, (*n, distance, 0, 0, 0, 0), material_id))
        return len(self._prims) - 1

    def add_torus(self, center, major_radius, minor_radius, material_id=0) -> int:
        self._prims.append(
            _Prim(TORUS, (*center, major_radius, minor_radius, 0, 0, 0), material_id)
        )
        return len(self._prims) - 1

    def add_capsule(self, point_a, point_b, radius, material_id=0) -> int:
        self._prims.append(_Prim(CAPSULE, (*point_a, *point_b, radius, 0), material_id))
        return len(self._prims) - 1

    def _op(self, kind, left, right, smoothing, material_id) -> int:
        n = len(self._prims) + len(self._ops)
        if left >= n or right >= n or left < 0 or right < 0:
            raise ValueError("operation references unknown node id")
        self._ops.append(_Op(kind, left, right, smoothing, material_id))
        return len(self._prims) + len(self._ops) - 1

    def union(self, left, right, material_id=0) -> int:
        return self._op(UNION, left, right, 0.0, material_id)

    def intersect(self, left, right, material_id=0) -> int:
        return self._op(INTERSECTION, left, right, 0.0, material_id)

    def subtract(self, left, right, material_id=0) -> int:
        return self._op(SUBTRACTION, left, right, 0.0, material_id)

    def smooth_union(self, left, right, smoothing, material_id=0) -> int:
        return self._op(SMOOTH_UNION, left, right, smoothing, material_id)

    def smooth_intersect(self, left, right, smoothing, material_id=0) -> int:
        return self._op(SMOOTH_INTERSECTION, left, right, smoothing, material_id)

    def smooth_subtract(self, left, right, smoothing, material_id=0) -> int:
        return self._op(SMOOTH_SUBTRACTION, left, right, smoothing, material_id)

    def build(self, root: Optional[int] = None) -> "SdfScene":
        if not self._prims:
            raise ValueError("SDF scene has no primitives")
        n = len(self._prims) + len(self._ops)
        root = n - 1 if root is None else root
        return SdfScene._compile(self._prims, self._ops, root)


class SdfTape(NamedTuple):
    """Post-order instruction tape (device arrays)."""

    is_op: jax.Array       # (T,) bool
    kind: jax.Array        # (T,) i32 (prim kind or op kind)
    params: jax.Array      # (T, 8) f32
    smoothing: jax.Array   # (T,) f32
    material: jax.Array    # (T,) i32


@dataclass(frozen=True)
class SdfScene:
    """Compiled SDF scene: evaluate/normal/raymarch over point batches."""

    tape: SdfTape
    tape_len: int
    stack_depth: int
    primitive_count: int
    node_count: int
    bounds: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None

    @staticmethod
    def _compile(prims: List[_Prim], ops: List[_Op], root: int) -> "SdfScene":
        n_p = len(prims)

        # post-order DFS from root over the DAG (re-emitting shared subtrees
        # keeps the tape stackless-evaluable; scenes are small)
        post: List[Tuple[bool, int]] = []

        def walk(node: int, depth: int = 0):
            if depth > 64:
                raise ValueError("CSG tree too deep (cycle?)")
            if node < n_p:
                post.append((False, node))
            else:
                op = ops[node - n_p]
                walk(op.left, depth + 1)
                walk(op.right, depth + 1)
                post.append((True, node - n_p))

        walk(root)

        is_op = []
        kind = []
        params = []
        smoothing = []
        material = []
        depth = 0
        max_depth = 0
        for o, i in post:
            if o:
                op = ops[i]
                is_op.append(True)
                kind.append(op.kind)
                params.append([0.0] * 8)
                smoothing.append(op.smoothing)
                material.append(op.material_id)
                depth -= 1  # two pops, one push
            else:
                p = prims[i]
                is_op.append(False)
                kind.append(p.kind)
                params.append(list(p.params) + [0.0] * (8 - len(p.params)))
                smoothing.append(0.0)
                material.append(p.material_id)
                depth += 1
                max_depth = max(max_depth, depth)
        tape = SdfTape(
            is_op=jnp.asarray(is_op),
            kind=jnp.asarray(kind, jnp.int32),
            params=jnp.asarray(params, _F32),
            smoothing=jnp.asarray(smoothing, _F32),
            material=jnp.asarray(material, jnp.int32),
        )
        return SdfScene(
            tape=tape,
            tape_len=len(post),
            stack_depth=max(max_depth, 1),
            primitive_count=n_p,
            node_count=n_p + len(ops),
        )

    def with_bounds(self, bmin, bmax) -> "SdfScene":
        return SdfScene(
            tape=self.tape, tape_len=self.tape_len, stack_depth=self.stack_depth,
            primitive_count=self.primitive_count, node_count=self.node_count,
            bounds=(tuple(float(v) for v in bmin), tuple(float(v) for v in bmax)),
        )

    # -- evaluation --------------------------------------------------------
    def evaluate(self, px, py, pz):
        """Distance (+ material of the winning leaf/op) at points of any
        shape. Returns (distance, material_id)."""
        px = jnp.asarray(px, _F32)
        py = jnp.asarray(py, _F32)
        pz = jnp.asarray(pz, _F32)
        shape = jnp.broadcast_shapes(px.shape, py.shape, pz.shape)
        px, py, pz = (jnp.broadcast_to(a, shape) for a in (px, py, pz))

        tape = self.tape
        D = self.stack_depth
        dstack = jnp.zeros((D, *shape), _F32)
        mstack = jnp.zeros((D, *shape), jnp.int32)

        def prim_dist(kind, prm, px, py, pz):
            # sphere
            dsx = px - prm[0]
            dsy = py - prm[1]
            dsz = pz - prm[2]
            d_sphere = jnp.sqrt(dsx**2 + dsy**2 + dsz**2) - prm[3]
            # box
            qx = jnp.abs(px - prm[0]) - prm[3]
            qy = jnp.abs(py - prm[1]) - prm[4]
            qz = jnp.abs(pz - prm[2]) - prm[5]
            outer = jnp.sqrt(
                jnp.maximum(qx, 0) ** 2 + jnp.maximum(qy, 0) ** 2 + jnp.maximum(qz, 0) ** 2
            )
            inner = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
            d_box = outer + inner
            # cylinder (y axis)
            dxz = jnp.sqrt((px - prm[0]) ** 2 + (pz - prm[2]) ** 2) - prm[3]
            dy = jnp.abs(py - prm[1]) - prm[4]
            d_cyl = jnp.minimum(jnp.maximum(dxz, dy), 0.0) + jnp.sqrt(
                jnp.maximum(dxz, 0) ** 2 + jnp.maximum(dy, 0) ** 2
            )
            # plane: dot(n, p) - d
            d_plane = px * prm[0] + py * prm[1] + pz * prm[2] - prm[3]
            # torus (y axis) at center
            tq = jnp.sqrt((px - prm[0]) ** 2 + (pz - prm[2]) ** 2) - prm[3]
            d_torus = jnp.sqrt(tq**2 + (py - prm[1]) ** 2) - prm[4]
            # capsule a..b radius
            pax = px - prm[0]
            pay = py - prm[1]
            paz = pz - prm[2]
            bax = prm[3] - prm[0]
            bay = prm[4] - prm[1]
            baz = prm[5] - prm[2]
            hcap = jnp.clip(
                (pax * bax + pay * bay + paz * baz)
                / jnp.maximum(bax**2 + bay**2 + baz**2, 1e-12),
                0.0, 1.0,
            )
            d_cap = jnp.sqrt(
                (pax - bax * hcap) ** 2 + (pay - bay * hcap) ** 2 + (paz - baz * hcap) ** 2
            ) - prm[6]
            return jax.lax.switch(
                kind,
                [
                    lambda: d_sphere, lambda: d_box, lambda: d_cyl,
                    lambda: d_plane, lambda: d_torus, lambda: d_cap,
                ],
            )

        def apply_op(kind, k, d1, m1, d2, m2):
            # d1 = left, d2 = right
            h_u = jnp.clip(0.5 + 0.5 * (d2 - d1) / jnp.maximum(k, 1e-6), 0.0, 1.0)
            su = d2 + (d1 - d2) * h_u - k * h_u * (1.0 - h_u)
            h_i = jnp.clip(0.5 - 0.5 * (d2 - d1) / jnp.maximum(k, 1e-6), 0.0, 1.0)
            si = d2 + (d1 - d2) * h_i + k * h_i * (1.0 - h_i)
            h_s = jnp.clip(0.5 - 0.5 * (d2 + d1) / jnp.maximum(k, 1e-6), 0.0, 1.0)
            ss = d1 + (-d2 - d1) * h_s + k * h_s * (1.0 - h_s)
            cands = [
                (jnp.minimum(d1, d2), jnp.where(d1 <= d2, m1, m2)),              # union
                (jnp.maximum(d1, d2), jnp.where(d1 >= d2, m1, m2)),              # intersection
                (jnp.maximum(d1, -d2), m1),                                      # subtraction
                (su, jnp.where(d1 <= d2, m1, m2)),                               # smooth union
                (si, jnp.where(d1 >= d2, m1, m2)),                               # smooth intersection
                (ss, m1),                                                        # smooth subtraction
            ]
            d = jax.lax.switch(kind, [lambda c=c: c[0] for c in cands])
            m = jax.lax.switch(kind, [lambda c=c: c[1] for c in cands])
            return d, m

        def step(i, carry):
            dstack, mstack, sp = carry
            is_op = tape.is_op[i]
            kind = tape.kind[i]
            prm = tape.params[i]
            k = tape.smoothing[i]

            def do_prim(args):
                dstack, mstack, sp = args
                d = prim_dist(kind, prm, px, py, pz)
                dstack = jax.lax.dynamic_update_index_in_dim(dstack, d, sp, 0)
                m = jnp.full(shape, tape.material[i], jnp.int32)
                mstack = jax.lax.dynamic_update_index_in_dim(mstack, m, sp, 0)
                return dstack, mstack, sp + 1

            def do_op(args):
                dstack, mstack, sp = args
                d2 = jax.lax.dynamic_index_in_dim(dstack, sp - 1, 0, keepdims=False)
                m2 = jax.lax.dynamic_index_in_dim(mstack, sp - 1, 0, keepdims=False)
                d1 = jax.lax.dynamic_index_in_dim(dstack, sp - 2, 0, keepdims=False)
                m1 = jax.lax.dynamic_index_in_dim(mstack, sp - 2, 0, keepdims=False)
                d, m = apply_op(kind, k, d1, m1, d2, m2)
                dstack = jax.lax.dynamic_update_index_in_dim(dstack, d, sp - 2, 0)
                mstack = jax.lax.dynamic_update_index_in_dim(mstack, m, sp - 2, 0)
                return dstack, mstack, sp - 1

            return jax.lax.cond(is_op, do_op, do_prim, (dstack, mstack, sp))

        dstack, mstack, _ = jax.lax.fori_loop(
            0, self.tape_len, step, (dstack, mstack, jnp.asarray(0, jnp.int32))
        )
        return dstack[0], mstack[0]

    def normal(self, px, py, pz, eps: float = 1e-4):
        """Central-difference gradient normal."""
        d = lambda x, y, z: self.evaluate(x, y, z)[0]
        nx = d(px + eps, py, pz) - d(px - eps, py, pz)
        ny = d(px, py + eps, pz) - d(px, py - eps, pz)
        nz = d(px, py, pz + eps) - d(px, py, pz - eps)
        inv = jax.lax.rsqrt(nx**2 + ny**2 + nz**2 + 1e-20)
        return nx * inv, ny * inv, nz * inv

    def raymarch(self, ro, rd, tmin=1e-3, tmax=100.0, max_steps: int = 128,
                 hit_eps: float = 1e-3):
        """Sphere tracing. Returns (hit, t, material_id)."""
        rox, roy, roz = (jnp.asarray(a, _F32) for a in ro)
        rdx, rdy, rdz = (jnp.asarray(a, _F32) for a in rd)
        shape = jnp.broadcast_shapes(rox.shape, rdx.shape)
        rox, roy, roz, rdx, rdy, rdz = (
            jnp.broadcast_to(a, shape) for a in (rox, roy, roz, rdx, rdy, rdz)
        )
        state = dict(
            t=jnp.full(shape, tmin, _F32),
            hit=jnp.zeros(shape, bool),
            mat=jnp.full(shape, -1, jnp.int32),
            done=jnp.zeros(shape, bool),
            i=jnp.asarray(0, jnp.int32),
        )

        def cond(s):
            return (~jnp.all(s["done"])) & (s["i"] < max_steps)

        def body(s):
            t = s["t"]
            d, m = self.evaluate(rox + t * rdx, roy + t * rdy, roz + t * rdz)
            got = (~s["done"]) & (d < hit_eps)
            over = (~s["done"]) & (t > tmax)
            adv = jnp.maximum(d, hit_eps * 0.5)
            return dict(
                t=jnp.where(s["done"] | got, t, t + adv),
                hit=s["hit"] | got,
                mat=jnp.where(got, m, s["mat"]),
                done=s["done"] | got | over,
                i=s["i"] + 1,
            )

        out = jax.lax.while_loop(cond, body, state)
        return out["hit"], out["t"], out["mat"]
