# forge3d_tpu/parallel/tiles.py
# Tile-sharded frame rendering: pixel rows shard across the mesh, scene
# tables replicate, XLA/GSPMD inserts the (tiny) collectives.
#
# Reference parallelism being replaced: `iter_tiles` host tiling + per-sample
# GPU batches (/root/reference/python/forge3d/path_tracing.py:618,
# offline.rs:1569). The tile grid IS the sharding: every device owns a
# contiguous row band of the frame, traversal tables are replicated (read-
# only), and the only cross-chip traffic is the final gather at writeout
# plus max/psum reductions for convergence metrics.

from __future__ import annotations

from typing import Any

import jax

from .mesh import frame_mesh, replicated_sharding, tile_sharding


def shard_frame(mesh, *, row_arrays=(), flat_arrays=(), replicated=()):
    """device_put frame state onto the mesh.

    row_arrays:  arrays whose dim 0 is pixel rows (H, ...) — sharded.
    flat_arrays: arrays of shape (H*W, ...) — sharded on dim 0.
    replicated:  read-only tables (pyramid, env, LUTs) — replicated.
    Returns the three groups in the same order.
    """
    row_sh = {a.ndim: tile_sharding(mesh, ndim=a.ndim) for a in row_arrays}
    out_rows = tuple(jax.device_put(a, row_sh[a.ndim]) for a in row_arrays)
    out_flat = tuple(
        jax.device_put(a, tile_sharding(mesh, ndim=a.ndim)) for a in flat_arrays
    )
    rep = replicated_sharding(mesh)
    out_rep = tuple(jax.device_put(a, rep) for a in replicated)
    return out_rows, out_flat, out_rep


def render_frames_sharded(desc, n_frames: int, mesh=None):
    """Run `n_frames` accumulation frames of the terrain PT reference with
    the frame tile-sharded across `mesh` (default: all devices).

    Returns (accum, welford, reservoirs) still device-sharded; callers
    gather with np.asarray at writeout. Used by dryrun_multichip and the
    multi-chip bench.
    """
    import jax.numpy as jnp

    from ..ops import restir as rst
    from ..ops.pyramid import build_pyramid
    from ..ops.shading import EnvMap
    from ..ops.traversal import scene_from_pyramid
    from ..pt.terrain_ref import _make_frame_step, _make_reuse_step, _center_gbuffer

    import numpy as np

    mesh = mesh if mesh is not None else frame_mesh()
    n_dev = mesh.devices.size
    H, W = desc.height, desc.width
    if H % n_dev != 0:
        raise ValueError(f"height {H} must divide across {n_dev} devices")

    pyr = build_pyramid(np.asarray(desc.heights, np.float32))
    scene, static = scene_from_pyramid(
        pyr, origin_xz=(0.0, 0.0), spacing_xz=desc.spacing,
        exaggeration=desc.exaggeration,
    )
    env = EnvMap(
        rgb=None if desc.env_map is None else jnp.asarray(desc.env_map),
        intensity=jnp.asarray(desc.env_intensity, jnp.float32),
    )
    # Replicate the read-only traversal tables explicitly.
    rep = replicated_sharding(mesh)
    scene = jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), scene)
    env = EnvMap(
        rgb=None if env.rgb is None else jax.device_put(env.rgb, rep),
        intensity=jax.device_put(env.intensity, rep),
    )

    frame_step = jax.jit(_make_frame_step(desc, static),
                         donate_argnums=(3, 4))
    reuse_step = jax.jit(_make_reuse_step(desc), donate_argnums=(0,))
    gbuf = jax.jit(lambda s: _center_gbuffer(desc, s, static))(scene)
    gb_n = gbuf["gb_n"]

    sh2 = tile_sharding(mesh, ndim=3)
    sh1 = tile_sharding(mesh, ndim=1)
    accum = jax.device_put(jnp.zeros((H, W, 4), jnp.float32), sh2)
    welford = jax.device_put(jnp.zeros((H, W, 2), jnp.float32), sh2)
    res_prev = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sh1), rst.Reservoirs.zeros(H * W)
    )
    gb_n = tuple(jax.device_put(a, sh1) for a in gb_n)

    for f in range(n_frames):
        accum, welford, curr, res_prev_c = frame_step(
            scene, env, None, accum, welford, res_prev, jnp.uint32(f)
        )
        res_prev = reuse_step(res_prev_c, curr, gb_n, jnp.uint32(f))
    return accum, welford, res_prev
