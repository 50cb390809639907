# forge3d_tpu/parallel/sweep.py
# Multi-chip scaling of the flagship sweep renderer: the converged render's
# jittered FRAMES shard across the device mesh (they are embarrassingly
# parallel), the polar accumulator psums across devices, and the screen resolve
# runs replicated. This is the sweep-engine counterpart of the per-ray
# tile sharding in parallel/tiles.py (SURVEY §2.8: frame/tile
# decomposition -> shard_map over a device mesh, gather at writeout).
#
# Reference behavior being scaled (not copied): the converged terrain PT
# accumulation loop of /root/reference/src/path_tracing/hybrid_compute/
# render_terrain.rs — independent jittered frames accumulated into one
# HDR buffer.

from __future__ import annotations

import functools

import numpy as np

from .mesh import TILE_AXIS, frame_mesh, replicated_sharding


@functools.lru_cache(maxsize=8)
def _sharded_accum(frame_raw, mesh, env_specs):
    """The jitted frame-sharded accumulation for one pipeline and mesh.
    Cached so repeat renders reuse the traced and compiled program."""
    import jax
    from jax.sharding import PartitionSpec as P

    def local(hgt, h_rot, du, dv, env_arg, lc, albedo, shadow_eps,
              keys_local):
        acc = frame_raw(hgt, h_rot, du, dv, env_arg, lc, albedo, shadow_eps,
                        keys_local[0])
        return jax.lax.psum(acc, TILE_AXIS)

    # check_vma=False: the propagation scan's carry starts from the
    # (replicated) height row and becomes device-varying once the
    # per-device jitter keys enter — legal here (the psum collects the
    # varying results), but the static varying-axis checker can't see
    # that, so run in all-manual mode.
    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), env_specs, P(), P(), P(),
                  P(TILE_AXIS)),
        out_specs=P(),
        check_vma=False,
    ))


def render_sweep_sharded(desc, n_frames: int, mesh=None):
    """Render the converged sweep frame with frames sharded across `mesh`.

    Each device integrates n_frames/n_dev jittered sweep frames (full sky
    stratification + polar primary pass each); the only collective is one
    psum of the (E, A, 9) polar accumulator. Returns the same dict as
    render_terrain_sweep. n_frames rounds up to a device multiple.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.shading import EnvMap
    from ..pt import terrain_sweep as ts
    from ..pt.terrain_ref import _validate

    _validate(desc)
    mesh = mesh if mesh is not None else frame_mesh()
    n_dev = mesh.devices.size
    per_dev = max(1, -(-int(n_frames) // n_dev))
    n_frames = per_dev * n_dev

    W, H = desc.width, desc.height
    heights = np.asarray(desc.heights, np.float32)
    env_shape = None if desc.env_map is None else tuple(
        np.asarray(desc.env_map).shape)
    rg, ps, prepare, frame_fn, resolve, _render_all = ts._build_pipeline(
        heights.shape, tuple(map(float, desc.spacing)),
        float(desc.exaggeration),
        tuple(map(float, desc.cam_origin)),
        tuple(map(float, desc.cam_look_at)),
        tuple(map(float, desc.cam_up)),
        float(desc.fov_y_deg), W, H, 32, 12, -0.55,
        float(desc.sun_azimuth_deg), float(desc.sun_elevation_deg),
        bool(desc.shadows_enabled), env_shape)

    env = EnvMap(
        rgb=None if desc.env_map is None else jnp.asarray(desc.env_map,
                                                          jnp.float32),
        intensity=jnp.asarray(desc.env_intensity, jnp.float32))
    lc = jnp.asarray([desc.sun_intensity * c for c in desc.sun_color],
                     jnp.float32)
    albedo = jnp.asarray(desc.albedo, jnp.float32)
    h_rng = float(heights.max() - heights.min()) * desc.exaggeration
    shadow_eps = jnp.asarray(1e-4 * (h_rng + 1.0), jnp.float32)

    rep = replicated_sharding(mesh)
    hgt = jax.device_put(jnp.asarray(heights), rep)
    h_rot, du, dv = (jax.device_put(a, rep)
                     for a in prepare(jnp.asarray(heights)))

    key = jax.random.PRNGKey(desc.seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(n_frames)).reshape(n_dev, per_dev, -1)
    keys = jax.device_put(keys, jax.sharding.NamedSharding(
        mesh, P(TILE_AXIS)))

    env_specs = jax.tree_util.tree_map(lambda _: P(), env)
    acc = _sharded_accum(frame_fn.raw, mesh, env_specs)(
        hgt, h_rot, du, dv, env, lc, albedo, shadow_eps, keys)
    packed = resolve(acc / jnp.float32(n_frames),
                     jnp.asarray(desc.exposure, jnp.float32))
    return ts._unpack_render(desc, np.asarray(packed), n_frames,
                             extra={"devices": int(n_dev),
                                    "frames_per_device": int(per_dev)})
