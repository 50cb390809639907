# forge3d_tpu/parallel — multi-chip scaling via jax.sharding.
#
# The reference is a single-GPU renderer; its parallelism is pixel/tile
# parallelism inside one device (SURVEY.md §2.8). The scale-out
# axis is: tile-shard each frame's pixel grid across a device mesh (tiles are
# independent in a path tracer), gather tiles only at writeout, and psum the
# tiny convergence metrics. Multi-host frame ranges in animation jobs are
# frame-parallel (embarrassingly parallel).
from .mesh import frame_mesh, tile_sharding, replicated_sharding  # noqa: F401
from .tiles import shard_frame, render_frames_sharded  # noqa: F401
