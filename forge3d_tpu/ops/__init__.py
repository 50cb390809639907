# forge3d_tpu/ops — device compute kernels (jnp / lax).
from . import pyramid, rng, shading, tonemap, traversal  # noqa: F401
