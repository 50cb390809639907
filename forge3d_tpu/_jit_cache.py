# forge3d_tpu/_jit_cache.py
# Persistent XLA compilation cache, configured in one place for every
# entry point (the package __init__ imports this module).
#
# JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins:
# nothing is set here. Otherwise the cache lives at a fixed path inside
# the checkout (git-ignored by the `*_cache/` rule), so later processes
# on the same machine load the sweep pipeline's long first compile from
# disk instead of repeating it.

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parents[1] / "jit_cache"

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
