# forge3d — compatibility shim over forge3d_tpu.
#
# Users of the reference package import `forge3d as f3d`; this alias keeps
# that spelling working against the JAX implementation. Every
# attribute resolves through forge3d_tpu's lazy export table, so the shim
# stays complete as the implementation grows.

import sys as _sys

import forge3d_tpu as _impl
from forge3d_tpu import *  # noqa: F401,F403 — re-export the eager surface

__version__ = _impl.__version__


def __getattr__(name):
    return getattr(_impl, name)


def __dir__():
    return dir(_impl)


# Submodule aliases so `import forge3d.gis` etc. resolve.
for _sub in ("gis", "geo", "labels", "codec", "assurance", "viewer", "io",
             "pt", "terrain", "ops", "parallel", "astro", "sky", "style",
             "export", "config", "camera_rigs", "datasets", "tiles3d",
             "pointcloud", "bundle", "buildings", "geometry", "thematic",
             "widgets", "guiding", "alignment", "recipe_manifest", "verify",
             "shadows", "brdf", "precision", "utils"):
    try:
        _mod = __import__(f"forge3d_tpu.{_sub}", fromlist=["_"])
        _sys.modules[f"forge3d.{_sub}"] = _mod
        globals()[_sub] = _mod
    except ImportError:
        pass
