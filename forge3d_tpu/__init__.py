# forge3d_tpu — a JAX/XLA rebuild of the forge3d offline 3D map renderer:
# path-traced terrain and cartography.
#
# The public API mirrors the reference's `forge3d` package surface while
# the engine underneath is a from-scratch design: wgpu passes became
# jitted functions, WGSL kernels became fused jnp programs, wavefront ray
# queues became deterministic per-pixel sample loops, and frames shard
# across devices with jax.sharding.

from . import _jit_cache  # noqa: F401  (persistent compilation cache)
from ._version import __version__  # noqa: F401

from .errors import (  # noqa: F401
    ContractViolation,
    ConvergenceError,
    DegradedCapability,
    DeviceError,
    ExperimentalSyntheticOutput,
    MemoryBudgetExceeded,
    RenderError,
    TransformFailed,
    UploadError,
)
from .device import (  # noqa: F401
    Session,
    capabilities,
    deterministic_mode,
    device_probe,
    engine_info,
    enumerate_adapters,
    has_gpu,
    poison_context,
    report_device,
    try_ctx,
    unpoison_context,
)
from .degradation import (  # noqa: F401
    clear_native_degradations,
    native_degradations,
    record_degradation,
)
from .mem import (  # noqa: F401
    MEMORY_BUDGET_CAP,
    get_memory_budget_policy,
    memory_metrics,
    set_memory_budget_policy,
)
from .camera import (  # noqa: F401
    PinholeCamera,
    camera_dof_params,
    camera_look_at,
    camera_orthographic,
    camera_perspective,
    camera_view_proj,
    orbit_camera_origin,
)

def global_memory_metrics():
    """Reference parity alias for memory_metrics()."""
    return memory_metrics()


# Heavier subsystems import lazily so `import forge3d_tpu` stays cheap and
# works before JAX device init.
def __getattr__(name):
    if name in ("hybrid_render_terrain_reference", "render_terrain_reference"):
        from .pt.terrain_ref import hybrid_render_terrain_reference

        return hybrid_render_terrain_reference
    if name == "hybrid_render_terrain_sequence":
        from .pt.terrain_ref import hybrid_render_terrain_sequence

        return hybrid_render_terrain_sequence
    if name == "PathTracer":
        from .pt.path_tracer import PathTracer

        return PathTracer
    if name == "Scene":
        from .scene import Scene

        return Scene
    if name == "TerrainRenderer":
        from .terrain.renderer import TerrainRenderer

        return TerrainRenderer
    if name == "TerrainRenderParams":
        from .terrain.params import TerrainRenderParams

        return TerrainRenderParams
    if name in ("numpy_to_png", "png_to_numpy"):
        from .io import image

        return getattr(image, name)
    if name == "colormaps":
        import importlib

        return importlib.import_module(".colormaps", __name__)
    if name in ("load_mesh", "save_mesh", "load_obj", "save_obj", "load_ply",
                "save_ply", "load_stl", "save_stl", "load_gltf", "MeshData"):
        from .io import mesh as _mesh_io

        return getattr(_mesh_io, name)
    if name in ("extrude_polygon_py", "extrude_polygon"):
        from .geometry import extrude_polygon

        return extrude_polygon
    if name == "uv_planar_unwrap_py":
        from .geometry import uv_planar_unwrap

        return uv_planar_unwrap
    if name == "geometry":
        import importlib

        return importlib.import_module(".geometry", __name__)
    if name == "buildings":
        import importlib

        return importlib.import_module(".buildings", __name__)
    if name in ("_pt_render_gpu_mesh", "pt_render_gpu_mesh"):
        from .pt.mesh_render import pt_render_gpu_mesh

        return pt_render_gpu_mesh
    if name in ("compress_dem", "decompress_dem", "verify_dem"):
        from .codec import f3dz as _f3dz

        return getattr(_f3dz, name)
    if name in ("encode_bc7_rgba8", "decode_bc7", "encode_bc5_rg8",
                "decode_bc5"):
        from .codec import bc as _bc

        return getattr(_bc, name)
    if name == "codec":
        import importlib

        return importlib.import_module(".codec", __name__)
    if name == "labels":
        import importlib

        return importlib.import_module(".labels", __name__)
    if name in ("open_viewer_async", "ViewerHandle", "open_viewer",
                "open_terrain_viewer"):
        from . import viewer as _viewer

        return getattr(_viewer, name if name in ("open_viewer_async",
                                                 "ViewerHandle")
                       else "open_viewer_async")
    if name in ("save_bundle", "load_bundle", "bundle_manifest"):
        from . import bundle as _bundle

        return getattr(_bundle, name)
    if name in ("read_laz_points_info", "read_las_points", "PointBuffer"):
        from . import pointcloud as _pc

        return getattr(_pc, name)
    if name in ("pointcloud", "viewer", "bundle"):
        import importlib

        return importlib.import_module("." + name, __name__)
    if name in ("dd_selftest", "dd_harness", "dd_jitter_demo"):
        from . import precision as _prec

        return getattr(_prec, name)
    if name == "precision":
        import importlib

        return importlib.import_module(".precision", __name__)
    if name in ("seal_provenance", "verify_provenance"):
        from .assurance import provenance as _prov

        return getattr(_prov, name)
    if name in ("license_public_key_hex", "verify_license_signature"):
        from .assurance import license as _lic

        return getattr(_lic, name)
    if name in ("begin_render_capture", "render_execution_report",
                "sign_render_certificate_digest", "verify_render_certificate"):
        from .assurance import certificate as _cert

        return getattr(_cert, name)
    if name == "assurance":
        import importlib

        return importlib.import_module(".assurance", __name__)
    if name.startswith("astro_") or name in ("body_info",
                                              "sky_set_observation"):
        from . import astro as _astro

        if hasattr(_astro, name):
            return getattr(_astro, name)
    if name == "astro":
        import importlib

        return importlib.import_module(".astro", __name__)
    if name in ("fetch_dem", "dataset_names", "mini_dem"):
        from . import datasets as _ds

        return getattr(_ds, name)
    if name in ("read_cog", "CogReader"):
        from .gis import cog as _cog

        return getattr(_cog, name)
    if name in ("decode_pnts", "decode_b3dm", "load_tileset"):
        from . import tiles3d as _t3d

        return getattr(_t3d, name)
    if name in ("datasets", "tiles3d", "gis"):
        import importlib

        return importlib.import_module("." + name, __name__)
    if name in ("load_style", "parse_color", "MapStyle"):
        from . import style as _style

        return getattr(_style, name)
    if name in ("export_svg", "export_pdf", "VectorDocument"):
        from . import export as _export

        return getattr(_export, name)
    if name in ("RendererConfig", "load_renderer_config"):
        from . import config as _config

        return getattr(_config, name)
    if name in ("style", "export", "config", "camera_rigs"):
        import importlib

        return importlib.import_module("." + name, __name__)
    if name in ("read_vector", "reproject_vector", "clip_vector",
                "dissolve_vector", "buffer_geometry", "intersect_geometries",
                "union_geometries", "difference_geometries", "geometry_mask"):
        from .gis import vector as _vec

        return getattr(_vec, name)
    if name in ("parse_osm_features", "query_osm_features",
                "prepare_osm_scene", "build_terrarium_dem",
                "decode_terrarium_dem", "fetch_remote_geodata",
                "cache_geodata"):
        from .gis import osm as _osm

        return getattr(_osm, name)
    if name in ("reproject_raster", "align_raster_to"):
        from .gis import warp as _warp

        return getattr(_warp, name)
    if name in ("hybrid_render", "render_adjudication_pair",
                "build_hybrid_scene"):
        from .pt import hybrid as _hyb

        return getattr(_hyb, name)
    if name in ("numpy_to_exr", "exr_to_numpy", "write_hdr", "read_hdr",
                "read_ktx2"):
        from .io import formats as _formats

        return getattr(_formats, name)
    if name in ("shader_report",):
        from . import verify as _verify

        return _verify.shader_report
    if name in ("terrain_culling_stats", "terrain_visibility_stats",
                "terrain_vt_stats", "terrain_seam_stats"):
        from .terrain import stats as _stats

        return getattr(_stats, name)
    if name in ("sky", "thematic", "widgets", "guiding", "alignment",
                "recipe_manifest", "verify"):
        import importlib

        return importlib.import_module("." + name, __name__)
    if name in ("configure_csm", "set_csm_enabled", "set_csm_light_direction",
                "set_csm_pcf_kernel", "set_csm_bias_params",
                "set_csm_debug_mode", "get_csm_cascade_info",
                "validate_csm_peter_panning"):
        from . import shadows as _shadows

        return getattr(_shadows, name)
    if name in ("render_brdf_tile", "render_brdf_tile_overrides",
                "render_debug_pattern_frame"):
        from . import brdf as _brdf

        return getattr(_brdf, name)
    if name in ("shadows", "brdf"):
        import importlib

        return importlib.import_module("." + name, __name__)
    if name in ("rotate_x", "rotate_y", "rotate_z", "scale", "translate",
                "grid_generate"):
        from . import transforms as _tf

        return getattr(_tf, name)
    # flat reference-API surface (SURVEY A.7 spellings) resolved last
    if not name.startswith("__"):
        import importlib

        _ref = importlib.import_module("forge3d_tpu._reference_api")
        try:
            return _ref.resolve(name)
        except KeyError:
            pass
    raise AttributeError(f"module 'forge3d_tpu' has no attribute {name!r}")
