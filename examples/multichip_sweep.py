# Multi-device converged render: the sweep estimator's jittered frames
# shard across a flat device mesh and the polar accumulator psums across
# devices. Runs on four GPUs when the machine has them (the cards are
# joined all to all, so the mesh is one flat axis), otherwise on 8
# virtual CPU devices. Output matches the single-device render to within
# one u8 step (the psum adds frames in another order).
#
# Run: python examples/multichip_sweep.py [out.png]

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# only the CPU backend reads this; a GPU run is unaffected
os.environ.setdefault("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax

import numpy as np


def main(out_path="examples/out/multichip_sweep.png"):
    from forge3d_tpu.io.image import numpy_to_png
    from forge3d_tpu.parallel.mesh import frame_mesh
    from forge3d_tpu.parallel.sweep import render_sweep_sharded
    from forge3d_tpu.pt.terrain_ref import TerrainRefDesc

    n = 129
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (12.0 * np.sin(xx * 0.08) * np.cos(yy * 0.06)).astype(np.float32)
    desc = TerrainRefDesc(heights=dem, cam_origin=(64.0, 42.0, 170.0),
                          cam_look_at=(64.0, 0.0, 64.0), fov_y_deg=45.0,
                          width=320, height=240, spp=1)
    if jax.default_backend() == "gpu" and len(jax.devices()) >= 4:
        devices = jax.devices()[:4]
    else:
        devices = jax.devices("cpu")
    out = render_sweep_sharded(desc, n_frames=8, mesh=frame_mesh(devices))
    print(f"rendered on {out['devices']} devices, "
          f"{out['frames_per_device']} frames each")
    os.makedirs("examples/out", exist_ok=True)
    numpy_to_png(out_path, out["rgba"])
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:])
