#!/usr/bin/env python
# examples/terrain_demo.py — 512x512 synthetic-DEM terrain snapshot.
#
# The JAX counterpart of the reference's examples/terrain_demo.py
# (preset JSON merge at :52-80): renders the path-traced terrain reference
# on a synthetic DEM with a preset/override config chain and writes a PNG.
#
# Usage: python examples/terrain_demo.py [--preset draft|preview|production]
#        [--out terrain_demo.png] [--width 512] [--height 512]

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="preview")
    ap.add_argument("--out", default="terrain_demo.png")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--config", default=None, help="JSON config file")
    args = ap.parse_args()

    import forge3d_tpu as f3d
    from forge3d_tpu.config import load_renderer_config

    cfg = load_renderer_config(args.config, preset=args.preset,
                               overrides={"width": args.width,
                                          "height": args.height})

    n = 513
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    rng = np.random.default_rng(cfg.seed)
    dem = (40.0 * np.sin(x * 0.02) * np.cos(y * 0.017)
           + 8.0 * np.sin(x * 0.11 + 1.0) * np.sin(y * 0.13)
           + rng.normal(0, 0.5, (n, n))).astype(np.float32)

    out = f3d.hybrid_render_terrain_reference(
        dem, cfg.width, cfg.height,
        {"origin": (256.0, 150.0, 880.0), "look_at": (256.0, 0.0, 256.0)},
        spp=cfg.spp, min_frames=cfg.min_frames, max_frames=cfg.max_frames,
        variance_threshold=cfg.variance_threshold, seed=cfg.seed)
    f3d.numpy_to_png(args.out, out["rgba"])
    print(f"wrote {args.out} ({cfg.width}x{cfg.height}, "
          f"{out['frames']} frames, converged={out['converged']})")


if __name__ == "__main__":
    main()
