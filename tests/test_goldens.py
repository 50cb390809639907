# Golden-image gates: SSIM >= 0.995 AND mean|d| <= 2/255 against committed
# baselines, plus byte-exact determinism hashes per topology.
#
# Mirrors the reference's fidelity mechanism (tests/test_recipe_goldens.py:
# 48-49,951-954 and tests/goldens/determinism/*.sha256, SURVEY §4):
# - update baselines with FORGE3D_UPDATE_GOLDENS=1 (re-read at call time)
# - a negative-control test guards the gate itself
# - goldens are per-topology (the CPU test backend here; a GPU run records
#   its own variants, like the reference's per-backend `metal` files)

import json
import os
from pathlib import Path

import numpy as np
import pytest

from forge3d_tpu.assurance.determinism import DeterminismLedger, frame_hash
from forge3d_tpu.io.image import numpy_to_png, png_to_numpy
from forge3d_tpu.utils.metrics import mean_abs_error, ssim

from tests._golden_scenes import GOLDEN_SCENES

GOLDEN_DIR = Path(__file__).parent / "goldens"
SSIM_GATE = 0.995
MEANABS_GATE = 2.0 / 255.0


def _update_requested() -> bool:
    # re-read at call time (negative-control guards this)
    return os.environ.get("FORGE3D_UPDATE_GOLDENS", "") in ("1", "true")


def _topology() -> str:
    import jax

    d = jax.devices()[0]
    return f"{d.platform}-{len(jax.devices())}"


@pytest.mark.parametrize("name", sorted(GOLDEN_SCENES))
def test_golden(name):
    render = GOLDEN_SCENES[name]
    frame = render()
    path = GOLDEN_DIR / f"{name}.png"
    if _update_requested() or not path.exists():
        GOLDEN_DIR.mkdir(exist_ok=True)
        numpy_to_png(path, frame)
        if not _update_requested():
            pytest.skip(f"golden bootstrapped: {path.name}")
        return
    golden = png_to_numpy(path)
    s = ssim(frame[..., :3], golden[..., :3])
    m = mean_abs_error(frame[..., :3], golden[..., :3])
    assert s >= SSIM_GATE, (name, s)
    assert m <= MEANABS_GATE, (name, m)


@pytest.mark.parametrize("name", sorted(GOLDEN_SCENES))
def test_determinism_hash(name):
    """Byte-exact run-to-run + recorded-ledger stability per topology."""
    ledger = DeterminismLedger(GOLDEN_DIR / "determinism.json")
    frame = GOLDEN_SCENES[name]()
    topo = _topology()
    if _update_requested() or \
            ledger.entries.get(name, {}).get(topo) is None:
        GOLDEN_DIR.mkdir(exist_ok=True)
        ledger.record(name, frame, topology=topo)
        if not _update_requested():
            pytest.skip(f"determinism hash bootstrapped: {name}@{topo}")
        return
    ok, why = ledger.check(name, frame, topology=topo)
    assert ok, (name, why)


def test_negative_control(tmp_path):
    """The gate itself must reject a corrupted baseline (the reference's
    guard test, test_recipe_goldens.py:24-33)."""
    frame = GOLDEN_SCENES["megakernel_spheres"]()
    # corrupt: shift a block of pixels
    bad = frame.copy()
    bad[10:40, 10:40, :3] = 255 - bad[10:40, 10:40, :3]
    s = ssim(frame[..., :3], bad[..., :3])
    m = mean_abs_error(frame[..., :3], bad[..., :3])
    assert s < SSIM_GATE or m > MEANABS_GATE
    assert frame_hash(frame) != frame_hash(bad)
