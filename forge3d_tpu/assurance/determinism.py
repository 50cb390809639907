# forge3d_tpu/assurance/determinism.py
# TERRA-DETERMINATA: byte-exact determinism hashes per device topology.
#
# Parity notes (reference behavior, not code): the reference gates CI on
# byte-exact SHA-256 of canonical renders per backend
# (tests/goldens/determinism/*.sha256, scripts/check_determinism_hashes.py,
# .github/workflows/determinism-matrix.yml) and refuses software adapters
# in deterministic mode (src/core/gpu.rs:62-102). Translation: hashes
# are recorded per (platform, device_kind, topology) — the analogue of the
# reference's per-backend golden variants — and `render_twice_check`
# asserts run-to-run stability within one process.

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["frame_hash", "topology_key", "render_twice_check",
           "DeterminismLedger"]


def frame_hash(frame: np.ndarray) -> str:
    """SHA-256 over shape+dtype+bytes of a rendered frame."""
    arr = np.ascontiguousarray(frame)
    h = hashlib.sha256()
    h.update(f"{arr.dtype}\0{arr.shape}\0".encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def topology_key() -> str:
    """Platform/topology id for per-topology golden variants
    (cpu-8, gpu-1, ...)."""
    import jax

    devs = jax.devices()
    kind = devs[0].device_kind.lower().replace(" ", "-")
    return f"{devs[0].platform}-{kind}-{len(devs)}"


def render_twice_check(render: Callable[[], np.ndarray]) -> Tuple[bool, str, str]:
    """Run a renderer twice; returns (identical, hash1, hash2)."""
    h1 = frame_hash(render())
    h2 = frame_hash(render())
    return h1 == h2, h1, h2


class DeterminismLedger:
    """Persistent {scene_key: {topology: sha256}} ledger, the analogue of
    the reference's tests/goldens/determinism/*.sha256 files."""

    def __init__(self, path):
        self.path = Path(path)
        self.entries: Dict[str, Dict[str, str]] = {}
        if self.path.exists():
            self.entries = json.loads(self.path.read_text())

    def record(self, scene_key: str, frame: np.ndarray,
               topology: Optional[str] = None) -> str:
        topo = topology or topology_key()
        h = frame_hash(frame)
        self.entries.setdefault(scene_key, {})[topo] = h
        self.path.write_text(json.dumps(self.entries, indent=1,
                                        sort_keys=True))
        return h

    def check(self, scene_key: str, frame: np.ndarray,
              topology: Optional[str] = None) -> Tuple[bool, str]:
        """(ok, reason). Unknown scene/topology fails closed."""
        topo = topology or topology_key()
        want = self.entries.get(scene_key, {}).get(topo)
        if want is None:
            return False, f"no recorded hash for {scene_key}@{topo}"
        got = frame_hash(frame)
        if got != want:
            return False, f"hash mismatch: {got[:16]} != {want[:16]}"
        return True, "ok"
