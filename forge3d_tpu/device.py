# forge3d_tpu/device.py
# L0 device layer: JAX device probe, Session, deterministic mode,
# context poisoning.
#
# Parity notes (reference behavior, not code):
#   - GpuContext / try_ctx / poison_context: /root/reference/src/core/gpu.rs:9,33,212
#   - deterministic mode gating FORGE3D_DETERMINISTIC: src/core/gpu.rs:62-102
#   - Session (headless device session): src/core/session.rs:15,30
#   - engine_info / device_probe / enumerate_adapters / capabilities:
#     src/core/context.rs:43, src/core/device_caps.rs
#
# Design: there is no lazily-created wgpu device; JAX owns the runtime.
# This layer provides (a) a *fallible first device touch* so callers get a
# typed DeviceError instead of a deep XLA traceback, (b) capability and
# topology introspection, and (c) the deterministic-mode policy switch that
# the assurance layer (determinism hashes) consults.

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from .errors import DeviceError

_ENV_DETERMINISTIC = "FORGE3D_DETERMINISTIC"

_lock = threading.Lock()
_poison_reason: Optional[str] = None
_cached_devices: Optional[list] = None


def _jax():
    import jax

    return jax


def poison_context(reason: str) -> None:
    """Mark the device context unusable; all later touches raise DeviceError.

    Mirrors the reference's context poisoning after fatal device errors
    (src/core/gpu.rs:33).
    """
    global _poison_reason
    with _lock:
        _poison_reason = str(reason)


def unpoison_context() -> None:
    """Clear a poisoned context (test hook)."""
    global _poison_reason
    with _lock:
        _poison_reason = None


def try_ctx() -> list:
    """Fallible first device touch. Returns the JAX device list.

    After the first success, later calls are cheap. Raises DeviceError if the
    context was poisoned or no backend initializes.
    """
    global _cached_devices
    with _lock:
        if _poison_reason is not None:
            raise DeviceError(f"device context poisoned: {_poison_reason}")
        if _cached_devices is not None:
            return _cached_devices
    try:
        devs = _jax().devices()
    except Exception as exc:  # pragma: no cover - backend init failure
        raise DeviceError(f"no usable JAX backend: {exc}") from exc
    if not devs:
        raise DeviceError("JAX reported zero devices")
    with _lock:
        _cached_devices = list(devs)
    return list(devs)


def has_gpu() -> bool:
    """Reference-API-compatible accelerator probe: True when JAX has a
    GPU device."""
    try:
        devs = try_ctx()
    except DeviceError:
        return False
    return any(d.platform == "gpu" for d in devs)


def deterministic_mode() -> bool:
    """True when FORGE3D_DETERMINISTIC requests bit-stable rendering.

    In deterministic mode render paths must use fixed reduction orders
    (sequential accumulation, no atomics-order dependence) so byte-exact
    golden hashes are reproducible per device topology
    (reference: src/core/gpu.rs:62-102).
    """
    v = os.environ.get(_ENV_DETERMINISTIC, "")
    return v not in ("", "0", "false", "False")


def deterministic_allow_software() -> bool:
    """Whether deterministic mode accepts a non-accelerator (CPU) backend."""
    v = os.environ.get("FORGE3D_DETERMINISTIC_ALLOW_SOFTWARE", "")
    return v not in ("", "0", "false", "False")


def enumerate_adapters() -> list[dict]:
    """List available devices with their key properties."""
    out = []
    for d in try_ctx():
        out.append(
            {
                "id": d.id,
                "platform": d.platform,
                "device_kind": getattr(d, "device_kind", "unknown"),
                "process_index": d.process_index,
                "coords": tuple(getattr(d, "coords", ()) or ()),
                "core_on_chip": getattr(d, "core_on_chip", None),
            }
        )
    return out


def device_probe(backend: Optional[str] = None) -> dict:
    """Probe the default device; returns a status dict (never raises).

    Reference parity: `device_probe` native fn (SURVEY A.7).
    """
    try:
        devs = try_ctx()
    except DeviceError as exc:
        return {"status": "unavailable", "message": str(exc)}
    d = devs[0]
    if backend is not None and all(x.platform != backend for x in devs):
        return {"status": "unavailable", "message": f"no '{backend}' device"}
    return {
        "status": "ok",
        "platform": d.platform,
        "device_kind": getattr(d, "device_kind", "unknown"),
        "device_count": len(devs),
        "deterministic": deterministic_mode(),
    }


def engine_info() -> dict:
    """Engine/backend introspection (reference: engine_info, context.rs:43)."""
    import jax

    devs = try_ctx()
    d = devs[0]
    return {
        "engine": "forge3d_tpu",
        "backend": d.platform,
        "device_kind": getattr(d, "device_kind", "unknown"),
        "device_count": len(devs),
        "jax_version": jax.__version__,
        "deterministic": deterministic_mode(),
    }


def capabilities() -> dict:
    """Capability/limit negotiation report (reference: DeviceCaps).

    The negotiated "limits" are the default device's memory limit and the
    device count; feature flags describe what the compute path supports.
    """
    devs = try_ctx()
    d = devs[0]
    mem_stats: dict[str, Any] = {}
    try:
        ms = d.memory_stats()
        if ms:
            mem_stats = {
                "bytes_limit": int(ms.get("bytes_limit", 0)),
                "bytes_in_use": int(ms.get("bytes_in_use", 0)),
            }
    except Exception:
        pass
    return {
        "platform": d.platform,
        "device_kind": getattr(d, "device_kind", "unknown"),
        "device_count": len(devs),
        "memory": mem_stats,
        "features": {
            "float64": d.platform == "cpu",
            "bfloat16": True,
        },
    }


@dataclass
class Session:
    """A headless device session (reference: src/core/session.rs:30).

    `window=True` is accepted for API parity but this build is headless-first;
    interactive presentation runs through the viewer process instead.
    """

    window: bool = False
    backend: Optional[str] = None
    _devices: list = field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        devs = try_ctx()
        if self.backend is not None:
            devs = [d for d in devs if d.platform == self.backend]
            if not devs:
                raise DeviceError(f"no device for backend '{self.backend}'")
        self._devices = devs

    @property
    def device(self):
        return self._devices[0]

    @property
    def devices(self) -> list:
        return list(self._devices)

    def info(self) -> dict:
        return engine_info()

    def close(self) -> None:  # parity no-op; JAX owns runtime lifetime
        pass

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def report_device() -> str:
    """Human-readable one-line device report (reference: report_device)."""
    info = device_probe()
    if info["status"] != "ok":
        return f"forge3d_tpu: no device ({info['message']})"
    return (
        f"forge3d_tpu: {info['platform']} x{info['device_count']} "
        f"({info['device_kind']}), deterministic={info['deterministic']}"
    )
