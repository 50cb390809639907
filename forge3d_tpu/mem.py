# forge3d_tpu/mem.py
# Memory budget + per-resource tracking for device (HBM) allocations.
#
# Parity notes (reference behavior, not code):
#   - 512 MiB host-visible budget, enforce-by-default policy:
#     /root/reference/src/util/memory_budget.rs:11-12
#   - global memory tracker / resource ledger: src/core/memory_tracker.rs,
#     src/core/resource_tracker.rs
#   - Python surface: python/forge3d/mem.py:30-92 (budget policy get/set,
#     memory_metrics dict)
#
# Design: JAX allocates HBM through XLA, so this tracker is a
# *ledger*, not an allocator. Render paths register their logical resources
# (pyramids, accumulators, AOV planes) before materializing them; the policy
# decides whether an over-budget registration raises (enforce) or records a
# degradation (warn). `memory_metrics()` merges the ledger with live
# device.memory_stats() when available.

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from .errors import MemoryBudgetExceeded

#: Default tracked-resource budget. The reference enforces 512 MiB of
#: host-visible memory; we keep the same default for the tracked working set
#: so out-of-core machinery (tiling, streaming) is exercised at the same
#: scale, even though device memory is far larger.
MEMORY_BUDGET_CAP: int = 512 * 1024 * 1024

_VALID_POLICIES = ("enforce", "warn", "off")


@dataclass
class _Resource:
    name: str
    kind: str  # "buffer" | "texture" | "pyramid" | ...
    nbytes: int


class MemoryTracker:
    def __init__(self, budget_bytes: int = MEMORY_BUDGET_CAP) -> None:
        self._lock = threading.Lock()
        self._budget = int(budget_bytes)
        self._policy = "enforce"
        self._resources: Dict[int, _Resource] = {}
        self._next_id = 1
        self._peak = 0
        self._total_allocs = 0

    # -- policy ------------------------------------------------------------
    def set_policy(self, policy: str) -> None:
        if policy not in _VALID_POLICIES:
            raise ValueError(f"policy must be one of {_VALID_POLICIES}, got {policy!r}")
        with self._lock:
            self._policy = policy

    def get_policy(self) -> str:
        with self._lock:
            return self._policy

    def set_budget(self, nbytes: int) -> None:
        with self._lock:
            self._budget = int(nbytes)

    @property
    def budget_bytes(self) -> int:
        with self._lock:
            return self._budget

    # -- ledger ------------------------------------------------------------
    def track(self, name: str, nbytes: int, kind: str = "buffer") -> int:
        """Register a logical device resource; returns a handle id.

        Raises MemoryBudgetExceeded under the 'enforce' policy when the
        tracked total would exceed the budget.
        """
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("nbytes must be >= 0")
        with self._lock:
            in_use = sum(r.nbytes for r in self._resources.values())
            if self._policy == "enforce" and in_use + nbytes > self._budget:
                raise MemoryBudgetExceeded(
                    f"allocation '{name}' of {nbytes} B would exceed the "
                    f"{self._budget} B budget ({in_use} B in use)",
                    requested_bytes=nbytes,
                    budget_bytes=self._budget,
                )
            if self._policy == "warn" and in_use + nbytes > self._budget:
                from .degradation import record_degradation

                record_degradation(
                    "memory_budget",
                    f"tracked use {in_use + nbytes} B exceeds budget {self._budget} B",
                )
            rid = self._next_id
            self._next_id += 1
            self._resources[rid] = _Resource(name, kind, nbytes)
            self._total_allocs += 1
            self._peak = max(self._peak, in_use + nbytes)
            return rid

    def free(self, rid: int) -> None:
        with self._lock:
            self._resources.pop(rid, None)

    def reset(self) -> None:
        with self._lock:
            self._resources.clear()
            self._peak = 0
            self._total_allocs = 0

    # -- reporting ----------------------------------------------------------
    def metrics(self) -> dict:
        with self._lock:
            in_use = sum(r.nbytes for r in self._resources.values())
            by_kind: Dict[str, int] = {}
            for r in self._resources.values():
                by_kind[r.kind] = by_kind.get(r.kind, 0) + r.nbytes
            out = {
                "tracked_bytes": in_use,
                "peak_tracked_bytes": self._peak,
                "budget_bytes": self._budget,
                "policy": self._policy,
                "resource_count": len(self._resources),
                "total_allocations": self._total_allocs,
                "by_kind": by_kind,
                "within_budget": in_use <= self._budget,
            }
        # Live HBM stats, when the backend exposes them.
        try:
            from .device import try_ctx

            ms = try_ctx()[0].memory_stats()
            if ms:
                out["device_bytes_in_use"] = int(ms.get("bytes_in_use", 0))
                out["device_bytes_limit"] = int(ms.get("bytes_limit", 0))
        except Exception:
            pass
        return out


_GLOBAL = MemoryTracker()


def global_tracker() -> MemoryTracker:
    return _GLOBAL


def memory_metrics() -> dict:
    """Reference parity: forge3d.mem.memory_metrics / global_memory_metrics."""
    return _GLOBAL.metrics()


def set_memory_budget_policy(policy: str) -> None:
    _GLOBAL.set_policy(policy)


def get_memory_budget_policy() -> str:
    return _GLOBAL.get_policy()


class tracked(object):
    """Context manager that tracks a resource for a scope.

    >>> with tracked("accum_hdr", h * w * 16):
    ...     ...
    """

    def __init__(self, name: str, nbytes: int, kind: str = "buffer", tracker: Optional[MemoryTracker] = None):
        self._tracker = tracker or _GLOBAL
        self._name = name
        self._nbytes = nbytes
        self._kind = kind
        self._rid: Optional[int] = None

    def __enter__(self):
        self._rid = self._tracker.track(self._name, self._nbytes, self._kind)
        return self._rid

    def __exit__(self, *exc):
        if self._rid is not None:
            self._tracker.free(self._rid)
