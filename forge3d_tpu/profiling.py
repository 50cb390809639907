# forge3d_tpu/profiling.py — tracing/profiling seams.
#
# Parity notes (reference behavior, not code): the reference's GPU timing
# layer (src/core/gpu_timing.rs:1-15) provides double-buffered timestamp
# scopes plus RenderDoc/Nsight markers, surfaced through bench.py and
# certificates. Equivalents here: `jax.profiler` traces (viewable in
# TensorBoard/XProf), `jax.named_scope` annotations on render phases, and
# wall-clock scopes that end by blocking on the scope's own device
# outputs (JAX dispatch is asynchronous, so a timer that does not wait on
# them measures the enqueue). Certificates record pass timings via
# assurance.certificate.record_pass.

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["trace", "annotate", "Timer", "device_sync",
           "profile_report"]


@contextlib.contextmanager
def trace(logdir: str, *, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a jax.profiler trace of the enclosed block.

    The trace lands under `logdir` (open with TensorBoard's profile
    plugin / XProf; on an accelerator it includes per-kernel timing).
    """
    import jax

    jax.profiler.start_trace(str(logdir),
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name the enclosed computation in profiler traces
    (jax.named_scope; shows up in XProf op names)."""
    import jax

    with jax.named_scope(str(name)):
        yield


def device_sync(outputs: Any) -> Any:
    """Block until `outputs` (any pytree of arrays) are computed on the
    device, and return them. Device errors propagate."""
    import jax

    return jax.block_until_ready(outputs)


class _Scope:
    """Handle yielded by Timer.scope: `done(x)` registers the scope's
    device outputs, which the timer blocks on before stopping the clock."""

    def __init__(self):
        self.outputs: list = []

    def done(self, outputs: Any) -> Any:
        self.outputs.append(outputs)
        return outputs


class Timer:
    """Wall-clock pass timer that waits for each scope's device outputs.

    >>> t = Timer()
    >>> with t.scope("render") as s:
    ...     img = s.done(render(...))
    >>> t.timings_ms  # {"render": ...}
    """

    def __init__(self, sync: bool = True):
        self.sync = bool(sync)
        self.timings_ms: Dict[str, float] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[_Scope]:
        handle = _Scope()
        t0 = time.perf_counter()
        yield handle
        if self.sync:
            device_sync(handle.outputs)
        dt = (time.perf_counter() - t0) * 1000.0
        self.timings_ms[name] = self.timings_ms.get(name, 0.0) + dt
        if name not in self._order:
            self._order.append(name)

    def record_to_certificate(self, capture=None) -> None:
        """Attach the collected pass timings to the active render
        capture (certificates embed timing evidence, CHANGELOG 1.32.0
        parity)."""
        from .assurance.certificate import current_capture

        cap = capture or current_capture()
        if cap is None:
            return
        for name in self._order:
            cap.record_pass(name, self.timings_ms[name])

    def report(self) -> str:
        total = sum(self.timings_ms.values())
        lines = [f"{n}: {self.timings_ms[n]:.2f} ms" for n in self._order]
        lines.append(f"total: {total:.2f} ms")
        return "\n".join(lines)


def profile_report(fn, *args, repeats: int = 3,
                   logdir: Optional[str] = None, **kwargs) -> dict:
    """Run `fn` under timing (and optionally a jax.profiler trace).

    Returns {"p50_ms", "min_ms", "max_ms", "result"} with compile
    excluded (one untimed warmup call). Each timed call ends when its
    result is ready on the device.
    """
    device_sync(fn(*args, **kwargs))          # warmup/compile
    ctx = trace(logdir) if logdir else contextlib.nullcontext()
    times = []
    result = None
    with ctx:
        for _ in range(max(int(repeats), 1)):
            t0 = time.perf_counter()
            result = device_sync(fn(*args, **kwargs))
            times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return {"p50_ms": times[len(times) // 2], "min_ms": times[0],
            "max_ms": times[-1], "result": result}
