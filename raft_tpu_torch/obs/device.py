"""Device-side attribution: kernel-build counters and profiler sessions.

Counterpart of ``raft_tpu.obs.device``. Where the JAX package counts XLA
backend compiles through a ``jax.monitoring`` listener, the port counts
what it compiles: the ``nvcc`` runs of ``ops.gpu_kernels.build_all``, one
per kernel library not built yet (a library found in the build directory,
keyed by its sources' hash, is not a build). :func:`profile_session` wraps
``torch.profiler`` and writes a Chrome trace into ``log_dir``, where the
JAX package wraps ``jax.profiler``.

Families (on the default registry — builds are process-wide):

- ``raft_tpu_kernel_build_total`` — ``nvcc`` runs. The serving warmup
  invariant ("the first submit after ``start()`` builds nothing") is
  asserted as a zero delta on this. It takes the place of the JAX
  package's ``raft_tpu_xla_compile_total``, which counts something else.
- ``raft_tpu_kernel_build_seconds_total`` — cumulative seconds of those
  builds (the parallel ``nvcc`` runs' wall time, once per build call, in
  place of ``raft_tpu_xla_compile_seconds_total``).
- ``raft_tpu_profile_sessions_total`` / ``raft_tpu_profile_active`` —
  profiler start/stop accounting around :func:`profile_session` (the JAX
  package's names).

``torch`` and ``ops.gpu_kernels`` are imported lazily inside the
functions, so the registry and span sinks stay importable without them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

from raft_tpu_torch.obs import metrics as _metrics

__all__ = ["install_compile_metrics", "compile_count", "compile_seconds",
           "profile_session"]

_install_lock = threading.Lock()
_installed = False

_BUILDS = _metrics.REGISTRY.counter(
    "raft_tpu_kernel_build_total",
    "CUDA kernel library builds (nvcc runs of ops.gpu_kernels.build_all). "
    "A nonzero delta across a serving request means a kernel escaped "
    "warmup.")
_BUILD_SECONDS = _metrics.REGISTRY.counter(
    "raft_tpu_kernel_build_seconds_total",
    "Cumulative wall seconds of kernel library builds.")
_PROFILE_SESSIONS = _metrics.REGISTRY.counter(
    "raft_tpu_profile_sessions_total",
    "torch.profiler capture sessions opened via obs.profile_session().")
_PROFILE_ACTIVE = _metrics.REGISTRY.gauge(
    "raft_tpu_profile_active",
    "1 while an obs.profile_session() capture is running.")


def _listener(n_builds: int, seconds: float) -> None:
    _BUILDS.inc(n_builds)
    _BUILD_SECONDS.inc(max(float(seconds), 0.0))


def install_compile_metrics() -> None:
    """Register the build listener with ``gpu_kernels`` once (idempotent,
    thread-safe). Builds before the first call are not counted — callers
    comparing deltas must install before the baseline read, which
    :func:`compile_count` does implicitly."""
    global _installed
    with _install_lock:
        if _installed:
            return
        from raft_tpu_torch.ops import gpu_kernels

        gpu_kernels.BUILD_LISTENERS.append(_listener)
        _installed = True


def compile_count() -> int:
    """Process-wide count of kernel library builds observed since the
    first call. Monotonic; compare deltas, not absolutes (the JAX
    package's ``compile_count`` with the port's compiles; re-exported from
    raft_tpu_torch.serving)."""
    install_compile_metrics()
    return int(_BUILDS.value)


def compile_seconds() -> float:
    """Cumulative seconds spent building kernels since the first call."""
    install_compile_metrics()
    return float(_BUILD_SECONDS.value)


@contextlib.contextmanager
def profile_session(log_dir: str) -> Iterator[str]:
    """``torch.profiler`` capture (CPU, and CUDA where a card is present)
    with session accounting: ticks the session counter/active gauge so a
    scrape shows whether a capture is live, and on exit writes the Chrome
    trace to ``<log_dir>/trace.json``. Yields the log dir; the
    ``core.tracing.range`` names show on its host timeline."""
    from raft_tpu_torch.core import tracing

    install_compile_metrics()
    _PROFILE_SESSIONS.inc()
    _PROFILE_ACTIVE.inc()
    try:
        with tracing.profile(log_dir):
            yield log_dir
    finally:
        _PROFILE_ACTIVE.dec()
