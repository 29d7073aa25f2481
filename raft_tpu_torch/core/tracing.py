"""Named trace ranges and profiler captures (counterpart of
``raft_tpu.core.tracing``).

A range is a ``torch.profiler.record_function`` scope while a
``torch.profiler`` capture is active, so it shows on the host timeline of
the capture beside the kernels it launched (Kineto puts both on one clock).
While span stats are on (``set_span_stats`` / ``span_stats``, off by
default, process-wide) a range also adds its host seconds to the registry
histogram ``raft_tpu_span_seconds{span}``. With neither on, a range costs
two flag checks and enters nothing. ``range`` works as a context manager
and as a decorator, ``span`` is the scope a function body opens, and
``annotate`` is the decorator form; ``profile`` captures a trace around a
region."""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: buckets of ``raft_tpu_span_seconds``: 1 µs to ~33 s, doubling (a span
#: inside a search is microseconds to milliseconds)
SPAN_BUCKETS = tuple(1e-6 * 2.0 ** i for i in range(26))

_stats_on = False
_span_seconds = None  # the histogram family, registered at the first switch-on
_children: Dict[str, object] = {}  # span name → its histogram child
_OFF = contextlib.nullcontext()


def _observe(name: str, seconds: float) -> None:
    child = _children.get(name)
    if child is None:
        child = _children.setdefault(name, _span_seconds.labels(name))
    child.observe(seconds)


class _Span:
    """One entered span: the profiler's scope while a capture is active, the
    host clock while span stats are on."""

    __slots__ = ("name", "_scope", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._scope = None
        self._t0 = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._scope = torch.profiler.record_function(self.name)
            self._scope.__enter__()
        if _stats_on:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            _observe(self.name, time.perf_counter() - self._t0)
        if self._scope is not None:
            return self._scope.__exit__(*exc)
        return False


def span(name: str):
    """The scope of a span named ``name``: ``with tracing.span("x"): ...``.
    A shared no-op scope while no capture is active and span stats are
    off."""
    if _stats_on or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


class range:  # noqa: A001 — mirrors raft_tpu.core.tracing.range
    """Named trace scope (context manager or decorator)."""

    def __init__(self, name: str):
        self.name = name
        self._stack = []

    def __enter__(self):
        scope = span(self.name)
        scope.__enter__()
        self._stack.append(scope)
        return self

    def __exit__(self, *exc):
        return self._stack.pop().__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_stats_on or _autograd_profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return wrapper


def set_span_stats(on: bool) -> bool:
    """Switch span stats on or off for the whole process; returns the
    previous state. The first switch-on registers ``raft_tpu_span_seconds``
    on the default registry."""
    global _stats_on, _span_seconds
    if on and _span_seconds is None:
        from raft_tpu_torch.obs.metrics import REGISTRY

        _span_seconds = REGISTRY.histogram(
            "raft_tpu_span_seconds",
            "Host seconds inside each trace span, while span stats are on.",
            ("span",), buckets=SPAN_BUCKETS)
    previous, _stats_on = _stats_on, bool(on)
    return previous


@contextlib.contextmanager
def span_stats(on: bool = True):
    """``with tracing.span_stats(): ...``: span stats on (or off) inside the
    block, the previous state restored after it."""
    previous = set_span_stats(on)
    try:
        yield
    finally:
        set_span_stats(previous)


@contextlib.contextmanager
def profile(log_dir: str):
    """Capture a ``torch.profiler`` trace around a region (CPU, and CUDA
    where a card is present) and write it to ``<log_dir>/trace.json`` (the
    Chrome trace format): ``with tracing.profile(dir): search(...)``.
    Yields ``log_dir``. ``obs.profile_session`` adds session accounting on
    the metrics registry."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: Optional[str] = None):
    """Decorator form: ``@annotate("ivf_pq::search")`` (the function's
    qualified name by default)."""

    def deco(fn):
        return range(name or fn.__qualname__)(fn)

    return deco
