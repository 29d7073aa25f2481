"""Named trace ranges and profiler captures (counterpart of
``raft_tpu.core.tracing``).

Each range is a ``torch.profiler.record_function`` scope, so it shows on the
host timeline of a ``torch.profiler`` capture beside the kernels it launched.
``range`` works as a context manager and as a decorator, ``annotate`` is the
decorator form, and ``profile`` captures a trace around a region."""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Optional

import torch


class range:  # noqa: A001 — mirrors raft_tpu.core.tracing.range
    """Named trace scope (context manager or decorator)."""

    def __init__(self, name: str):
        self.name = name
        self._stack = []

    def __enter__(self):
        scope = torch.profiler.record_function(self.name)
        scope.__enter__()
        self._stack.append(scope)
        return self

    def __exit__(self, *exc):
        return self._stack.pop().__exit__(*exc)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(self.name):
                return fn(*args, **kwargs)

        return wrapper


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
