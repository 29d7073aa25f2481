"""Named trace ranges (counterpart of ``raft_tpu.core.tracing.range``).

Each range is a ``torch.profiler.record_function`` scope, so it shows on the
host timeline of a ``torch.profiler`` capture beside the kernels it launched.
Works as a context manager and as a decorator."""

from __future__ import annotations

import functools

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
