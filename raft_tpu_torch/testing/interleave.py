"""Seeded schedule amplification for concurrency tests (a copy of
``raft_tpu.testing.interleave``, which imports nothing of JAX).

Plain pytest runs rarely catch real interleaving bugs: CPython's
default 5 ms switch interval means a racy read-modify-write window of a
few bytecodes almost never gets preempted. :class:`InterleaveAmplifier`
widens those windows two ways, both scoped to a ``with`` block:

* ``sys.setswitchinterval`` is dropped to microseconds, so the GIL
  rotates between runnable threads orders of magnitude more often;
* a ``threading.settrace``/``sys.settrace`` tracer injects seeded
  yield points — tiny sleeps — on line events inside matching files
  (optionally only on lines touching named fields, e.g. the attributes
  carrying ``# guarded_by:`` annotations), so races hide behind the
  GIL's atomicity far less often.

Reproducibility is best-effort, not bit-exact: the seed fixes the yield
pattern per (thread-creation-order, line) but the OS scheduler still
has a vote. In practice a failing seed refails within a few runs, which
is what replayability needs. The seed comes from the
``RAFT_TPU_INTERLEAVE_SEED`` environment variable when not given, so CI
can export one value and chaos failures are replayable locally.

Only threads *started inside* the context are traced
(``threading.settrace`` affects new threads); start workers inside the
``with`` block.
"""

from __future__ import annotations

import itertools
import linecache
import os
import random
import re
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["ENV_SEED", "env_seed", "seeds", "InterleaveAmplifier",
           "guarded_fields"]

ENV_SEED = "RAFT_TPU_INTERLEAVE_SEED"

_GUARD_RE = re.compile(r"self\.(\w+).*#\s*guarded_by:")


def env_seed(default: int = 0) -> int:
    """The CI-exported replay seed, or ``default`` when unset."""
    try:
        return int(os.environ.get(ENV_SEED, default))
    except ValueError:
        return default


def seeds(n: int, base: Optional[int] = None) -> List[int]:
    """``n`` distinct seeds anchored at ``base`` (default: the env
    seed) — the sweep helper for "assert across N seeds" tests."""
    b = env_seed() if base is None else base
    return [b + i for i in range(n)]


def guarded_fields(path: str) -> Tuple[str, ...]:
    """Attribute names carrying ``# guarded_by:`` annotations in a
    source file — natural yield points for that file's classes."""
    names = []
    try:
        with open(path) as f:
            for line in f:
                m = _GUARD_RE.search(line)
                if m:
                    names.append(m.group(1))
    except OSError:
        pass
    return tuple(dict.fromkeys(names))


class InterleaveAmplifier:
    """Context manager that amplifies thread preemption (see module
    docstring). Typical use::

        with InterleaveAmplifier(seed=7, path_filters=("raft_tpu",)):
            ... start threads, hammer the object under test ...

    Parameters
    ----------
    seed:
        Yield-pattern seed; ``None`` reads ``RAFT_TPU_INTERLEAVE_SEED``.
    switch_interval:
        Temporary ``sys.setswitchinterval`` value (seconds).
    yield_probability:
        Chance of injecting a sleep at each eligible line event.
    sleep_s:
        Injected sleep length; half the yields use ``sleep(0)`` (a pure
        GIL drop) instead, mixing long and short perturbations.
    path_filters:
        Substrings; only frames whose filename contains one are traced
        (keep this tight — tracing is expensive).
    fields:
        Optional name substrings; when given, yields fire only on lines
        whose source mentions one (e.g. ``guarded_fields(engine_py)``).
    """

    def __init__(self, seed: Optional[int] = None,
                 switch_interval: float = 1e-5,
                 yield_probability: float = 0.1,
                 sleep_s: float = 2e-5,
                 path_filters: Sequence[str] = ("raft_tpu",),
                 fields: Optional[Iterable[str]] = None):
        self.seed = env_seed() if seed is None else int(seed)
        self.switch_interval = switch_interval
        self.yield_probability = yield_probability
        self.sleep_s = sleep_s
        self.path_filters = tuple(path_filters)
        self.fields = tuple(fields) if fields is not None else None
        self._thread_ids = itertools.count()
        self._local = threading.local()
        self._path_cache: Dict[str, bool] = {}
        self._line_cache: Dict[Tuple[str, int], bool] = {}
        self._old_interval: Optional[float] = None
        self._old_thread_trace = None

    # ------------------------------------------------------------ seeded rng
    def _rng(self) -> random.Random:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            # thread index, not OS ident: creation order is stable for a
            # fixed workload, so the yield pattern replays with the seed
            idx = next(self._thread_ids)
            rng = self._local.rng = random.Random((self.seed << 16) ^ idx)
        return rng

    def _path_matches(self, filename: str) -> bool:
        hit = self._path_cache.get(filename)
        if hit is None:
            hit = any(s in filename for s in self.path_filters)
            self._path_cache[filename] = hit
        return hit

    def _line_matches(self, filename: str, lineno: int) -> bool:
        if self.fields is None:
            return True
        key = (filename, lineno)
        hit = self._line_cache.get(key)
        if hit is None:
            src = linecache.getline(filename, lineno)
            hit = any(f in src for f in self.fields)
            self._line_cache[key] = hit
        return hit

    # --------------------------------------------------------------- tracer
    def _call_tracer(self, frame, event, arg):
        if event != "call" or not self._path_matches(
                frame.f_code.co_filename):
            return None
        rng = self._rng()

        def line_tracer(frame, event, arg):
            if (event == "line" and rng.random() < self.yield_probability
                    and self._line_matches(frame.f_code.co_filename,
                                           frame.f_lineno)):
                time.sleep(self.sleep_s if rng.random() < 0.5 else 0.0)
            return line_tracer

        return line_tracer

    # ------------------------------------------------------------- lifecycle
    def __enter__(self) -> "InterleaveAmplifier":
        self._old_interval = sys.getswitchinterval()
        sys.setswitchinterval(self.switch_interval)
        gettrace = getattr(threading, "gettrace", lambda: None)
        self._old_thread_trace = gettrace()
        threading.settrace(self._call_tracer)
        sys.settrace(self._call_tracer)
        return self

    def __exit__(self, *exc) -> None:
        sys.settrace(None)
        threading.settrace(self._old_thread_trace)
        if self._old_interval is not None:
            sys.setswitchinterval(self._old_interval)
        return None
