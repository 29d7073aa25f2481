"""Per-request trace spans: trace ids, pluggable event sinks, JSONL.

Counterpart of ``raft_tpu.obs.spans`` (the same record schema).

A *span record* is a flat JSON-serializable dict describing one unit of
traced work — a served request (``kind="request"``), a dispatched batch
(``kind="batch"``), or a tool-level measurement. The serving engine
mints a :func:`new_trace_id` at ``Engine.submit()`` and threads it
through the request's whole life; the batch record carries the trace ids
of its riders so a JSONL file can be joined both ways
(the JAX package's docs/observability.md has the full schema).

Sinks are deliberately tiny: anything with an ``emit(dict)`` method
works. The two shipped sinks are :class:`JsonlSink` (append one JSON
object per line) and :class:`ListSink` (in-memory, for
tests and ad-hoc notebooks). Telemetry must never take down the
instrumented path, so emitters are expected to call through
:func:`safe_emit` — a sink that raises is silenced (and counted on the
default registry).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Iterator, List, Optional

from raft_tpu_torch.obs import metrics as _metrics

__all__ = [
    "current_trace",
    "new_trace_id",
    "trace_scope",
    "JsonlSink",
    "ListSink",
    "NullSink",
    "RingSink",
    "safe_emit",
    "timed_span",
    "read_jsonl",
]

_SINK_ERRORS = _metrics.REGISTRY.counter(
    "raft_tpu_obs_sink_errors_total",
    "Span records dropped because a sink's emit() raised.")


def new_trace_id() -> str:
    """64-bit random hex id (Dapper-style width; 16 chars). os.urandom is
    one syscall — microseconds, fine at serving request rates."""
    return os.urandom(8).hex()


_CURRENT = threading.local()


def current_trace() -> Optional[str]:
    """The trace id of the work this thread is currently executing, or
    None. Set by the serving engine around the device call so deep
    emitters can tag their records with the requesting trace without
    plumbing an argument through every search signature."""
    return getattr(_CURRENT, "trace", None)


@contextlib.contextmanager
def trace_scope(trace_id: Optional[str]) -> Iterator[None]:
    """Bind :func:`current_trace` for the dynamic extent of a block
    (re-entrant: restores the previous binding on exit)."""
    prev = getattr(_CURRENT, "trace", None)
    _CURRENT.trace = trace_id
    try:
        yield
    finally:
        _CURRENT.trace = prev


class NullSink:
    """Discards everything; the disabled-telemetry stand-in."""

    def emit(self, record: dict) -> None:
        pass


class ListSink:
    """Accumulates records in memory (thread-safe). ``records`` returns a
    copy, so tests can reconcile while the engine is still emitting."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[dict] = []  # guarded_by: _lock

    def emit(self, record: dict) -> None:
        with self._lock:
            self._records.append(record)

    @property
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def by_kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r.get("kind") == kind]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


class RingSink:
    """Bounded in-memory ring of the last ``capacity`` span records —
    the flight recorder's tape. Unlike :class:`ListSink` it can run
    forever in a serving process: memory is O(capacity) no matter how
    many spans flow through. ``emit`` is a deque append under a lock
    (the deque's own maxlen does the eviction), cheap enough to tee
    every engine span through unconditionally.

    Optionally tees to ``inner`` (the user's configured sink) so
    installing the recorder never displaces existing telemetry; the
    inner emit rides through :func:`safe_emit` and cannot poison the
    ring."""

    def __init__(self, capacity: int = 512, inner=None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.inner = inner
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._emitted = 0  # guarded_by: _lock

    def emit(self, record: dict) -> None:
        with self._lock:
            self._ring.append(record)
            self._emitted += 1
            # tee under the lock: the inner sink sees records in the
            # same order the ring does, so a frozen bundle's tail is a
            # suffix of the inner sink's stream (two emitters racing
            # outside the lock could cross-order the two sinks)
            if self.inner is not None:
                safe_emit(self.inner, record)

    @property
    def records(self) -> List[dict]:
        """Oldest-first copy of the tape."""
        with self._lock:
            return list(self._ring)

    @property
    def emitted(self) -> int:
        """Total records ever emitted (dropped ones included)."""
        with self._lock:
            return self._emitted

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._emitted - len(self._ring))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class JsonlSink:
    """Appends one JSON object per line to ``path``. Writes are serialized
    under a lock and flushed per record — span rates are batch/request
    scale (hundreds per second), not per-op, so durability wins over
    buffering. Use as a context manager or call ``close()``."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a")  # guarded_by: _lock

    def emit(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True, default=str)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def safe_emit(sink, record: dict) -> None:
    """Emit ``record`` on ``sink`` (None is a no-op); a raising sink is
    counted and silenced — telemetry never fails the serving path."""
    if sink is None:
        return
    try:
        sink.emit(record)
    except Exception:
        _SINK_ERRORS.inc()


@contextlib.contextmanager
def timed_span(sink, kind: str, **fields) -> Iterator[dict]:
    """Context manager: time the body and emit one span record with
    ``duration_ms`` (and ``error`` on exception, which propagates). The
    yielded dict is the record-in-progress — add fields freely."""
    rec = {"kind": kind, "trace_id": fields.pop("trace_id", new_trace_id())}
    rec.update(fields)
    t0 = time.perf_counter()
    try:
        yield rec
    except BaseException as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        rec["duration_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        safe_emit(sink, rec)


def read_jsonl(path: str, kind: Optional[str] = None) -> List[dict]:
    """Load span records back from a JSONL file, optionally filtered by
    ``kind``. Tolerates a torn final line (a crashed writer)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out
