"""Admission queue + deadline coalescing policy.

Counterpart of ``raft_tpu.serving.batcher``.

The batcher is the host-side half of the serving engine's exactness
story: it only ever *groups and pads* requests into
``utils.shape.query_bucket`` shapes, the shapes the engine warms, so a
coalesced request's result row is bit-identical to a solo search at the
same bucket (the search paths never mix rows; the serving tests pin
that).

Flush policy (the reference's small-batch serving modes — CAGRA
MULTI_CTA/MULTI_KERNEL, cagra_types.hpp:66-116 — solved the same tension
kernel-side; here it is a host admission policy):

- flush as soon as ``max_batch`` same-``k`` requests are pending
  (throughput bound), or
- when the OLDEST pending request has waited ``max_wait_us``
  (latency bound — the deadline is per-admission, so a trickle of
  singletons never waits more than one deadline).

Requests with different ``k`` never coalesce (the search runs one k a
batch); the queue stays FIFO across ``k`` groups so a rare
``k`` cannot be starved by a hot one.

All waiting happens against an injectable ``clock`` so the deterministic
CPU tests drive the policy with a fake clock and no threads.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

__all__ = ["Request", "Batch", "Batcher", "QueueFull", "EngineStopped",
           "DeadlineExceeded"]


class QueueFull(RuntimeError):
    """Admission queue at capacity and ``block=False``."""


class EngineStopped(RuntimeError):
    """Submitted to / pending in an engine that has been stopped."""


class DeadlineExceeded(RuntimeError):
    """The request's ``deadline_ms`` passed before its batch launched (or,
    for :meth:`Engine.search`, before the result came back). Always a
    typed failure on the future — a shed request is never silently
    dropped."""


class Request:
    """One in-flight query: payload + future + timing breadcrumbs.

    ``t_deadline`` (absolute, engine clock) is the shed deadline derived
    from the caller's ``deadline_ms``: a request still queued past it is
    shed at the next launch attempt instead of riding a batch whose
    result the caller has already given up on.

    ``trace_id`` is the span id minted at ``Engine.submit()`` and
    propagated through every phase record;
    ``t_admit`` marks when admission finished (``put`` returned), so the
    span can split admission wait from queue wait."""

    __slots__ = ("query", "k", "future", "t_submit", "t_launch",
                 "t_deadline", "trace_id", "t_admit")

    def __init__(self, query: np.ndarray, k: int, future, t_submit: float,
                 t_deadline: Optional[float] = None,
                 trace_id: Optional[str] = None):
        self.query = query
        self.k = k
        self.future = future
        self.t_submit = t_submit
        self.t_launch: Optional[float] = None
        self.t_deadline = t_deadline
        self.trace_id = trace_id
        self.t_admit: Optional[float] = None

    def remaining_ms(self, now: float) -> Optional[float]:
        """Latency budget left at ``now``, ms — admission + queue time
        already consumed; None for a request without a deadline. May be
        negative (past-deadline); THE deadline arithmetic for shed
        pruning (:meth:`Batcher.select`) and the engine's adaptive
        operating-point policy, so the two can never disagree."""
        if self.t_deadline is None:
            return None
        return (self.t_deadline - now) * 1e3

    def expired(self, now: float) -> bool:
        """True when the shed deadline has passed (deadline-less
        requests never expire)."""
        rem = self.remaining_ms(now)
        return rem is not None and rem <= 0.0


class Batch:
    """A coalesced, launched batch riding the completion queue.

    ``searcher`` is the handle that served the launch — snapshotted per
    batch so a concurrent :meth:`Engine.swap_index` never splits one
    batch across two indexes, and so the exactness oracle can verify each
    result against whichever index actually served it.

    ``meta`` carries the batch breadcrumbs for the span records (batch
    id, searcher generation, coverage, pad/copy time) from dispatch to
    the completion thread. ``events`` is the (start, done) pair of CUDA
    events recorded around the search on the dispatch stream (None on the
    CPU): the completion thread waits on ``done`` before its readback."""

    __slots__ = ("requests", "distances", "indices", "t_launch", "bucket",
                 "searcher", "meta", "events")

    def __init__(self, requests: List[Request], distances, indices,
                 t_launch: float, bucket: int, searcher=None, meta=None,
                 events=None):
        self.requests = requests
        self.distances = distances
        self.indices = indices
        self.t_launch = t_launch
        self.bucket = bucket
        self.searcher = searcher
        self.meta = meta
        self.events = events


class Batcher:
    """Thread-safe FIFO admission queue with same-``k`` coalescing.

    ``put`` never blocks past backpressure; ``take`` returns the next
    batch according to the ``(max_batch, max_wait_us)`` policy. The
    policy itself (:meth:`select`) is pure given the queue contents and
    a timestamp, which is what the fake-clock tests exercise.
    """

    def __init__(self, max_batch: int = 64, max_wait_us: int = 2000,
                 queue_limit: int = 4096,
                 clock: Callable[[], float] = time.perf_counter):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_s = max(int(max_wait_us), 0) * 1e-6
        self.queue_limit = int(queue_limit)
        self.clock = clock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._queue: List[Request] = []  # guarded_by: _lock
        self._expired: List[Request] = []  # guarded_by: _lock
        self._stopping = False  # guarded_by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    # ---------------------------------------------------------- admission
    def put(self, req: Request, block: bool = True,
            timeout: Optional[float] = None) -> None:
        with self._lock:
            if self._stopping:
                raise EngineStopped("engine is stopped; no new requests")
            if len(self._queue) >= self.queue_limit:
                if not block:
                    raise QueueFull(
                        f"admission queue at capacity ({self.queue_limit})")
                deadline = None if timeout is None else (
                    self.clock() + timeout)
                while len(self._queue) >= self.queue_limit:
                    if self._stopping:
                        raise EngineStopped(
                            "engine stopped while waiting for queue space")
                    remaining = (None if deadline is None
                                 else deadline - self.clock())
                    if remaining is not None and remaining <= 0:
                        raise QueueFull(
                            f"admission queue at capacity "
                            f"({self.queue_limit}) after {timeout}s")
                    self._space.wait(remaining)
            self._queue.append(req)
            self._nonempty.notify()

    # ------------------------------------------------------------- policy
    def select(self, now: float) -> Optional[List[Request]]:
        """The pure flush decision: given the current queue and ``now``,
        return the requests to launch, or None to keep waiting.

        Must be called with the lock held (``take`` does); exposed for
        the deterministic tests, which call it under :meth:`locked`.

        Requests whose shed deadline (``t_deadline``) has passed are
        pruned BEFORE batch selection — they never ride a launch — and
        parked for :meth:`pop_expired`, where the engine fails their
        futures with :class:`DeadlineExceeded`.
        """
        expired = [r for r in self._queue if r.expired(now)]
        if expired:
            self._queue = [r for r in self._queue if r not in expired]
            self._expired.extend(expired)
            self._space.notify_all()
        if not self._queue:
            return None
        head = self._queue[0]
        ready = [r for r in self._queue if r.k == head.k][:self.max_batch]
        if (len(ready) >= self.max_batch
                or now - head.t_submit >= self.max_wait_s
                or self._stopping):
            for r in ready:
                self._queue.remove(r)
            self._space.notify_all()
            return ready
        return None

    def peek(self) -> Optional[List[Request]]:
        """Non-consuming view of the batch the flush policy is forming:
        the head-k group :meth:`select` would launch, *including* before
        the flush condition fires (the whole point — a prefetcher wants
        the batch while it is still coalescing, so host→device staging
        overlaps the previous batch's device time).

        Strictly read-only: expired requests are filtered from the view
        but stay queued — pruning into ``_expired`` remains
        :meth:`select`'s job on the consuming path, so deadline
        accounting is identical whether or not anyone peeks. The view
        is advisory (a race with ``take`` may launch a different
        batch); callers must treat it as a hint, never as ownership.
        """
        with self._lock:
            now = self.clock()
            live = [r for r in self._queue if not r.expired(now)]
            if not live:
                return None
            head = live[0]
            return [r for r in live if r.k == head.k][:self.max_batch]

    def locked(self):
        """Context manager over the internal lock (test hook)."""
        return self._lock

    def pop_expired(self) -> List[Request]:
        """Drain the requests :meth:`select` pruned for passing their shed
        deadline. The engine's dispatch loop calls this after every
        ``take`` and fails the futures with :class:`DeadlineExceeded`."""
        with self._lock:
            expired, self._expired = self._expired, []
            return expired

    # -------------------------------------------------------------- take
    def take(self, block: bool = True) -> Optional[List[Request]]:
        """Next batch per the flush policy; None when ``block=False`` and
        nothing is ready, or when stopping and the queue is drained."""
        with self._lock:
            while True:
                if self._stopping and not self._queue:
                    return None
                batch = self.select(self.clock())
                if batch is not None:
                    return batch
                if self._expired and not block:
                    return None
                if self._expired:
                    # wake the dispatch loop so shed futures fail promptly
                    # (it calls pop_expired after every take)
                    return []
                if not block:
                    return None
                if self._queue:
                    # sleep only until the next actionable instant: the
                    # oldest request's flush deadline, or the earliest
                    # shed deadline (a request must fail promptly at its
                    # deadline_ms even when the flush deadline is far)
                    wake = self._queue[0].t_submit + self.max_wait_s
                    for r in self._queue:
                        if r.t_deadline is not None:
                            wake = min(wake, r.t_deadline)
                    # timeout 0.0 is a valid "re-check immediately" (the
                    # deadline raced past between select() and here)
                    self._nonempty.wait(max(wake - self.clock(), 0.0))
                else:
                    self._nonempty.wait()

    # ----------------------------------------------------------- shutdown
    def stop(self, drain: bool) -> List[Request]:
        """Mark stopping. With ``drain`` the queued requests stay for the
        dispatch loop to flush (deadlines are voided — everything pending
        launches immediately); otherwise they are removed and returned so
        the caller can fail their futures."""
        with self._lock:
            self._stopping = True
            cancelled: List[Request] = []
            if not drain:
                cancelled, self._queue = self._queue, []
            self._nonempty.notify_all()
            self._space.notify_all()
            return cancelled

    @property
    def stopping(self) -> bool:
        with self._lock:
            return self._stopping
