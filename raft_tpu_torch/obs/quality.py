"""Online answer-quality estimation: shadow sampling + windowed recall.

Counterpart of ``raft_tpu.obs.quality``.

Recall in this repo existed only in offline bench artifacts; serving
traffic carried no quality signal at all. This module closes that gap
the way the SLO layer needs it closed — on a sample, off the hot path,
and with every shed *counted*:

- :class:`ShadowSampler` takes a configurable fraction of completed
  batches (the decision is per batch, seeded and deterministic for a
  given request sequence), re-runs the sampled queries on a background
  *oracle* (brute-force exact, or a high-nprobe sibling config), and
  scores the answer the engine actually served by overlap@k against the
  oracle's. The oracle runs on a single daemon worker behind a bounded
  queue: a full queue sheds new samples (``shed_queue``), a stale item
  past the deadline cap is dropped at dequeue (``shed_deadline``) —
  both typed, both counted, never silent. A hung oracle call therefore
  wedges the worker, the queue fills, and pressure surfaces as
  ``shed_queue`` counts rather than hot-path latency.
- :class:`OnlineRecallEstimator` folds each sample into per
  ``(family, k, bucket)`` sliding windows exported as the
  ``raft_tpu_online_recall{family,k,bucket}`` gauge family (evaluated at
  scrape time, like every derived gauge in this repo).

Each evaluated sample also emits a ``kind="shadow_eval"`` span carrying
the ORIGINAL request's trace id, so a trace shows both the serving
answer and its graded quality, and spans reconcile 1:1 with the
``raft_tpu_serving_shadow_total`` counters (the chaos-suite invariant).

Estimator semantics and caveats: overlap@k is
computed against the oracle's ids with served ``-1`` padding excluded
from the numerator but not the denominator (a short answer is a recall
loss, not a smaller problem); sampling is per *batch*, so the estimate
is traffic-weighted, and sheds under pressure bias the window toward
calm periods — the shed counters are published precisely so that bias
is visible.

Layering: numpy + obs only. The serving engine hands this module plain
arrays and callables (``record_event`` routes to ``ServingStats``);
quality.py never imports serving or torch.
"""

from __future__ import annotations

import collections
import contextlib
import math
import queue
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.obs import metrics as _metrics
from raft_tpu_torch.obs import spans as _spans

__all__ = ["overlap_at_k", "OnlineRecallEstimator", "ShadowSampler",
           "SHADOW_EVENTS"]

#: per-request shadow accounting vocabulary; ``sampled`` counts every
#: request offered into the shadow path and equals evaluated +
#: shed_queue + shed_deadline + shed_close + error + (still queued)
#: at all times
SHADOW_EVENTS = ("sampled", "evaluated", "shed_queue", "shed_deadline",
                 "shed_close", "error")


def overlap_at_k(served_ids, oracle_ids) -> float:
    """|served ∩ oracle| / |oracle|: the recall of a served answer graded
    against the oracle's id set for the same query. ``-1`` markers (the
    families' "fewer than k candidates" padding) never count as hits,
    but the denominator stays the oracle's full set — a padded answer IS
    a recall loss."""
    oracle = [int(x) for x in np.asarray(oracle_ids).ravel() if int(x) >= 0]
    if not oracle:
        return 1.0
    served = {int(x) for x in np.asarray(served_ids).ravel() if int(x) >= 0}
    return len(served.intersection(oracle)) / len(oracle)


class OnlineRecallEstimator:
    """Sliding-window recall per (family, k, bucket), exported as the
    ``raft_tpu_online_recall`` gauge family at scrape time."""

    def __init__(self, registry: Optional[_metrics.Registry] = None,
                 window: int = 256):
        self._registry = registry if registry is not None \
            else _metrics.REGISTRY
        self._gauge = self._registry.gauge(
            "raft_tpu_online_recall",
            "Windowed mean overlap@k of served answers vs the shadow "
            "oracle, per family/k/bucket (NaN until the first sample).",
            ("family", "k", "bucket"))
        self._window = int(window)
        self._lock = threading.Lock()
        self._samples: Dict[Tuple[str, int, int],
                            collections.deque] = {}  # guarded_by: _lock

    def observe(self, family: str, k: int, bucket: int,
                recall: float) -> None:
        key = (str(family), int(k), int(bucket))
        with self._lock:
            dq = self._samples.get(key)
            if dq is None:
                dq = self._samples[key] = collections.deque(
                    maxlen=self._window)
                self._gauge.labels(*key).set_function(
                    lambda dq=dq: self._mean(dq))
            dq.append(float(recall))

    def _mean(self, dq) -> float:
        with self._lock:
            return sum(dq) / len(dq) if dq else math.nan

    def snapshot(self) -> Dict[Tuple[str, int, int], Tuple[int, float]]:
        """``{(family, k, bucket): (n_samples_in_window, mean)}`` — the
        host-side view serving_bench compares against its offline
        oracle."""
        with self._lock:
            return {key: (len(dq), sum(dq) / len(dq))
                    for key, dq in self._samples.items() if dq}


class _Sample:
    """One sampled batch in flight to the oracle."""

    __slots__ = ("queries", "k", "riders", "family", "bucket", "t_enqueue")

    def __init__(self, queries, k, riders, family, bucket, t_enqueue):
        self.queries = queries    # [n, dim] host array
        self.k = k                # oracle k (max rider k)
        self.riders = riders      # [(trace_id, k, served_ids), ...]
        self.family = family
        self.bucket = bucket
        self.t_enqueue = t_enqueue


class ShadowSampler:
    """Samples completed batches onto a background oracle and grades the
    served answers (class docstring: module header).

    ``oracle(queries [n, dim], k) -> (distances, indices)`` runs on the
    worker thread only — typically a brute-force exact search or a
    high-nprobe sibling of the serving config. ``record_event(event, n)``
    receives the :data:`SHADOW_EVENTS` accounting (the Engine routes it
    to ``ServingStats.record_shadow``). Spans go through ``safe_emit``:
    a raising sink is counted and silenced, never propagated."""

    def __init__(self, oracle: Callable, rate: float,
                 deadline_ms: float = 250.0, queue_limit: int = 64,
                 seed: int = 0,
                 estimator: Optional[OnlineRecallEstimator] = None,
                 record_event: Optional[Callable[[str, int], None]] = None,
                 span_sink=None, engine_label: str = "engine",
                 registry: Optional[_metrics.Registry] = None,
                 clock: Optional[Callable[[], float]] = None):
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"rate={rate}: expected a fraction in [0, 1]")
        self.rate = float(rate)
        self.deadline_ms = float(deadline_ms)
        self.estimator = estimator if estimator is not None \
            else OnlineRecallEstimator(registry)
        self._record_event = record_event or (lambda event, n: None)
        self._span_sink = span_sink
        self._engine_label = str(engine_label)
        self._rng = np.random.default_rng(int(seed))
        self.clock = clock or time.monotonic
        self._queue: "queue.Queue[Optional[_Sample]]" = queue.Queue(
            maxsize=int(queue_limit))
        # single False->True lifecycle transition; racing offers observe
        # it best-effort (a late offer declines or lands pre-sentinel)
        self._closed = False  # guarded_by: atomic
        self._worker = threading.Thread(
            target=self._run, name="raft-tpu-shadow", daemon=True)
        self._worker.start()
        self._oracle = oracle

    # ---- hot-path side -------------------------------------------------
    def offer(self, queries, served_ids: Sequence, trace_ids: Sequence[str],
              ks: Sequence[int], family: str, bucket: int) -> bool:
        """Called by the completion loop after futures resolve: decide
        (per batch) whether to sample, and enqueue without blocking. A
        full queue counts every rider as ``shed_queue``. Returns whether
        the batch was sampled (queued or shed) — False means the coin
        said skip."""
        if self._closed or self._rng.random() >= self.rate:
            return False
        n = len(trace_ids)
        self._record_event("sampled", n)
        riders = [(trace_ids[j], int(ks[j]), np.array(served_ids[j]))
                  for j in range(n)]
        sample = _Sample(np.array(queries), max(r[1] for r in riders),
                         riders, str(family), int(bucket), self.clock())
        try:
            self._queue.put_nowait(sample)
        except queue.Full:
            self._record_event("shed_queue", n)
            self._emit_spans(sample, "shed_queue", [None] * n)
        return True

    # ---- worker side ---------------------------------------------------
    def _run(self) -> None:
        while True:
            sample = self._queue.get()
            if sample is None:
                return
            n = len(sample.riders)
            lag_ms = (self.clock() - sample.t_enqueue) * 1e3
            if lag_ms > self.deadline_ms:
                # stale before the oracle even started: the answer's
                # quality grade would arrive too late to matter (and the
                # backlog behind it would only grow) — typed shed
                self._record_event("shed_deadline", n)
                self._emit_spans(sample, "shed_deadline", [None] * n)
                continue
            try:
                _, oracle_ids = self._oracle(sample.queries, sample.k)
                oracle_ids = np.asarray(oracle_ids)
                recalls = []
                for j, (_, rk, served) in enumerate(sample.riders):
                    recalls.append(overlap_at_k(
                        served[:rk], oracle_ids[j][:rk]))
            except BaseException:  # noqa: B036 — shadow never kills serving
                self._record_event("error", n)
                self._emit_spans(sample, "error", [None] * n)
                continue
            for (_, rk, _), recall in zip(sample.riders, recalls):
                self.estimator.observe(sample.family, rk, sample.bucket,
                                       recall)
            self._record_event("evaluated", n)
            self._emit_spans(sample, "ok", recalls)

    def _emit_spans(self, sample: _Sample, outcome: str, recalls) -> None:
        if self._span_sink is None:
            return
        lag_ms = round((self.clock() - sample.t_enqueue) * 1e3, 3)
        for (trace_id, rk, _), recall in zip(sample.riders, recalls):
            rec = {"kind": "shadow_eval", "trace_id": trace_id,
                   "engine": self._engine_label, "family": sample.family,
                   "k": rk, "bucket": sample.bucket, "outcome": outcome,
                   "lag_ms": lag_ms}
            if recall is not None:
                rec["recall"] = round(float(recall), 6)
            _spans.safe_emit(self._span_sink, rec)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker; queued samples drain first (the sentinel
        rides the same FIFO), then the thread exits."""
        if self._closed:
            return
        self._closed = True
        # the sentinel must land even when the queue is momentarily full
        # (bounded queue + racing offers): block briefly, then evict one
        # queued sample to make room — dropping the sentinel instead
        # would leave the worker parked on the queue forever
        try:
            self._queue.put(None, timeout=timeout)
        except queue.Full:
            self._record_event("shed_close", 1)
            with contextlib.suppress(queue.Empty):
                self._queue.get_nowait()
            with contextlib.suppress(queue.Full):
                self._queue.put_nowait(None)
        self._worker.join(timeout)
