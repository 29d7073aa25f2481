"""Serving observability as a thin view over the obs metrics registry.

Counterpart of ``raft_tpu.serving.stats``: the storage is the
:mod:`raft_tpu_torch.obs.metrics` registry, so the same numbers a test
asserts are the ones ``GET /metrics`` scrapes — one source of truth, no
parallel bookkeeping. :class:`ServingStats` keeps its entire old API (``n_*``
counters, ``record_*`` methods, ``snapshot()``, ``reset_samples()``)
as properties/views over registry families labeled by engine:

- ``raft_tpu_serving_requests_total{engine,event}`` — submitted,
  completed, cancelled, shed_deadline, rejected_overload,
  rejected_breaker, failed (every typed outcome is a labeled child,
  pre-touched to 0 so a scrape shows the full outcome vocabulary).
- ``raft_tpu_serving_batches_total`` / ``_batch_errors_total`` /
  ``_hangs_total`` / ``_breaker_trips_total`` / ``_swaps_total``.
- ``raft_tpu_serving_batches_by_size_total{engine,size}`` and
  ``_by_bucket_total{engine,bucket}`` — the exact batch/bucket
  histograms the coalescing tests assert.
- ``raft_tpu_serving_queue_wait_seconds`` / ``_device_seconds`` /
  ``_total_seconds`` — exponential-bucket histograms replacing the old
  sample deques. ``snapshot()`` percentiles are bucket-interpolated
  over the window since the last ``reset_samples()`` (snapshot diff);
  means stay exact (sums are exact).

The nearest-rank :func:`percentiles` helper stays: bench tooling ranks
raw sample lists with it, where "a latency that actually happened" is
the right semantics.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional, Sequence

from raft_tpu_torch.obs import metrics as obs_metrics

__all__ = ["ServingStats", "percentiles"]

_engine_seq = itertools.count()


def percentiles(samples: Sequence[float],
                pcts=(50.0, 95.0, 99.0)) -> Dict[str, float]:
    """Nearest-rank percentiles of ``samples`` as ``{"p50": ...}``.

    Nearest-rank (ceil(p/100 * n) - 1 on the sorted samples) rather than
    interpolation: a latency percentile should be a latency that actually
    happened, and a few host-contention outliers are exactly what
    interpolation against the median would smear away.
    """
    if not samples:
        return {f"p{int(p) if float(p).is_integer() else p}": float("nan")
                for p in pcts}
    s = sorted(samples)
    out = {}
    for p in pcts:
        rank = max(int(-(-(p / 100.0) * len(s) // 1)) - 1, 0)  # ceil - 1
        key = f"p{int(p) if float(p).is_integer() else p}"
        out[key] = s[min(rank, len(s) - 1)]
    return out


#: the typed request outcomes (requests_total's ``event`` vocabulary)
_REQUEST_EVENTS = ("submitted", "completed", "cancelled", "shed_deadline",
                   "rejected_overload", "rejected_breaker", "failed")

#: shadow-sampling accounting (shadow_total's ``event`` vocabulary) —
#: mirrors obs.quality.SHADOW_EVENTS; sampled = evaluated + shed_queue +
#: shed_deadline + shed_close + error + still-queued at every instant
_SHADOW_EVENTS = ("sampled", "evaluated", "shed_queue", "shed_deadline",
                  "shed_close", "error")


class ServingStats:
    """Counters + latency histograms for one :class:`Engine`, stored on a
    metrics registry (default: the process-global one).

    Three per-request latency components, all observed in seconds:

    - ``queue_wait``: admission → batch launch (the coalescing deadline's
      direct cost; bounded by ``max_wait_us`` under light load).
    - ``device``: batch launch → results on host (device execution plus
      readback, amortized over the batch).
    - ``total``: admission → future resolved.

    ``window`` is kept for API compatibility; windowing is now by
    snapshot diff (``reset_samples()`` re-baselines), so it is unused.
    """

    def __init__(self, window: int = 8192,
                 registry: Optional[obs_metrics.Registry] = None,
                 engine_label: Optional[str] = None):
        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self.engine_label = engine_label or f"engine{next(_engine_seq)}"
        self._lock = threading.Lock()
        # [(old, new), ...] per swap
        self.coverage_transitions = []  # guarded_by: _lock
        r, e = self.registry, self.engine_label

        req = r.counter(
            "raft_tpu_serving_requests_total",
            "Serving requests by typed outcome event.", ("engine", "event"))
        # pre-touch every outcome child: a scrape must show the shed /
        # reject counters at 0, not omit them until the first incident
        self._req = {ev: req.labels(e, ev) for ev in _REQUEST_EVENTS}

        self._batches = r.counter(
            "raft_tpu_serving_batches_total",
            "Coalesced batches completed.", ("engine",)).labels(e)
        self._batch_errors = r.counter(
            "raft_tpu_serving_batch_errors_total",
            "Batches failed (any cause).", ("engine",)).labels(e)
        self._hangs = r.counter(
            "raft_tpu_serving_hangs_total",
            "Watchdog-detected device hangs.", ("engine",)).labels(e)
        self._breaker_trips = r.counter(
            "raft_tpu_serving_breaker_trips_total",
            "Circuit breaker transitions to open.", ("engine",)).labels(e)
        self._swaps = r.counter(
            "raft_tpu_serving_swaps_total",
            "Hot index swaps.", ("engine",)).labels(e)
        self._by_size = r.counter(
            "raft_tpu_serving_batches_by_size_total",
            "Completed batches by coalesced size.", ("engine", "size"))
        self._by_bucket = r.counter(
            "raft_tpu_serving_batches_by_bucket_total",
            "Completed batches by padded shape bucket.", ("engine", "bucket"))
        shadow = r.counter(
            "raft_tpu_serving_shadow_total",
            "Shadow recall-sampling accounting by typed event.",
            ("engine", "event"))
        # pre-touched like requests_total: a scrape shows sheds at 0, and
        # the span<->counter reconciliation can enumerate the vocabulary
        self._shadow = {ev: shadow.labels(e, ev) for ev in _SHADOW_EVENTS}
        self._coverage = r.gauge(
            "raft_tpu_serving_coverage",
            "Current searcher shard coverage (1.0 = full index).",
            ("engine",)).labels(e)
        self._coverage.set(1.0)

        self._hists = {
            "queue_wait": r.histogram(
                "raft_tpu_serving_queue_wait_seconds",
                "Admission to batch launch.", ("engine",)).labels(e),
            "device": r.histogram(
                "raft_tpu_serving_device_seconds",
                "Batch launch to results on host (per rider).",
                ("engine",)).labels(e),
            "total": r.histogram(
                "raft_tpu_serving_total_seconds",
                "Admission to future resolved.", ("engine",)).labels(e),
        }
        # windowing: snapshot() diffs against these baselines.
        # rebind-only: reset_samples() publishes a fresh immutable dict;
        # readers capture ONE local reference so a concurrent re-baseline
        # cannot mix old and new baselines within a single snapshot
        self._base = {k: h.snapshot()
                      for k, h in self._hists.items()}  # guarded_by: atomic

    # --------------------------------------------------- counter views
    @property
    def n_submitted(self) -> int:
        return int(self._req["submitted"].value)

    @property
    def n_completed(self) -> int:
        return int(self._req["completed"].value)

    @property
    def n_cancelled(self) -> int:
        return int(self._req["cancelled"].value)

    @property
    def n_shed_deadline(self) -> int:
        return int(self._req["shed_deadline"].value)

    @property
    def n_rejected_overload(self) -> int:
        return int(self._req["rejected_overload"].value)

    @property
    def n_rejected_breaker(self) -> int:
        return int(self._req["rejected_breaker"].value)

    @property
    def n_failed(self) -> int:
        return int(self._req["failed"].value)

    @property
    def n_batches(self) -> int:
        return int(self._batches.value)

    @property
    def n_batch_errors(self) -> int:
        return int(self._batch_errors.value)

    @property
    def n_hangs(self) -> int:
        return int(self._hangs.value)

    @property
    def n_breaker_trips(self) -> int:
        return int(self._breaker_trips.value)

    @property
    def n_swaps(self) -> int:
        return int(self._swaps.value)

    @property
    def coverage(self) -> float:
        return float(self._coverage.value)

    def _engine_children(self, family):
        """This engine's children of a shared registry family, with the
        leading ``engine`` label stripped: ``[(rest-of-labels, child)]``.
        Works for ANY label arity as long as ``engine`` is first — the
        single filtering path batch/bucket/shadow views all ride, so a
        family growing labels can't silently break one view."""
        return [(k[1:], c) for k, c in family.collect()
                if k and k[0] == self.engine_label]

    @property
    def batch_size_hist(self) -> Dict[int, int]:
        # the registry family is shared process-wide; keep only THIS
        # engine's children (labels are (engine, size))
        return {int(rest[0]): int(c.value)
                for rest, c in sorted(self._engine_children(self._by_size),
                                      key=lambda kv: int(kv[0][0]))}

    @property
    def bucket_hist(self) -> Dict[int, int]:
        return {int(rest[0]): int(c.value)
                for rest, c in sorted(self._engine_children(self._by_bucket),
                                      key=lambda kv: int(kv[0][0]))}

    @property
    def shadow_counts(self) -> Dict[str, int]:
        """This engine's shadow accounting ``{event: count}`` — all five
        events always present (pre-touched)."""
        return {ev: int(child.value) for ev, child in self._shadow.items()}

    # ---------------------------------------------------------- recording
    def record_submit(self, n: int = 1) -> None:
        self._req["submitted"].inc(n)

    def record_cancelled(self, n: int = 1) -> None:
        self._req["cancelled"].inc(n)

    def record_shed_deadline(self, n: int = 1) -> None:
        self._req["shed_deadline"].inc(n)

    def record_rejected(self, kind: str, n: int = 1) -> None:
        """``kind`` is ``"overload"`` (watermark/ramp shed) or
        ``"breaker"`` (circuit open)."""
        key = "rejected_breaker" if kind == "breaker" else \
            "rejected_overload"
        self._req[key].inc(n)

    def record_batch_failed(self, n_requests: int, hang: bool = False
                            ) -> None:
        """One failed batch: its requests resolved with BatchFailed."""
        self._batch_errors.inc()
        self._req["failed"].inc(n_requests)
        if hang:
            self._hangs.inc()

    def record_breaker_trip(self) -> None:
        self._breaker_trips.inc()

    def record_shadow(self, event: str, n: int = 1) -> None:
        """Shadow-sampling accounting (the ``record_event`` callable an
        Engine hands its :class:`~raft_tpu_torch.obs.quality.ShadowSampler`)."""
        self._shadow[event].inc(n)

    def record_swap(self, old_coverage: float, new_coverage: float) -> None:
        self._swaps.inc()
        self._coverage.set(float(new_coverage))
        with self._lock:
            self.coverage_transitions.append(
                (round(float(old_coverage), 6),
                 round(float(new_coverage), 6)))

    def set_coverage(self, coverage: float) -> None:
        self._coverage.set(float(coverage))

    def record_batch(self, batch_size: int, bucket: int,
                     queue_waits: Sequence[float], device_s: float,
                     totals: Sequence[float]) -> None:
        """One completed batch: per-request queue-wait/total samples plus
        the shared device+readback time (every rider pays the same batch
        execution, so one device sample per request keeps the per-request
        view honest without pretending per-row timing exists)."""
        self._batches.inc()
        self._req["completed"].inc(len(totals))
        self._by_size.labels(self.engine_label, batch_size).inc()
        self._by_bucket.labels(self.engine_label, bucket).inc()
        qh, dh, th = (self._hists["queue_wait"], self._hists["device"],
                      self._hists["total"])
        for w in queue_waits:
            qh.observe(w)
        for t in totals:
            th.observe(t)
            dh.observe(device_s)

    # ----------------------------------------------------------- scraping
    def _window_diffs(self):
        base = self._base  # one capture: coherent across components
        return {k: h.snapshot() - base[k]
                for k, h in self._hists.items()}

    def snapshot(self) -> dict:
        """Point-in-time view: counters, histograms, and p50/p95/p99 (ms)
        for each latency component since the last ``reset_samples()``.
        Percentiles are histogram-bucket interpolated (exact to within
        one exponential bucket); means are exact."""
        snap = {
            "n_submitted": self.n_submitted,
            "n_completed": self.n_completed,
            "n_cancelled": self.n_cancelled,
            "n_batches": self.n_batches,
            "n_shed_deadline": self.n_shed_deadline,
            "n_rejected_overload": self.n_rejected_overload,
            "n_rejected_breaker": self.n_rejected_breaker,
            "n_failed": self.n_failed,
            "n_batch_errors": self.n_batch_errors,
            "n_hangs": self.n_hangs,
            "n_breaker_trips": self.n_breaker_trips,
            "n_swaps": self.n_swaps,
            "coverage": self.coverage,
            "batch_size_hist": self.batch_size_hist,
            "bucket_hist": self.bucket_hist,
            "shadow": self.shadow_counts,
        }
        # dispatch attribution rides the snapshot too; the counter is
        # process-global (families dispatch below the serving layer, so
        # there is no serving-engine label to filter on) — the view names
        # that scope explicitly
        dispatch = self.registry.get("raft_tpu_dispatch_total")
        if dispatch is not None:
            snap["dispatch_reasons"] = {
                "/".join(key): int(c.value)
                for key, c in dispatch.collect() if int(c.value)}
        with self._lock:
            snap["coverage_transitions"] = list(self.coverage_transitions)
        if snap["n_batches"]:
            snap["mean_batch_size"] = round(
                sum(k * v for k, v in snap["batch_size_hist"].items())
                / snap["n_batches"], 2)
        base = self._base  # one capture: coherent across components
        for key, name in (("queue_wait", "queue_wait_ms"),
                          ("device", "device_ms"), ("total", "total_ms")):
            diff = self._hists[key].snapshot() - base[key]
            if diff.count > 0:
                snap[name] = {
                    "mean": round(diff.mean * 1e3, 3),
                    "p50": round(diff.quantile(0.50) * 1e3, 3),
                    "p95": round(diff.quantile(0.95) * 1e3, 3),
                    "p99": round(diff.quantile(0.99) * 1e3, 3),
                }
        return snap

    def reset_samples(self) -> None:
        """Re-baseline the latency window (keep counters) — lets a load
        sweep scope percentiles to one offered-load point."""
        self._base = {k: h.snapshot() for k, h in self._hists.items()}

    def queue_wait_p99_s(self) -> float:
        """Cumulative (not windowed) p99 queue wait in seconds. 0.0
        until the first completed batch."""
        return self._hists["queue_wait"].snapshot().quantile(0.99)

    def queue_wait_p99_window_s(self) -> float:
        """p99 queue wait in seconds over the window since the last
        ``reset_samples()`` — the autoscale pressure numerator
        Identical to :meth:`queue_wait_p99_s`
        until someone re-baselines; after a re-baseline it reflects the
        CURRENT operating point, which is what lets autoscale pressure
        fall again when offered load falls (a cumulative p99 is a
        high-water mark and can only ratchet up). The load generator owns
        the re-baseline cadence; the autoscaler only reads."""
        diff = self._hists["queue_wait"].snapshot() - self._base["queue_wait"]
        if not diff.count:
            return 0.0
        return diff.quantile(0.99)

    # convenience for tests / artifacts
    def mean_total_ms(self) -> Optional[float]:
        diff = self._hists["total"].snapshot() - self._base["total"]
        if not diff.count:
            return None
        return diff.mean * 1e3
