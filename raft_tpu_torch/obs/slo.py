"""Declarative SLOs evaluated at scrape time into error-budget burn rates.

Counterpart of ``raft_tpu.obs.slo``.

The serving stack measures everything an SLO needs — typed request
outcomes (``raft_tpu_serving_requests_total``), latency histograms
(``raft_tpu_serving_total_seconds``), and, with shadow sampling on,
online recall (``raft_tpu_online_recall``). This module closes the last
mile: a declarative :class:`SLO` list on the engine config, evaluated
lazily (every read recomputes from the registry, the same convention as
every derived gauge in this repo) into

- ``raft_tpu_slo_burn_rate{engine,slo}`` — how many times faster than
  "exactly at objective" the error budget is being spent over the
  current window. 1.0 = spending the budget exactly; <1 healthy; the
  Google SRE fast-burn alerting convention (a 14.4x burn exhausts a
  30-day budget in ~2 days).
- ``raft_tpu_slo_budget_remaining{engine,slo}`` — ``max(0, 1 - burn)``,
  the window's remaining budget fraction.
- ``GET /slo`` (obs.httpd) — the :meth:`SLOMonitor.report` JSON doc.

Burn-rate math per kind:

- ``availability``: bad = failed + shed_deadline + rejected_* over the
  window; burn = (bad / (good + bad)) / (1 - objective).
- ``latency_p99``: fraction of windowed request latencies over
  ``threshold_ms`` (bucket-interpolated from the histogram), divided by
  the allowed fraction (1 - objective, e.g. 0.01 for a p99 target).
- ``recall_floor``: worst current ``raft_tpu_online_recall`` window
  across (family, k, bucket); burn = (1 - recall) / (1 - objective).
  No shadow samples yet → no data → burn 0 (never alert on silence;
  the shadow shed counters are the guard against silent silence).

Windowing is by baseline snapshot: counters/histograms diff against a
baseline re-taken every ``window_s``. A burn crossing ``fast_burn``
fires ``on_fast_burn(slo_name, burn)`` once per excursion (re-armed
when the burn drops back under) — the Engine wires this to its
rate-limited flight-recorder auto-dump, so the moments that spend the
budget fastest are the ones with a captured span tape.

Layering: registry-only (no serving import); the Engine hands the
monitor its engine label and callbacks.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, Optional, Sequence

from raft_tpu_torch.obs import metrics as _metrics

__all__ = ["SLO", "SLOMonitor", "SLO_KINDS"]

SLO_KINDS = ("availability", "latency_p99", "recall_floor")

#: availability's bad-outcome events (requests_total ``event`` labels);
#: ``cancelled`` is excluded — a client abandoning its future is not a
#: serving failure
_BAD_EVENTS = ("failed", "shed_deadline", "rejected_overload",
               "rejected_breaker")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective.

    ``objective`` is the good fraction for availability (e.g. 0.999)
    and latency (e.g. 0.99 = a p99 target), and the floor itself for
    ``recall_floor`` (e.g. 0.95). ``threshold_ms`` applies to
    ``latency_p99`` only. ``fast_burn`` is the burn-rate multiple whose
    crossing triggers the flight-recorder dump (14.0 ≈ the SRE
    2-day-budget-exhaustion pace)."""

    name: str
    kind: str
    objective: float
    threshold_ms: float = 0.0
    fast_burn: float = 14.0

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(
                f"kind={self.kind!r}: expected one of {SLO_KINDS}")
        if not 0.0 < float(self.objective) < 1.0:
            raise ValueError(
                f"objective={self.objective}: expected a fraction in (0, 1)")
        if self.kind == "latency_p99" and self.threshold_ms <= 0:
            raise ValueError("latency_p99 needs threshold_ms > 0")


def _frac_over(snapshot, threshold_s: float) -> float:
    """Fraction of a HistogramSnapshot's observations above
    ``threshold_s``, linearly interpolated inside the containing bucket
    (the overflow bucket counts whole — no upper bound to interpolate
    against, so the estimate errs toward alerting)."""
    if snapshot.count <= 0:
        return 0.0
    over = 0.0
    lower = 0.0
    for i, upper in enumerate(snapshot.bounds):
        n = snapshot.counts[i]
        if threshold_s <= lower:
            over += n
        elif threshold_s < upper:
            over += n * (upper - threshold_s) / (upper - lower)
        lower = upper
    over += snapshot.counts[-1]  # overflow bucket
    if threshold_s > lower:
        pass  # whole overflow bucket already counted: errs high
    return min(over / snapshot.count, 1.0)


class SLOMonitor:
    """Evaluate ``slos`` for one engine against a registry; exports the
    burn-rate / budget gauges on construction and serves
    :meth:`report` for the ``/slo`` endpoint."""

    def __init__(self, slos: Sequence[SLO], engine_label: str,
                 registry: Optional[_metrics.Registry] = None,
                 on_fast_burn: Optional[Callable[[str, float],
                                                 None]] = None,
                 window_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = tuple(slos)
        self.engine_label = str(engine_label)
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.window_s = float(window_s)
        self.clock = clock
        self._on_fast_burn = on_fast_burn
        self._lock = threading.Lock()
        self._fast_burn_active: Dict[str, bool] = {
            s.name: False for s in self.slos}  # guarded_by: _lock
        self._base = self._take_baseline()  # guarded_by: _lock

        burn = self.registry.gauge(
            "raft_tpu_slo_burn_rate",
            "Error-budget burn-rate multiple over the current window "
            "(1.0 = spending exactly at objective).", ("engine", "slo"))
        budget = self.registry.gauge(
            "raft_tpu_slo_budget_remaining",
            "Remaining error-budget fraction of the current window.",
            ("engine", "slo"))
        for s in self.slos:
            burn.labels(self.engine_label, s.name).set_function(
                lambda s=s: self.burn_rate(s))
            budget.labels(self.engine_label, s.name).set_function(
                lambda s=s: max(0.0, 1.0 - self.burn_rate(s)))

    # ------------------------------------------------------- windowing
    def _take_baseline(self) -> dict:
        return {"t": self.clock(),
                "req": self._request_counts(),
                "latency": self._latency_snapshot()}

    def _maybe_roll(self) -> dict:
        with self._lock:
            if self.clock() - self._base["t"] >= self.window_s:
                self._base = self._take_baseline()
            return self._base

    # --------------------------------------------------- registry reads
    def _request_counts(self) -> Dict[str, int]:
        fam = self.registry.get("raft_tpu_serving_requests_total")
        if fam is None:
            return {}
        return {key[1]: int(c.value) for key, c in fam.collect()
                if key[0] == self.engine_label}

    def _latency_snapshot(self):
        fam = self.registry.get("raft_tpu_serving_total_seconds")
        if fam is None:
            return None
        for key, child in fam.collect():
            if key[0] == self.engine_label:
                return child.snapshot()
        return None

    def _worst_recall(self) -> float:
        fam = self.registry.get("raft_tpu_online_recall")
        if fam is None:
            return math.nan
        worst = math.nan
        for _, child in fam.collect():
            v = float(child.value)
            if not math.isnan(v) and (math.isnan(worst) or v < worst):
                worst = v
        return worst

    # -------------------------------------------------------- burn math
    def burn_rate(self, slo: SLO) -> float:
        """Windowed burn-rate multiple for one SLO (also the gauge
        body); fires the fast-burn callback on upward crossings."""
        base = self._maybe_roll()
        allowed = 1.0 - float(slo.objective)
        if slo.kind == "availability":
            now = self._request_counts()
            bad = sum(max(0, now.get(ev, 0) - base["req"].get(ev, 0))
                      for ev in _BAD_EVENTS)
            good = max(0, now.get("completed", 0)
                       - base["req"].get("completed", 0))
            total = good + bad
            burn = (bad / total / allowed) if total else 0.0
        elif slo.kind == "latency_p99":
            snap = self._latency_snapshot()
            if snap is None:
                burn = 0.0
            else:
                diff = snap - base["latency"] if base["latency"] is not None \
                    else snap
                burn = _frac_over(diff, slo.threshold_ms / 1e3) / allowed \
                    if diff.count else 0.0
        else:  # recall_floor
            recall = self._worst_recall()
            burn = 0.0 if math.isnan(recall) else \
                max(0.0, (1.0 - recall) / allowed)
        self._check_fast_burn(slo, burn)
        return burn

    def _check_fast_burn(self, slo: SLO, burn: float) -> None:
        fire = False
        with self._lock:
            active = self._fast_burn_active[slo.name]
            if burn >= slo.fast_burn and not active:
                self._fast_burn_active[slo.name] = fire = True
            elif burn < slo.fast_burn and active:
                self._fast_burn_active[slo.name] = False
        if fire and self._on_fast_burn is not None:
            try:
                self._on_fast_burn(slo.name, burn)
            except Exception:
                # telemetry never fails the scrape path, but a broken
                # pager hook must not vanish either — count it where
                # the same scrape will surface it
                self.registry.counter(
                    "raft_tpu_slo_callback_errors_total",
                    "fast-burn callbacks that raised.",
                    ("engine", "slo")).labels(
                        self.engine_label, slo.name).inc()

    # ---------------------------------------------------------- report
    def report(self) -> dict:
        """The ``/slo`` JSON doc: every SLO's burn rate, remaining
        budget, and fast-burn state for the current window."""
        base = self._maybe_roll()
        out = {"engine": self.engine_label, "window_s": self.window_s,
               "window_age_s": round(self.clock() - base["t"], 3),
               "slos": []}
        for s in self.slos:
            burn = self.burn_rate(s)
            row = {"name": s.name, "kind": s.kind,
                   "objective": s.objective,
                   "burn_rate": round(burn, 4),
                   "budget_remaining": round(max(0.0, 1.0 - burn), 4),
                   "fast_burn_threshold": s.fast_burn,
                   "fast_burn": burn >= s.fast_burn}
            if s.kind == "latency_p99":
                row["threshold_ms"] = s.threshold_ms
            if s.kind == "recall_floor":
                worst = self._worst_recall()
                if not math.isnan(worst):
                    row["worst_recall"] = round(worst, 6)
            out["slos"].append(row)
        return out
