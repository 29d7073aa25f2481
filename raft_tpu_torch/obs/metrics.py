"""Lock-cheap metrics registry: Counter / Gauge / Histogram families.

Counterpart of ``raft_tpu.obs.metrics``, copied so the port never imports
the JAX package; families and exposition are the same letter for letter,
so one dashboard reads both packages.

The registry is the single aggregation point for everything the repo
counts — serving outcomes, dispatch decisions, kernel builds — exposed
two ways: Prometheus text exposition (``Registry.to_prometheus_text``,
served by :mod:`raft_tpu_torch.obs.httpd`) and a JSON dump
(``Registry.to_json``) for tools that want structured numbers without a
scraper.

Design points:

- **Families + label children.** A family is a named metric with a fixed
  label schema; ``family.labels("a", "b")`` returns (creating on first
  use) the child time series for those label values. Unlabeled families
  proxy the usual ``inc``/``set``/``observe`` straight to their single
  child, so ``REGISTRY.counter("x").inc()`` just works.
- **Lock-cheap hot path.** One tiny ``threading.Lock`` per child guards
  a couple of float adds; the family lock is touched only on first-use
  child creation (callers are expected to hold onto children for hot
  loops, as the serving stats do). No allocation on ``inc``/``observe``.
- **Exponential latency buckets.** :data:`DEFAULT_LATENCY_BUCKETS` spans
  50 µs → ~26 s doubling each step, wide enough for both a single fused
  device call and a pathological queue stall. Histograms observe in
  SECONDS (Prometheus convention); millisecond views are derived.
- **Windowed views by snapshot diff.** ``HistogramChild.snapshot()``
  is O(buckets) and snapshots subtract, so "percentiles since the last
  scrape" is ``(now - before).quantile(q)`` — this is what replaced the
  serving layer's hand-rolled sliding-window deques.
- **Get-or-create is idempotent.** Re-registering a family with the same
  name returns the existing one (schema-checked), so modules can declare
  their metrics at import time without coordinating a central list.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "Registry",
    "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS",
    "exponential_buckets",
]


def exponential_buckets(start: float, factor: float,
                        count: int) -> Tuple[float, ...]:
    """``count`` upper bounds starting at ``start`` multiplying by
    ``factor`` — the standard Prometheus helper. A +Inf bucket is always
    appended implicitly by Histogram; don't include one here."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


#: 50 µs → ~26 s, doubling: covers a warm on-chip call through a
#: breaker-cooldown-sized stall in 20 buckets.
DEFAULT_LATENCY_BUCKETS = exponential_buckets(5e-5, 2.0, 20)


def _fmt(v: float) -> str:
    """Prometheus sample value formatting: integers without the '.0'."""
    if v != v:  # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelstr(names: Sequence[str], values: Sequence[str],
              extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


# --------------------------------------------------------------- children


class CounterChild:
    """One monotonically increasing time series."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0  # guarded_by: _lock

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class GaugeChild:
    """One point-in-time time series; may be backed by a callback so the
    value is computed at scrape time (``set_function``)."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0  # guarded_by: _lock
        self._fn: Optional[
            Callable[[], float]] = None  # guarded_by: _lock

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._fn = None
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate ``fn`` at every read — the scrape-time derivation
        hook (e.g. the serving autoscale pressure gauge)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return float("nan")


class HistogramSnapshot:
    """Immutable point-in-time histogram state. Subtracting two snapshots
    of the same child gives the distribution of what happened between
    them (the windowed-percentile primitive)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...], counts: Tuple[int, ...],
                 total: float, count: int) -> None:
        self.bounds = bounds      # finite upper bounds; +Inf implied last
        self.counts = counts      # per-bucket (NOT cumulative), len+1
        self.sum = total
        self.count = count

    def __sub__(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        if self.bounds != other.bounds:
            raise ValueError("snapshot diff across different bucket layouts")
        return HistogramSnapshot(
            self.bounds,
            tuple(a - b for a, b in zip(self.counts, other.counts)),
            self.sum - other.sum, self.count - other.count)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Linear interpolation within the bucket holding rank ``q`` —
        the Prometheus ``histogram_quantile`` estimator. Returns 0.0 on
        an empty window; observations in the overflow bucket clamp to
        the largest finite bound (they are known only to exceed it)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count <= 0:
            return 0.0
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, n in enumerate(self.counts):
            if n <= 0:
                if i < len(self.bounds):
                    lo = self.bounds[i]
                continue
            if cum + n >= target:
                if i >= len(self.bounds):      # overflow bucket
                    return self.bounds[-1]
                hi = self.bounds[i]
                frac = (target - cum) / n
                return lo + frac * (hi - lo)
            cum += n
            lo = self.bounds[i]
        return self.bounds[-1]


class HistogramChild:
    """One distribution time series with fixed exponential buckets."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # guarded_by: _lock
        self._sum = 0.0  # guarded_by: _lock
        self._count = 0  # guarded_by: _lock

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return HistogramSnapshot(self.bounds, tuple(self._counts),
                                     self._sum, self._count)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


# --------------------------------------------------------------- families


class _Family:
    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[
            Tuple[str, ...], object] = {}  # guarded_by: _lock

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values) -> object:
        """Child for these label values (created on first use). Values
        are stringified, matching Prometheus semantics."""
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(key)} label value(s), schema has "
                f"{len(self.labelnames)} ({self.labelnames})")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _default(self):
        return self.labels()

    def collect(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class Counter(_Family):
    kind = "counter"

    def _make_child(self) -> CounterChild:
        return CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self) -> GaugeChild:
        return GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> None:
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket")
        if len(set(bounds)) != len(bounds):
            raise ValueError("duplicate bucket bounds")
        if bounds and bounds[-1] == math.inf:
            bounds = bounds[:-1]  # +Inf is implicit
        self.bounds = bounds

    def _make_child(self) -> HistogramChild:
        return HistogramChild(self.bounds)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def snapshot(self) -> HistogramSnapshot:
        return self._default().snapshot()


# --------------------------------------------------------------- registry


class Registry:
    """Named families, get-or-create, two exposition formats."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}  # guarded_by: _lock

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {cls.kind}")
                if fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.labelnames}, not {labelnames}")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def collect(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # ----------------------------------------------------- exposition

    def to_prometheus_text(self, prefix: Optional[str] = None) -> str:
        """Prometheus text exposition format 0.0.4. Counters follow the
        ``_total`` suffix convention at registration time (families are
        emitted under their registered names verbatim). ``prefix``
        restricts the dump to families whose name starts with it — the
        fleet's one-target aggregation uses this to append just the
        ``raft_tpu_p2p_*`` transport families from the global registry
        onto a private-registry scrape without duplicating the rest."""
        out: List[str] = []
        for fam in self.collect():
            if prefix is not None and not fam.name.startswith(prefix):
                continue
            children = fam.collect()
            if not children:
                continue
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in children:
                if isinstance(child, HistogramChild):
                    snap = child.snapshot()
                    cum = 0
                    for bound, n in zip(snap.bounds, snap.counts):
                        cum += n
                        ls = _labelstr(fam.labelnames, values,
                                       ("le", _fmt(bound)))
                        out.append(f"{fam.name}_bucket{ls} {cum}")
                    ls = _labelstr(fam.labelnames, values, ("le", "+Inf"))
                    out.append(f"{fam.name}_bucket{ls} {snap.count}")
                    ls = _labelstr(fam.labelnames, values)
                    out.append(f"{fam.name}_sum{ls} {_fmt(snap.sum)}")
                    out.append(f"{fam.name}_count{ls} {snap.count}")
                else:
                    ls = _labelstr(fam.labelnames, values)
                    out.append(f"{fam.name}{ls} {_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def to_json(self) -> dict:
        """Structured dump: {family: {"kind", "help", "labelnames",
        "series": [{"labels": {...}, ...values...}]}}."""
        doc: dict = {}
        for fam in self.collect():
            series = []
            for values, child in fam.collect():
                labels = dict(zip(fam.labelnames, values))
                if isinstance(child, HistogramChild):
                    snap = child.snapshot()
                    series.append({
                        "labels": labels,
                        "count": snap.count,
                        "sum": snap.sum,
                        "buckets": [[b, n] for b, n in
                                    zip(snap.bounds, snap.counts)],
                        "overflow": snap.counts[-1],
                        "p50_ms": snap.quantile(0.50) * 1e3,
                        "p99_ms": snap.quantile(0.99) * 1e3,
                    })
                else:
                    series.append({"labels": labels, "value": child.value})
            doc[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "labelnames": list(fam.labelnames),
                             "series": series}
        return doc

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


#: Process-global default registry. Library modules register their
#: families here at import time; tests wanting isolation pass their own
#: Registry where the API allows it.
REGISTRY = Registry()
