"""Committed Pareto frontiers + the deadline-aware operating-point policy.

Counterpart of ``raft_tpu.planner.adaptive`` (host-only: a copy pointed at
the port's ``obs``). The speed/recall knobs (``n_probes``, ``itopk_size``,
``scan_mode``, the query bucket) are fixed when a ``SearchParams`` is
built; this module lets the serving engine pick them per batch:

- ``python -m raft_tpu_torch.planner.sweep`` sweeps the knob grid offline
  against an exact oracle and commits the non-dominated QPS-vs-recall
  frontier as ``raft_tpu_torch/artifacts/PARETO_<platform>.json``
  (:data:`PARETO_SCHEMA`, the JAX package's schema, so a frontier written
  by either package loads in the other; a flat ``"metrics"`` mirror);
- :func:`choose_operating_point` is the policy: given a frontier and the
  batch's remaining latency budget, return the highest-recall point whose
  predicted device time fits — pure and deterministic given (points,
  budget, floor, scale);
- :class:`Calibration` rescales the committed predictions against the
  live device time of the served batches (EWMA of observed/predicted,
  bounded), so a mispredicted frontier corrects itself;
- :class:`AdaptivePlanner` bundles the three for the serving engine and
  attributes every choice: the
  ``raft_tpu_adaptive_choice_total{family,reason}`` counter plus an
  :class:`~raft_tpu_torch.obs.explain.ExplainRecord` into the open
  capture, so each degradation decision rides the request span.

Layering: registry-only, like :mod:`raft_tpu_torch.obs.explain` — no
torch, no neighbors import. The sweep that *produces* frontiers lives in
:mod:`raft_tpu_torch.planner.sweep`.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.obs import metrics as _metrics

__all__ = [
    "ADAPTIVE_REASONS",
    "PARETO_SCHEMA",
    "RECALL_BANDS",
    "OperatingPoint",
    "Choice",
    "Frontier",
    "Calibration",
    "AdaptivePlanner",
    "pareto_prune",
    "choose_operating_point",
    "hypervolume",
    "qps_at_recall",
    "frontier_metrics",
    "load_frontier",
    "record_choice",
    "adaptive_choice_counts",
]

#: Artifact schema tag, the JAX package's (bump on breaking layout
#: changes in both).
PARETO_SCHEMA = "raft_tpu.pareto/v1"

#: The closed choice-reason vocabulary — a subset of
#: :data:`raft_tpu_torch.obs.explain.REASONS` so choices ride the same explain
#: stream as engine dispatch decisions.
ADAPTIVE_REASONS = frozenset({
    "pareto_default",     # highest-recall point fits the budget (or no
                          # deadline: nothing to trade away)
    "deadline_degraded",  # budget forced a lower-recall point
    "floor_clamped",      # recall floor stopped the degradation: the
                          # chosen point may overrun the budget, but it
                          # never dips below the floor
    "no_frontier",        # no committed points for (family, k): static
                          # SearchParams serve, nothing is degraded
})

#: Recall bands the flat metrics mirror (and bench_gate's frontier kind)
#: report best-QPS at.
RECALL_BANDS = (0.80, 0.90, 0.95, 0.99)

_CHOICE = _metrics.REGISTRY.counter(
    "raft_tpu_adaptive_choice_total",
    "Adaptive-planner operating-point choices by family and reason "
    "(raft_tpu_torch.planner.adaptive).",
    ("family", "reason"))


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One measured (params, bucket) point on a QPS-vs-recall frontier.

    ``params`` is the SearchParams override dict the serving handles
    apply per batch (``Searcher.search_with``); ``bucket`` is the query
    bucket the point was measured at; ``predicted_ms`` is the committed
    per-batch device-time prediction the policy budgets against (before
    live calibration); ``roofline_min_ms`` is the obs/costs roofline
    floor for the family entrypoint where peaks are known (None on CPU)
    — a sanity anchor, never below which a prediction is trusted."""

    params: Dict[str, object]
    bucket: int
    qps: float
    recall: float
    predicted_ms: float
    roofline_min_ms: Optional[float] = None

    def to_dict(self) -> dict:
        d = {"params": dict(self.params), "bucket": int(self.bucket),
             "qps": round(float(self.qps), 3),
             "recall": round(float(self.recall), 6),
             "predicted_ms": round(float(self.predicted_ms), 6)}
        if self.roofline_min_ms is not None:
            d["roofline_min_ms"] = round(float(self.roofline_min_ms), 6)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "OperatingPoint":
        return cls(params=dict(d.get("params", {})),
                   bucket=int(d["bucket"]), qps=float(d["qps"]),
                   recall=float(d["recall"]),
                   predicted_ms=float(d["predicted_ms"]),
                   roofline_min_ms=(float(d["roofline_min_ms"])
                                    if d.get("roofline_min_ms") is not None
                                    else None))

    def _sort_key(self):
        # total deterministic order: recall desc, qps desc, time asc,
        # then the params repr as the final tie-break (sweep logs arrive
        # in arbitrary order; the frontier must not depend on it)
        return (-self.recall, -self.qps, self.predicted_ms,
                json.dumps(self.params, sort_keys=True))


def pareto_prune(points: Sequence[OperatingPoint]) -> List[OperatingPoint]:
    """Non-dominated subset of ``points``, highest recall first.

    A point is kept iff no other point has >= recall AND > qps (ties on
    both collapse to one representative via the deterministic sort key).
    The result is monotone: recall strictly decreases down the list and
    qps strictly increases — the invariant the property tests pin."""
    out: List[OperatingPoint] = []
    best_qps = float("-inf")
    for p in sorted(points, key=OperatingPoint._sort_key):
        # sorted recall desc (qps desc within a tie): a point survives
        # iff it beats every higher-recall point's qps strictly, which
        # also collapses recall ties to their best-qps representative
        if p.qps > best_qps:
            out.append(p)
            best_qps = p.qps
    return out


def choose_operating_point(
        points: Sequence[OperatingPoint],
        remaining_budget_ms: Optional[float],
        recall_floor: Optional[float] = None,
        scale: float = 1.0,
) -> Tuple[Optional[OperatingPoint], str]:
    """THE policy: spend the latency budget on recall.

    Pure and deterministic given its arguments (the acceptance
    criterion): no clocks, no globals, no randomness. ``points`` is a
    frontier (any order; re-sorted highest-recall-first internally);
    ``scale`` is the live calibration multiplier applied to every
    ``predicted_ms`` before comparing against the budget.

    Returns ``(point, reason)`` with ``reason`` in
    :data:`ADAPTIVE_REASONS`:

    - no points → ``(None, "no_frontier")`` — serve the static params;
    - no budget (request has no deadline) → highest-recall point,
      ``pareto_default``;
    - the highest-recall point above the floor fits → it,
      ``pareto_default``;
    - a lower point fits → the highest-recall fitting one,
      ``deadline_degraded``;
    - nothing above the floor fits → the fastest point still above the
      floor — ``floor_clamped`` when the floor actually excluded faster
      points, else ``deadline_degraded`` (the frontier simply bottoms
      out above the budget). Degradation stops at the floor by design:
      the point may overrun the budget, but recall never goes below it.
    """
    if not points:
        return None, "no_frontier"
    pts = sorted(points, key=OperatingPoint._sort_key)
    eligible = [p for p in pts
                if recall_floor is None or p.recall >= recall_floor]
    if not eligible:
        # floor above the entire frontier: clamp to the best we have
        return pts[0], "floor_clamped"
    floor_bound = len(eligible) < len(pts)
    if remaining_budget_ms is None:
        return eligible[0], "pareto_default"
    for p in eligible:
        if p.predicted_ms * scale <= remaining_budget_ms:
            return p, ("pareto_default" if p is eligible[0]
                       else "deadline_degraded")
    fastest = eligible[-1]
    return fastest, ("floor_clamped" if floor_bound
                     else "deadline_degraded")


# ------------------------------------------------------- curve summaries
def hypervolume(points: Sequence[OperatingPoint]) -> float:
    """2-D hypervolume of the frontier vs the (recall=0, qps=0)
    reference point — the area under the staircase, the scalar a curve
    refresh is gated on (points may move along the curve freely; the
    dominated area must not shrink)."""
    pruned = pareto_prune(points)  # recall desc, qps asc
    hv = 0.0
    prev_recall = 0.0
    for p in reversed(pruned):  # recall asc, qps desc
        hv += (p.recall - prev_recall) * p.qps
        prev_recall = p.recall
    return hv


def qps_at_recall(points: Sequence[OperatingPoint],
                  band: float) -> Optional[float]:
    """Best QPS among points with recall >= ``band`` (None when the
    frontier never reaches the band)."""
    vals = [p.qps for p in points if p.recall >= band]
    return max(vals) if vals else None


def frontier_metrics(doc: dict) -> Dict[str, float]:
    """Flat ``{metric: value}`` summary of a :data:`PARETO_SCHEMA` doc:
    per (family, k, bucket) curve, the hypervolume and best-QPS per
    recall band — the artifact's ``"metrics"`` mirror, and what
    bench_gate's ``frontier`` kind compares instead of raw points."""
    out: Dict[str, float] = {}
    for fam, fam_doc in sorted((doc.get("families") or {}).items()):
        for k_key, buckets in sorted((fam_doc.get("frontier") or {}).items()):
            for b_key, raw in sorted(buckets.items()):
                pts = [OperatingPoint.from_dict(p) for p in raw]
                stem = f"pareto.{fam}.k{k_key}.b{b_key}"
                out[f"{stem}.hypervolume"] = round(hypervolume(pts), 4)
                out[f"{stem}.n_points"] = float(len(pts))
                for band in RECALL_BANDS:
                    q = qps_at_recall(pts, band)
                    if q is not None:
                        out[f"{stem}.qps_at_r{int(band * 100)}"] = round(
                            q, 3)
    return out


# ------------------------------------------------------------ the artifact
class Frontier:
    """Loaded ``PARETO_<platform>.json``: per-(family, k, bucket) point
    lists, with nearest-bucket lookup for serving."""

    def __init__(self, doc: dict):
        schema = doc.get("schema")
        if schema != PARETO_SCHEMA:
            raise ValueError(
                f"frontier schema {schema!r} != {PARETO_SCHEMA!r} "
                f"(regenerate with python -m raft_tpu_torch.planner.sweep)")
        self.doc = doc
        self.platform = str(doc.get("platform", "unknown"))
        # (family, k) -> {bucket: [OperatingPoint, ...] recall desc}
        self._points: Dict[Tuple[str, int], Dict[int, List[OperatingPoint]]]
        self._points = {}
        for fam, fam_doc in (doc.get("families") or {}).items():
            for k_key, buckets in (fam_doc.get("frontier") or {}).items():
                by_bucket = self._points.setdefault((fam, int(k_key)), {})
                for b_key, raw in buckets.items():
                    by_bucket[int(b_key)] = pareto_prune(
                        OperatingPoint.from_dict(p) for p in raw)

    @property
    def families(self) -> List[str]:
        return sorted({fam for fam, _ in self._points})

    def ks(self, family: str) -> List[int]:
        return sorted(k for fam, k in self._points if fam == family)

    def points(self, family: str, k: int,
               bucket: Optional[int] = None) -> List[OperatingPoint]:
        """Frontier for (family, k) at the measured bucket nearest
        ``bucket``. When the serving bucket differs from the measured
        one, ``predicted_ms`` is scaled linearly by the row ratio — an
        approximation the live :class:`Calibration` corrects — while
        ``bucket`` keeps the measured value for provenance. Empty list
        when the artifact has nothing for (family, k)."""
        by_bucket = self._points.get((str(family), int(k)))
        if not by_bucket:
            return []
        if bucket is None:
            src = max(by_bucket)
        else:
            src = min(by_bucket, key=lambda b: (abs(b - int(bucket)), b))
        pts = by_bucket[src]
        if bucket is None or src == int(bucket):
            return list(pts)
        ratio = int(bucket) / src
        return [dataclasses.replace(p, predicted_ms=p.predicted_ms * ratio)
                for p in pts]


def load_frontier(path: str) -> Frontier:
    """Read + validate a committed ``PARETO_<platform>.json``. Raises
    ``OSError`` on a missing file and ``ValueError`` on a schema
    mismatch — callers that want missing→static-params semantics (the
    engine) catch and serve with no planner frontier."""
    with open(path) as fh:
        return Frontier(json.load(fh))


# ----------------------------------------------------------- calibration
class Calibration:
    """EWMA of observed/predicted device time, bounded.

    The committed ``predicted_ms`` was measured on some machine at some
    point; the serving host's truth is the live device-time histogram.
    Each completed adaptive batch feeds :meth:`observe`; :attr:`scale`
    is the clamped EWMA ratio the policy multiplies predictions by.
    Bounded (``lo``/``hi``) so one pathological sample cannot swing the
    policy to shedding everything or promising the impossible."""

    def __init__(self, alpha: float = 0.2, lo: float = 0.25,
                 hi: float = 4.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.lo, self.hi = float(lo), float(hi)
        self._lock = threading.Lock()
        self._ratio = 1.0  # guarded_by: _lock
        self._n = 0  # guarded_by: _lock

    def observe(self, predicted_ms: float, actual_ms: float) -> None:
        if predicted_ms <= 0.0 or actual_ms <= 0.0:
            return
        # clamp the single observation too: a warmup compile or a hung
        # readback must nudge the EWMA, not own it
        r = min(max(actual_ms / predicted_ms, self.lo), self.hi)
        with self._lock:
            self._ratio += self.alpha * (r - self._ratio)
            self._n += 1

    @property
    def scale(self) -> float:
        with self._lock:
            return min(max(self._ratio, self.lo), self.hi)

    @property
    def n_observed(self) -> int:
        with self._lock:
            return self._n


# ------------------------------------------------------------ attribution
def record_choice(family: str, reason: str,
                  point: Optional[OperatingPoint] = None,
                  budget_ms: Optional[float] = None,
                  predicted_ms: Optional[float] = None) -> None:
    """Attribute one operating-point choice, twice from one call site:
    bump ``raft_tpu_adaptive_choice_total{family,reason}`` and emit an
    explain record (``requested="adaptive"``, ``engine="planner"``) into
    every open capture so the choice rides the batch/request spans
    exactly like the engine-dispatch decisions do. ``reason`` outside
    :data:`ADAPTIVE_REASONS` raises — closed vocabulary, same contract
    as :func:`raft_tpu.obs.explain.record_dispatch`."""
    if reason not in ADAPTIVE_REASONS:
        raise ValueError(f"reason {reason!r} outside the adaptive choice "
                         f"vocabulary {sorted(ADAPTIVE_REASONS)}")
    _CHOICE.labels(family, reason).inc()
    params = dict(point.params) if point is not None else {}
    plan: Dict[str, object] = {}
    if budget_ms is not None:
        plan["budget_ms"] = round(float(budget_ms), 3)
    if predicted_ms is not None:
        plan["predicted_ms"] = round(float(predicted_ms), 3)
    if point is not None:
        plan["recall"] = round(float(point.recall), 6)
    obs_explain.record_dispatch(family, "adaptive", "planner", reason,
                                params=params, plan=plan)


def adaptive_choice_counts(
        registry: Optional[_metrics.Registry] = None) -> Dict[tuple, int]:
    """``{(family, reason): count}`` view of the adaptive choice counter
    (serving_bench's proof that every degradation decision is
    visible)."""
    reg = registry if registry is not None else _metrics.REGISTRY
    fam = reg.get("raft_tpu_adaptive_choice_total")
    if fam is None:
        return {}
    return {tuple(key): int(child.value) for key, child in fam.collect()
            if int(child.value)}


# -------------------------------------------------------------- the planner
@dataclasses.dataclass
class Choice:
    """One resolved operating point, as handed to the engine: the point
    (None on ``no_frontier``), the closed reason, and the calibrated
    prediction the completion loop reconciles against ``device_ms``."""

    point: Optional[OperatingPoint]
    reason: str
    budget_ms: Optional[float]
    predicted_ms: Optional[float]
    scale: float

    def brief(self) -> dict:
        d: Dict[str, object] = {"reason": self.reason,
                                "scale": round(self.scale, 4)}
        if self.budget_ms is not None:
            d["budget_ms"] = round(self.budget_ms, 3)
        if self.point is not None:
            d["params"] = dict(self.point.params)
            d["recall"] = round(self.point.recall, 6)
            d["predicted_ms"] = round(self.predicted_ms, 3)
        return d


class AdaptivePlanner:
    """Frontier + floor + calibration, bundled for the serving engine.

    ``frontier`` may be None (or a path that fails to load may be
    handled by the caller) — every choice is then ``no_frontier`` and
    the engine serves its static SearchParams, attributed. The planner
    is cheap and thread-safe: :meth:`choose` runs on the dispatch
    thread per batch, :meth:`observe` on the completion thread."""

    def __init__(self, frontier: Optional[Frontier] = None,
                 recall_floor: Optional[float] = None,
                 calibration: Optional[Calibration] = None):
        self.frontier = frontier
        self.recall_floor = (float(recall_floor)
                             if recall_floor is not None else None)
        self.calibration = calibration or Calibration()

    @classmethod
    def from_artifact(cls, path: str,
                      recall_floor: Optional[float] = None,
                      calibration: Optional[Calibration] = None
                      ) -> "AdaptivePlanner":
        """Planner from a committed artifact path; a missing or
        schema-mismatched file degrades to a frontier-less planner
        (every choice ``no_frontier``) rather than failing serving."""
        try:
            frontier = load_frontier(path)
        except (OSError, ValueError):
            frontier = None
        return cls(frontier, recall_floor=recall_floor,
                   calibration=calibration)

    def choose(self, family: str, k: int, bucket: Optional[int],
               remaining_budget_ms: Optional[float]) -> Choice:
        """Resolve + attribute the batch's operating point. A negative
        remaining budget (riders already past their deadline still get
        served if the batcher launched them) degrades like a tiny one —
        the fastest floor-eligible point."""
        points = (self.frontier.points(family, k, bucket)
                  if self.frontier is not None else [])
        scale = self.calibration.scale
        point, reason = choose_operating_point(
            points, remaining_budget_ms, self.recall_floor, scale)
        predicted = (point.predicted_ms * scale
                     if point is not None else None)
        record_choice(family, reason, point=point,
                      budget_ms=remaining_budget_ms,
                      predicted_ms=predicted)
        return Choice(point, reason, remaining_budget_ms, predicted,
                      scale)

    def observe(self, predicted_ms: float, actual_ms: float) -> None:
        """Feed one completed adaptive batch's (calibrated prediction,
        measured device_ms) back into the EWMA. The prediction passed in
        is the *calibrated* one the policy used; dividing out the scale
        keeps the loop stable (the EWMA tracks the raw-prediction error,
        not its own output)."""
        scale = self.calibration.scale
        if scale > 0:
            self.calibration.observe(predicted_ms / scale, actual_ms)

    def warm_points(self, family: str, k: int,
                    bucket: Optional[int] = None) -> List[OperatingPoint]:
        """Points the engine pre-compiles at warmup (per warm bucket/k)
        so a deadline-driven param change never pays a cold compile on
        the hot path."""
        if self.frontier is None:
            return []
        return self.frontier.points(family, k, bucket)
