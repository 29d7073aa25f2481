"""Execution-plan attribution: every search dispatch explains itself.

Counterpart of ``raft_tpu.obs.explain``. Each family's ``search()`` picks
an engine (the hand-written CUDA kernel, or the unfused torch path) and
says why, three ways from one emission point:

- a structured :class:`ExplainRecord` — family, requested vs resolved
  engine, a reason code from the closed :data:`REASONS` vocabulary, the
  plan (tiles, memory regime, the kernel's route) and the query-shape
  params, with the JAX package's ``params`` keys;
- the ``raft_tpu_dispatch_total{family,engine,reason}`` counter family
  on the default registry, incremented once per public ``search()`` call;
- the thread-local :func:`capture` collector, which the serving engine
  wraps around each batch dispatch so the records ride the batch/request
  spans as ``explain`` breadcrumbs, and which ``search(...,
  explain=True)`` uses to hand the record back to the caller.

Engines keep the port's vocabulary (``ivf_pq.plan_search``): ``"pallas"``
is the fused CUDA kernel of brute force, IVF-Flat and CAGRA,
``"pallas_cache"``/``"pallas_lut"`` IVF-PQ's, and ``"xla"``, ``"cache"``,
``"lut"`` the unfused torch engines. A record whose engine runs a kernel
names it in ``plan["kernel"]`` and its route in ``plan["route"]``:
``"cuda"`` on the card, ``"plain"`` (its plain PyTorch version) on the
CPU; :meth:`ExplainRecord.brief` carries both into the span breadcrumbs.

The port emits two reason codes the JAX package has no use for, added to
its vocabulary:

- ``auto_fused`` — ``scan_mode="auto"`` took the fused route on the CPU,
  through the kernels' plain versions (on the card ``auto`` follows the
  measured verdicts of ``raft_tpu_torch/artifacts/PALLAS_PROBE_*.json``
  with the JAX package's codes: ``auto_fused_wins``, ``fused_loses``,
  ``no_fused_wins_verdict``);
- ``smem`` — CAGRA's beam does not fit one block's shared memory
  (``cagra.plan_search``), so the glue engine serves.

Layering: this module is registry-only (no torch, no neighbors import —
obs sits beside core). The neighbor families and ``ops/select_k`` call
:func:`record_dispatch` / :func:`note_select_k` at their dispatch
points, the family's record before the search body runs, so the select_k
notes of that body attach to it.

Counter semantics: ``raft_tpu_dispatch_total`` counts one decision per
public ``search()`` call, so it reconciles 1:1 with the batch-level span
breadcrumbs. ``select_k``'s AUTO resolution records into the active
capture only; counting it would count a family's inner selections, not
the traffic.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, List, Optional

from raft_tpu_torch.obs import metrics as _metrics

__all__ = [
    "ExplainRecord",
    "REASONS",
    "capture",
    "record_dispatch",
    "note_select_k",
    "dispatch_counts",
]

#: The closed fallback-cause vocabulary: the JAX package's, kept whole so
#: its artifacts replay, plus the two codes only the port emits
#: (``auto_fused``, ``smem``; module docstring). Every dispatch emission
#: MUST use one of these (``unknown`` exists only as the schema's escape
#: hatch for forward-compat readers, never as something the repo emits).
REASONS = frozenset({
    # engine chosen positively
    "forced",                  # scan_mode explicitly named this engine
    "auto_fused_wins",         # measured PALLAS_PROBE verdict routed fused
    "interpret",               # RAFT_TPU_PALLAS_INTERPRET=1 parity hook
    "auto_fused",              # port: auto took the fused route on the CPU
    "only_engine",             # family has a single engine (kept in the
                               # vocabulary for artifact replay; cagra —
                               # its last emitter — now has the fused
                               # Pallas beam engine and dispatches like
                               # the other fused families)
    # fused considered but routed to XLA
    "tpu_absent",              # pallas/auto on a host with no TPU backend
    "no_fused_wins_verdict",   # auto on TPU, probe artifact has no verdict
    "fused_loses",             # auto on TPU, probe measured XLA winning
    "non_l2",                  # metric outside the fused L2 matrix
    "filtered",                # bitset filter (no in-carry filter epilogue)
    "fast_scan",               # bf16 fast scan requested (fp32-only carry)
    "k_gt_1024",               # k above the VMEM top-k carry bound
    "non_float_dtype",         # integer dataset (no float carry)
    "lut_params_unsupported",  # fused-LUT regime needs pq_bits=8 etc.
    "smem",                    # port: CAGRA's beam exceeds shared memory
    # sharded cross-chip merge dispatch (parallel/sharded.py merge_mode;
    # "forced"/"fused_loses" above are shared with the merge ladder)
    "merge_tree",              # auto: log₂S ppermute tree merge (default)
    "merge_ring",              # auto on TPU: measured merge_ring win
    "merge_allgather",         # auto: non-power-of-two mesh fallback
    "no_ring_verdict",         # auto on TPU, probe has no merge_ring row
    # deadline-aware adaptive planning (planner/adaptive.py choice
    # reasons — emitted with requested="adaptive", engine="planner";
    # also counted in raft_tpu_adaptive_choice_total{family,reason})
    "pareto_default",          # highest-recall frontier point fits
    "deadline_degraded",       # budget forced a lower-recall point
    "floor_clamped",           # recall floor stopped the degradation
    "no_frontier",             # no committed points: static params serve
    # schema escape hatch for readers; never emitted by this repo
    "unknown",
})

_DISPATCH = _metrics.REGISTRY.counter(
    "raft_tpu_dispatch_total",
    "Search dispatch decisions by family, resolved engine, and "
    "reason code.",
    ("family", "engine", "reason"))


@dataclasses.dataclass
class ExplainRecord:
    """One dispatch decision, fully attributed.

    ``params`` carries the query-shape side (k, nq, n_probes, metric,
    bucket…); ``plan`` carries the planner side (tile choices, predicted
    workspace/VMEM bytes). Both are flat JSON-safe dicts so a record
    drops straight into a span or a JSONL line.
    """

    family: str      # "brute_force" | "ivf_flat" | "ivf_pq" | "cagra" | ...
    requested: str   # scan_mode as the caller asked ("auto", "pallas", ...)
    engine: str      # what ran: "pallas", "pallas_lut", "xla", "cache", ...
    reason: str      # a REASONS member: why `engine` was the resolution
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    plan: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: trace-time sub-decisions (select_k AUTO resolution) observed while
    #: this record's search was the innermost active capture
    notes: List[dict] = dataclasses.field(default_factory=list)

    def brief(self) -> dict:
        """The span breadcrumb: the attribution triple + request, and the
        kernel and its route when the plan names them (a port addition:
        a served batch says whether the CUDA kernel ran)."""
        out = {"family": self.family, "requested": self.requested,
               "engine": self.engine, "reason": self.reason}
        out.update({key: self.plan[key] for key in ("kernel", "route")
                    if key in self.plan})
        return out

    def to_dict(self) -> dict:
        return {"family": self.family, "requested": self.requested,
                "engine": self.engine, "reason": self.reason,
                "params": dict(self.params), "plan": dict(self.plan),
                "notes": [dict(n) for n in self.notes]}


class _Capture:
    """Collector for one ``with capture():`` scope (single-thread use —
    the scope lives on the thread that opened it)."""

    def __init__(self) -> None:
        self.records: List[ExplainRecord] = []

    @property
    def last(self) -> Optional[ExplainRecord]:
        return self.records[-1] if self.records else None

    def briefs(self) -> List[dict]:
        return [r.brief() for r in self.records]


_tls = threading.local()


def _stack() -> List[_Capture]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


@contextlib.contextmanager
def capture() -> Iterator[_Capture]:
    """Collect every :class:`ExplainRecord` emitted on THIS thread while
    the scope is open. Scopes nest (each record lands in every open
    scope, so an engine-level capture still sees records a tool-level
    inner capture claims). Never raises into the instrumented path."""
    col = _Capture()
    stack = _stack()
    stack.append(col)
    try:
        yield col
    finally:
        # tolerate a peer popping out of order rather than corrupting
        # the instrumented call (telemetry never fails serving)
        with contextlib.suppress(ValueError):
            stack.remove(col)


def record_dispatch(family: str, requested: str, engine: str, reason: str,
                    params: Optional[dict] = None,
                    plan: Optional[dict] = None) -> ExplainRecord:
    """THE emission point: build the record, bump
    ``raft_tpu_dispatch_total{family,engine,reason}``, and hand the
    record to every open :func:`capture` scope on this thread.

    ``reason`` outside :data:`REASONS` is a programming error and
    raises — the vocabulary is closed so dashboards and the
    reconciliation tests can enumerate it."""
    if reason not in REASONS:
        raise ValueError(f"reason {reason!r} outside the documented "
                         f"vocabulary (obs.explain.REASONS)")
    rec = ExplainRecord(family=family, requested=requested, engine=engine,
                        reason=reason, params=dict(params or {}),
                        plan=dict(plan or {}))
    _DISPATCH.labels(family, engine, reason).inc()
    for col in _stack():
        col.records.append(rec)
    return rec


def note_select_k(n: int, k: int, algo: str, k_pad: int = 0) -> None:
    """Attach a select_k AUTO/pad resolution to the active capture(s).

    Runs inside the family search bodies, once per selection, so it
    deliberately does NOT touch the dispatch counter (see the module
    docstring); it exists so ``search(..., explain=True)`` shows the full
    plan of a query."""
    stack = _stack()
    if not stack:
        return
    note = {"op": "select_k", "n": int(n), "k": int(k), "algo": str(algo),
            "k_pad": int(k_pad)}
    for col in stack:
        if col.records:
            col.records[-1].notes.append(note)
        else:
            # select_k used standalone under a capture: synthesize a
            # record so the decision is still attributable
            col.records.append(ExplainRecord(
                family="select_k", requested="auto", engine=str(algo),
                reason="forced", params={"n": int(n), "k": int(k)},
                plan={"k_pad": int(k_pad)}))


def dispatch_counts(
        registry: Optional[_metrics.Registry] = None) -> Dict[tuple, int]:
    """``{(family, engine, reason): count}`` view of the dispatch
    counter — the explain reason histogram."""
    reg = registry if registry is not None else _metrics.REGISTRY
    fam = reg.get("raft_tpu_dispatch_total")
    if fam is None:
        return {}
    return {tuple(key): int(child.value) for key, child in fam.collect()
            if int(child.value)}
