"""raft_tpu_torch.obs — unified telemetry: metrics, trace spans, exposition.

Counterpart of ``raft_tpu.obs`` (the port's own copies; the JAX package
is never imported), with the same family names so one dashboard reads
both packages:

- :mod:`~raft_tpu_torch.obs.metrics` — lock-cheap Counter/Gauge/Histogram
  registry with Prometheus text + JSON exposition (stdlib-only);
- :mod:`~raft_tpu_torch.obs.spans` — per-request trace span records and
  pluggable JSONL/in-memory sinks (stdlib-only);
- :mod:`~raft_tpu_torch.obs.device` — kernel-build counters
  (``raft_tpu_kernel_build_total``, the port's counterpart of
  ``raft_tpu_xla_compile_total``) and ``profile_session()`` over
  ``torch.profiler`` (imports torch lazily);
- :mod:`~raft_tpu_torch.obs.httpd` — the ``/metrics`` + ``/healthz`` +
  ``/slo`` + ``/debug/bundle`` server an Engine exposes;
- :mod:`~raft_tpu_torch.obs.diagnostics` — flight-recorder bundles (the
  span tape + registry snapshot + health frozen at a moment of interest);
- :mod:`~raft_tpu_torch.obs.explain` — per-search execution-plan
  attribution (ExplainRecord + the ``raft_tpu_dispatch_total`` reason
  counter);
- :mod:`~raft_tpu_torch.obs.quality` — shadow sampling and the online
  recall estimator behind ``raft_tpu_online_recall``;
- :mod:`~raft_tpu_torch.obs.slo` — declarative SLOs → error-budget
  burn-rate gauges and the ``/slo`` report.

The JAX package's ``obs.costs`` (compiled-cost roofline reports) comes
with the planner (ROADMAP Queue A item 10).

Layering: obs sits beside ``core`` — serving/parallel/neighbors/ops
import obs, never the reverse.
"""

from raft_tpu_torch.obs.device import (compile_count, compile_seconds,
                                       install_compile_metrics,
                                       profile_session)
from raft_tpu_torch.obs.diagnostics import (build_bundle, load_bundle,
                                            write_bundle)
from raft_tpu_torch.obs.explain import (REASONS, ExplainRecord, capture,
                                        dispatch_counts, record_dispatch)
from raft_tpu_torch.obs.httpd import MetricsServer
from raft_tpu_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, REGISTRY,
                                        Counter, Gauge, Histogram,
                                        HistogramSnapshot, Registry,
                                        exponential_buckets)
from raft_tpu_torch.obs.quality import (OnlineRecallEstimator, ShadowSampler,
                                        overlap_at_k)
from raft_tpu_torch.obs.slo import SLO, SLOMonitor
from raft_tpu_torch.obs.spans import (JsonlSink, ListSink, NullSink,
                                      RingSink, new_trace_id, read_jsonl,
                                      safe_emit, timed_span)

__all__ = [
    # metrics
    "Counter", "Gauge", "Histogram", "HistogramSnapshot", "Registry",
    "REGISTRY", "DEFAULT_LATENCY_BUCKETS", "exponential_buckets",
    # spans
    "JsonlSink", "ListSink", "NullSink", "RingSink", "new_trace_id",
    "read_jsonl", "safe_emit", "timed_span",
    # diagnostics
    "build_bundle", "write_bundle", "load_bundle",
    # device
    "compile_count", "compile_seconds", "install_compile_metrics",
    "profile_session",
    # explain / quality / slo
    "ExplainRecord", "REASONS", "capture", "record_dispatch",
    "dispatch_counts", "OnlineRecallEstimator", "ShadowSampler",
    "overlap_at_k", "SLO", "SLOMonitor",
    # exposition
    "MetricsServer",
]
