"""raft_tpu_torch.serving — async micro-batching serving engine.

Counterpart of ``raft_tpu.serving`` for one index on one device.
Coalesces concurrent single-query searches into warmed ``query_bucket``
batch shapes in front of every ported index family (brute_force /
ivf_flat / ivf_pq / cagra).

Quick start::

    from raft_tpu_torch import serving

    searcher = serving.ivf_pq_searcher(index, params)
    with serving.Engine(searcher, serving.EngineConfig(
            max_batch=64, max_wait_us=2000)) as eng:
        fut = eng.submit(query, k=10)        # -> concurrent.futures.Future
        distances, indices = fut.result()    # rows, bit-identical to solo

Typed failures (classify by ``isinstance``): ``BatchFailed`` (one batch's
device call failed or hung; cause on ``.cause``), ``Overloaded``
(admission shed), ``CircuitOpen`` (breaker open after a hang; an
``Overloaded``), ``QueueFull`` (``block=False`` at capacity),
``EngineStopped`` and ``DeadlineExceeded`` (the request's budget is
spent).

Only the ported names are exported. The elastic searcher serves a
sharded checkpoint restored onto one device, degraded (coverage < 1) or
full; the tiered searcher an IVF-PQ index whose lists live in pinned host
memory behind a slab arena; the mutable searcher a ``MutableIvf``, whose
writes go through ``Engine.writer()`` (``WriteStalled``, ``CompactorCrashed``
are its typed failures).

The replica fleet: ``Fleet`` routes single requests over N replicas by
power of two choices (``Router``), retries typed failures on a sibling
under the request's remaining deadline (``RetryPolicy``), upgrades
replicas one at a time above ``FleetConfig.quorum`` (``rolling_swap``)
and sheds typed when it cannot serve (``NoReplicaAvailable``,
``RetriesExhausted``; ``FleetBelowQuorum`` refuses an upgrade).
``RemoteReplica`` puts a replica in another process
(``python -m raft_tpu_torch.serving.replica_main``) behind the same
surface, and ``Autoscaler`` grows and shrinks the fleet on the pressure
gauge and SLO fast burns.
"""

from raft_tpu_torch.core.errors import IntegrityError
from raft_tpu_torch.serving.autoscaler import (AUTOSCALE_REASONS, Autoscaler,
                                               AutoscalerConfig)
from raft_tpu_torch.serving.batcher import (Batch, Batcher, DeadlineExceeded,
                                            EngineStopped, QueueFull, Request)
from raft_tpu_torch.serving.engine import (BatchFailed, CircuitBreaker,
                                           CircuitOpen, Engine, EngineConfig,
                                           Overloaded, compile_count,
                                           solo_reference,
                                           verify_bit_identity)
from raft_tpu_torch.serving.fleet import Fleet, FleetConfig, Replica
from raft_tpu_torch.serving.remote import RemoteReplica
from raft_tpu_torch.serving.router import (FleetBelowQuorum,
                                           NoReplicaAvailable,
                                           ReplicaStarting, RetriesExhausted,
                                           RetryPolicy, Router, failure_kind,
                                           is_retryable)
from raft_tpu_torch.serving.searchers import (Searcher, brute_force_searcher,
                                              cagra_searcher,
                                              elastic_searcher,
                                              ivf_flat_searcher,
                                              ivf_pq_searcher, make_searcher,
                                              mutable_ivf_searcher,
                                              tiered_ivf_pq_searcher)
from raft_tpu_torch.serving.stats import ServingStats, percentiles
from raft_tpu_torch.neighbors.mutable import CompactorCrashed, WriteStalled

__all__ = [
    "AUTOSCALE_REASONS",
    "Autoscaler",
    "AutoscalerConfig",
    "Batch",
    "BatchFailed",
    "Batcher",
    "CircuitBreaker",
    "CircuitOpen",
    "CompactorCrashed",
    "DeadlineExceeded",
    "Engine",
    "EngineConfig",
    "EngineStopped",
    "Fleet",
    "FleetBelowQuorum",
    "FleetConfig",
    "IntegrityError",
    "NoReplicaAvailable",
    "Overloaded",
    "QueueFull",
    "Request",
    "RemoteReplica",
    "Replica",
    "ReplicaStarting",
    "RetriesExhausted",
    "RetryPolicy",
    "Router",
    "Searcher",
    "ServingStats",
    "brute_force_searcher",
    "cagra_searcher",
    "compile_count",
    "elastic_searcher",
    "failure_kind",
    "is_retryable",
    "ivf_flat_searcher",
    "ivf_pq_searcher",
    "make_searcher",
    "mutable_ivf_searcher",
    "percentiles",
    "solo_reference",
    "tiered_ivf_pq_searcher",
    "verify_bit_identity",
    "WriteStalled",
]
