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

Only the ported names are exported. The replica fleet, router,
autoscaler and remote replicas come with ROADMAP Queue A item 12; the
elastic, tiered and mutable searchers raise ``NotImplementedError``
(items 13 and 11).
"""

from raft_tpu_torch.serving.batcher import (Batch, Batcher, DeadlineExceeded,
                                            EngineStopped, QueueFull, Request)
from raft_tpu_torch.serving.engine import (BatchFailed, CircuitBreaker,
                                           CircuitOpen, Engine, EngineConfig,
                                           Overloaded, compile_count,
                                           solo_reference,
                                           verify_bit_identity)
from raft_tpu_torch.serving.searchers import (Searcher, brute_force_searcher,
                                              cagra_searcher,
                                              elastic_searcher,
                                              ivf_flat_searcher,
                                              ivf_pq_searcher, make_searcher,
                                              mutable_ivf_searcher,
                                              tiered_ivf_pq_searcher)
from raft_tpu_torch.serving.stats import ServingStats, percentiles

__all__ = [
    "Batch",
    "BatchFailed",
    "Batcher",
    "CircuitBreaker",
    "CircuitOpen",
    "DeadlineExceeded",
    "Engine",
    "EngineConfig",
    "EngineStopped",
    "Overloaded",
    "QueueFull",
    "Request",
    "Searcher",
    "ServingStats",
    "brute_force_searcher",
    "cagra_searcher",
    "compile_count",
    "elastic_searcher",
    "ivf_flat_searcher",
    "ivf_pq_searcher",
    "make_searcher",
    "mutable_ivf_searcher",
    "percentiles",
    "solo_reference",
    "tiered_ivf_pq_searcher",
    "verify_bit_identity",
]
