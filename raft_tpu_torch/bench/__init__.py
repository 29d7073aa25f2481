"""Benchmark harness: raft-ann-bench-shaped run configs (``conf/``, the
JAX package's, byte for byte), QPS/recall measurement, CSV + pareto export,
groundtruth generation (``python -m raft_tpu_torch.bench``), with the
port's own chip scripts (``datagen``, ``probe``, ``serve_load``,
``breakdown``, ``kernel_ab``, ``ablate``, ``ivf_pq_timing``,
``write_tiers``)."""

from raft_tpu_torch.bench import export, runner
from raft_tpu_torch.bench.runner import (
    ALGOS,
    AnnAlgo,
    DatasetSpec,
    generate_groundtruth,
    run_benchmark,
)

__all__ = ["export", "runner", "ALGOS", "AnnAlgo", "DatasetSpec",
           "generate_groundtruth", "run_benchmark"]
