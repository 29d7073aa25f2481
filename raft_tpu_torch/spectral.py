"""Top-level ``raft_tpu_torch.spectral``: an alias of
:mod:`raft_tpu_torch.sparse.spectral` (RAFT's ``raft::spectral`` lives
beside ``sparse``; both import paths work, as in the JAX package)."""

from raft_tpu_torch.sparse.spectral import (  # noqa: F401
    analyze_partition,
    fit_embedding,
    modularity_maximization,
    partition,
)

__all__ = ["analyze_partition", "fit_embedding", "modularity_maximization",
           "partition"]
