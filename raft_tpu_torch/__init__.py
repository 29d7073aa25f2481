"""raft_tpu_torch — the PyTorch and CUDA port of raft_tpu, for one H100.

Exact, IVF-Flat, IVF-PQ and CAGRA search, k-means and the sharded path
(``parallel``) run on the card through hand-written CUDA kernels
(``ops.gpu_kernels``); every entry point runs on CUDA unless
the caller passes ``device="cpu"`` (or ``Resources(device="cpu")``), where
each kernel's plain PyTorch version runs instead. The JAX package
``raft_tpu`` is the reference and is never imported here.
"""

from raft_tpu_torch import (cluster, core, interop, neighbors, ops, parallel,
                            stats)
from raft_tpu_torch.core.resources import Resources

__all__ = ["Resources", "cluster", "core", "interop", "neighbors", "ops",
           "parallel", "stats"]
