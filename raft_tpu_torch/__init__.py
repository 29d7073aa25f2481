"""raft_tpu_torch — the PyTorch and CUDA port of raft_tpu, for one H100.

Exact, IVF-Flat, IVF-PQ and CAGRA search (with refine, the bf16 fast scan,
narrow rows, the mutable write path, tiered and streamed IVF-PQ), k-means,
the distances, the dense and sparse linear algebra, the statistics, the
random ball cover, the graph layer (sparse distances and neighbours, the
MST, single linkage, spectral partitioning, the LAP solver, labels), the
pylibraft-shaped namespaces (``common``, ``distance``, ``random``,
``spatial``), the sharded path over a communicator of ranks
(``parallel``: sharded kNN, IVF-Flat, IVF-PQ, CAGRA and k-means, the
from-file and pod builds, checkpoints, ``init_distributed`` over
``torch.distributed``), the serving engine and its replica fleet
(``serving``), the adaptive planner (``planner``), the benchmark harness
(``bench``) and the telemetry (``obs``). They run on the card through
hand-written CUDA kernels (``ops.gpu_kernels``); every entry point runs on
CUDA unless the caller passes ``device="cpu"`` (or
``Resources(device="cpu")``), where each kernel's plain PyTorch version
runs instead. The JAX package ``raft_tpu`` is the reference and is never
imported here.
"""

from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch import (cluster, core, interop, matrix, neighbors, ops,
                            parallel, sparse, stats, utils)
from raft_tpu_torch import (bench, common, distance, label, planner, random,
                            serving, solver, spatial, spectral)

__version__ = "0.1.0"

__all__ = ["Resources", "bench", "cluster", "common", "core", "distance",
           "interop", "label", "matrix", "neighbors", "ops", "parallel",
           "planner", "random", "serving", "solver", "sparse", "spatial",
           "spectral", "stats", "utils", "__version__"]
