"""Sparse layer (counterpart of ``raft_tpu.sparse``): COO/CSR containers,
conversions, sparse linear algebra (spmm, spmv, sddmm, degree, norms,
symmetrize, transpose, Laplacian), element and row operations, the
per-row top-k, sparse pairwise distances and kNN (``distance``), the
cross-component 1-NN (``neighbors``), Borůvka's MST (``mst``), the Lanczos
solvers (``solver``) and spectral partitioning (``spectral``)."""

from raft_tpu_torch.sparse import (convert, distance, linalg, mst, neighbors,
                                   op, selection, solver, spectral, types)
from raft_tpu_torch.sparse.types import (COO, CSR, coo_from_arrays,
                                         csr_from_scipy_like)

__all__ = ["convert", "distance", "linalg", "mst", "neighbors", "op",
           "selection", "solver", "spectral", "types",
           "COO", "CSR", "coo_from_arrays", "csr_from_scipy_like"]
