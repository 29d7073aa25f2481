"""Sparse layer (counterpart of ``raft_tpu.sparse``): COO/CSR containers,
conversions, sparse linear algebra (spmm, spmv, sddmm, degree, norms,
symmetrize, transpose, Laplacian), element and row operations and the
per-row top-k. raft_tpu's ``distance``, ``mst``, ``neighbors``, ``solver``
and ``spectral`` are not ported yet (ROADMAP Queue A item 14b)."""

from raft_tpu_torch.sparse import convert, linalg, op, selection, types
from raft_tpu_torch.sparse.types import (COO, CSR, coo_from_arrays,
                                         csr_from_scipy_like)

__all__ = ["convert", "linalg", "op", "selection", "types",
           "COO", "CSR", "coo_from_arrays", "csr_from_scipy_like"]
