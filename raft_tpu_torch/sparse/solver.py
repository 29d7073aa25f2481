"""Sparse eigensolvers over CSR operators (counterpart of
``raft_tpu.sparse.solver``; RAFT's sparse/solver/lanczos.cuh; the MST
solver is :mod:`raft_tpu_torch.sparse.mst`).

The Krylov iteration is ``ops.linalg.lanczos``; sparsity enters only
through its matvec, ``sparse.linalg.spmv`` (each row summed in entry
order). A ``torch.Generator`` takes the place of the JAX package's key:
without one, the start vector comes from a generator seeded with 0 on the
matrix's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.ops import linalg as tlinalg
from raft_tpu_torch.sparse.linalg import spmv
from raft_tpu_torch.sparse.types import CSR


def lanczos_eigsh(a: CSR, k: int, generator: Optional[torch.Generator] = None,
                  ncv: Optional[int] = None, which: str = "smallest"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k extremal eigenpairs of a symmetric CSR matrix by Lanczos →
    ``(eigenvalues [k], eigenvectors [n, k])``."""
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"matrix must be square, got {a.shape}")
    return tlinalg.lanczos(lambda v: spmv(a, v), n, k, generator=generator,
                           ncv=ncv, which=which, device=a.data.device)


def lanczos_smallest(a: CSR, k: int,
                     generator: Optional[torch.Generator] = None,
                     ncv: Optional[int] = None):
    """``lanczos_compute_smallest_eigenvectors``."""
    return lanczos_eigsh(a, k, generator=generator, ncv=ncv, which="smallest")


def lanczos_largest(a: CSR, k: int,
                    generator: Optional[torch.Generator] = None,
                    ncv: Optional[int] = None):
    """``computeLargestEigenvectors`` (linalg/lanczos.cuh)."""
    return lanczos_eigsh(a, k, generator=generator, ncv=ncv, which="largest")
