"""Sparse matrix containers, CSR and COO (counterpart of
``raft_tpu.sparse.types``).

RAFT's sparse types (core/sparse_types.hpp, device_csr_matrix.hpp,
device_coo_matrix.hpp) as frozen dataclasses of tensors: int32 index
tensors and a data tensor, with a static nnz (the data's length). The port
keeps the JAX package's containers, not ``torch.sparse_csr_tensor``, for
their conventions: a static nnz that may hold padding (``rows = -1`` marks
a removed entry, ``sparse.op``; ``sparse.linalg.symmetrize`` keeps its
doubled nnz with zero-data entries at (0, 0)), which the solvers, the MST
and single linkage rest on.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensors


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate format (core/device_coo_matrix.hpp)."""

    rows: torch.Tensor  # [nnz] int32
    cols: torch.Tensor  # [nnz] int32
    data: torch.Tensor  # [nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row (core/device_csr_matrix.hpp)."""

    indptr: torch.Tensor  # [n_rows + 1] int32
    indices: torch.Tensor  # [nnz] int32 column ids
    data: torch.Tensor  # [nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def row_ids(self) -> torch.Tensor:
        """The row id of every stored entry [nnz] int32 (the row expansion
        of sparse/convert/csr.cuh's csr_to_coo). Entries past
        ``indptr[-1]`` (padding) fall in the last row, as in the JAX
        package."""
        pos = torch.arange(self.nnz, dtype=torch.int32,
                           device=self.indptr.device)
        return torch.searchsorted(self.indptr[1:-1].contiguous(), pos,
                                  right=True).to(torch.int32)


def narrow_data(data):
    """Host float64 and int64 data narrowed to 32 bits, as ``jnp.asarray``
    narrows them with x64 off; tensors as they are."""
    if isinstance(data, torch.Tensor):
        return data
    data = np.asarray(data)
    if data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int64:
        return data.astype(np.int32)
    return data


def csr_from_scipy_like(indptr, indices, data, shape, device=None) -> CSR:
    """A CSR from (indptr, indices, data) arrays, on ``device`` (else that
    of the first tensor given, else CUDA unless the caller asks for the
    CPU)."""
    indptr, indices, data = as_tensors(indptr, indices, narrow_data(data),
                                       device=device)
    return CSR(indptr.to(torch.int32), indices.to(torch.int32), data,
               tuple(int(s) for s in shape))


def coo_from_arrays(rows, cols, data, shape, device=None) -> COO:
    """A COO from (rows, cols, data) arrays, placed as
    :func:`csr_from_scipy_like` places them."""
    rows, cols, data = as_tensors(rows, cols, narrow_data(data), device=device)
    return COO(rows.to(torch.int32), cols.to(torch.int32), data,
               tuple(int(s) for s in shape))
