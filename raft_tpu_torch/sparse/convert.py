"""Sparse format conversions, COO ↔ CSR ↔ dense (counterpart of
``raft_tpu.sparse.convert``; RAFT's sparse/convert/csr.cuh, coo.cuh,
dense.cuh).

COO → CSR needs row-sorted entries (``coo_sort`` sorts them, by two stable
int32 argsorts). Densifying sums duplicate coordinates, as ``.at[].add``
does, but in a fixed order: the entries are sorted by coordinate (stably)
and each coordinate's values are added in entry order by
``torch.segment_reduce``, so the result is the same on every run (no float
atomics on the card). A negative row or column (the ``-1`` padding of
``sparse.op``) counts from the end, as JAX's indexing does; its data is 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.sparse.types import COO, CSR


def run_ids(first: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ids [n] int64 of entries whose runs start where ``first`` is True
    (``first[0]`` True), and the runs' lengths [n] (0 past the last run)."""
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    lengths = torch.zeros_like(seg).index_add_(0, seg, torch.ones_like(seg))
    return seg, lengths


def run_sums(values: torch.Tensor, seg: torch.Tensor,
             lengths: torch.Tensor) -> torch.Tensor:
    """Sums [n, ...] of consecutive runs of ``values`` (``run_ids``), each
    run added in entry order; 0 past the last run. Integer values are
    summed by ``index_add_``, which is exact in any order."""
    if not values.dtype.is_floating_point:
        return torch.zeros_like(values).index_add_(0, seg, values)
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0)


def _wrap(idx: torch.Tensor, size: int) -> torch.Tensor:
    """int64 indices with negative ones counted from the end."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + size, idx)


def densify(rows, cols, data, shape) -> torch.Tensor:
    """Dense [n, m] with each coordinate's values summed in entry order."""
    n, m = int(shape[0]), int(shape[1])
    key = _wrap(rows, n) * m + _wrap(cols, m)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    seg, lengths = run_ids(first)
    sums = run_sums(data[order], seg, lengths)
    out = torch.zeros(n * m, dtype=data.dtype, device=data.device)
    # every entry of a coordinate writes the same sum there
    out[ks] = sums[seg]
    return out.view(n, m)


def coo_sort(coo: COO) -> COO:
    """Entries sorted by (row, col) (sparse/op/sort.cuh): two stable int32
    argsorts, column minor and row major."""
    o1 = torch.argsort(coo.cols, stable=True)
    o2 = torch.argsort(coo.rows[o1], stable=True)
    order = o1[o2]
    return COO(coo.rows[order], coo.cols[order], coo.data[order], coo.shape)


def _indptr(counts: torch.Tensor) -> torch.Tensor:
    return torch.cat([counts.new_zeros((1,)),
                      torch.cumsum(counts, 0)]).to(torch.int32)


def coo_to_csr(coo: COO, assume_sorted: bool = False) -> CSR:
    """Row counts, then their prefix sum (sparse/convert/csr.cuh)."""
    c = coo if assume_sorted else coo_sort(coo)
    n = coo.shape[0]
    rows = _wrap(c.rows, n)
    counts = torch.zeros((n,), dtype=torch.int32, device=rows.device
                         ).index_add_(0, rows, torch.ones_like(
                             rows, dtype=torch.int32))
    return CSR(_indptr(counts), c.cols, c.data, c.shape)


def csr_to_coo(csr: CSR) -> COO:
    """indptr expanded to row ids (sparse/convert/coo.cuh)."""
    return COO(csr.row_ids(), csr.indices, csr.data, csr.shape)


def csr_to_dense(csr: CSR) -> torch.Tensor:
    """Dense [n_rows, n_cols] (sparse/convert/dense.cuh); duplicate
    coordinates sum, so zero-data padding entries are harmless."""
    return densify(csr.row_ids(), csr.indices, csr.data, csr.shape)


def coo_to_dense(coo: COO) -> torch.Tensor:
    return densify(coo.rows, coo.cols, coo.data, coo.shape)


def dense_to_csr(dense, nnz: Optional[int] = None) -> CSR:
    """Dense → CSR of the nonzeros in row-major order, with a static
    ``nnz``: surplus slots become zero entries at (0, 0) that count in no
    row, and nonzeros past ``nnz`` are dropped. Without ``nnz`` it is the
    nonzero count (one read back to the host)."""
    dense, = as_tensors(dense)
    n, m = dense.shape
    mask = dense != 0
    total = int(mask.sum()) if nnz is None else int(nnz)
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)[:total]
    if idx.numel() < total:
        idx = torch.cat([idx, idx.new_full((total - idx.numel(),), -1)])
    is_real = idx >= 0
    safe = torch.clamp_min(idx, 0)
    rows = torch.where(is_real, safe // m, 0).to(torch.int32)
    cols = torch.where(is_real, safe % m, 0).to(torch.int32)
    data = torch.where(is_real, dense.reshape(-1)[safe],
                       torch.zeros((), dtype=dense.dtype,
                                   device=dense.device))
    # padding slots count toward no row's structure
    counts = torch.zeros((n,), dtype=torch.int32, device=dense.device
                         ).index_add_(0, rows.to(torch.int64),
                                      is_real.to(torch.int32))
    return CSR(_indptr(counts), cols, data, (n, m))
