"""Sparse element and row operations (counterpart of ``raft_tpu.sparse.op``;
RAFT's sparse/op/filter.cuh, reduce.cuh, row_op.cuh, slice.cuh, sort.cuh).

As in the JAX package, "removal" keeps the nnz capacity: the kept entries
are compacted to the front in their order and the rest become padding
(row and column -1, value 0); the filters also return the kept count. The
duplicate reductions sort by the linear coordinate (int64 here, so no
overflow) and keep one entry a coordinate; sums add each coordinate's
entries in order (``torch.segment_reduce``), the same bits on every run.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.sparse.convert import run_ids, run_sums
from raft_tpu_torch.sparse.types import COO, CSR

_PAD_KEY = torch.iinfo(torch.int64).max


def _compact(coo: COO, keep) -> Tuple[COO, torch.Tensor]:
    """Kept entries to the front in their order; returns (coo, kept count
    as a 0-d int32 tensor)."""
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    k = keep[order]
    rows = torch.where(k, coo.rows[order], -1)
    cols = torch.where(k, coo.cols[order], -1)
    data = torch.where(k, coo.data[order],
                       torch.zeros((), dtype=coo.data.dtype,
                                   device=coo.data.device))
    return COO(rows, cols, data, coo.shape), keep.sum().to(torch.int32)


def coo_remove_scalar(coo: COO, scalar) -> Tuple[COO, torch.Tensor]:
    """Drop entries equal to ``scalar`` (op/filter.cuh coo_remove_scalar)."""
    return _compact(coo, coo.data != scalar)


def coo_remove_zeros(coo: COO) -> Tuple[COO, torch.Tensor]:
    """Drop explicit zeros (op/filter.cuh coo_remove_zeros)."""
    return coo_remove_scalar(coo, 0)


def _linear_key(coo: COO) -> torch.Tensor:
    """row·n_cols + col (int64), the padding (row -1) last."""
    lin = coo.rows.to(torch.int64) * coo.shape[1] + coo.cols.to(torch.int64)
    return torch.where(coo.rows >= 0, lin, _PAD_KEY)


def _reduce_duplicates(coo: COO, reduce) -> COO:
    """One entry a coordinate, its value ``reduce(sorted data, run ids,
    run lengths)`` [nnz] by run, compacted to the front in coordinate
    order; padding after."""
    n_cols = coo.shape[1]
    lin = _linear_key(coo)
    order = torch.argsort(lin, stable=True)
    lin_s = lin[order]
    first = torch.ones_like(lin_s, dtype=torch.bool)
    first[1:] = lin_s[1:] != lin_s[:-1]
    seg, lengths = run_ids(first)
    vals = reduce(coo.data[order], seg, lengths)
    rep = first & (lin_s != _PAD_KEY)
    rows = torch.where(rep, lin_s // n_cols, -1).to(torch.int32)
    cols = torch.where(rep, lin_s % n_cols, -1).to(torch.int32)
    data = torch.where(rep, vals[seg],
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    order2 = torch.argsort((~rep).to(torch.int8), stable=True)
    return COO(rows[order2], cols[order2], data[order2], coo.shape)


def coo_sum_duplicates(coo: COO) -> COO:
    """Sum duplicate (row, col) entries, one entry each (op/reduce.cuh's
    coalescing, summing)."""
    return _reduce_duplicates(coo, run_sums)


def coo_max_duplicates(coo: COO) -> COO:
    """Max of duplicate (row, col) entries (op/reduce.cuh max_duplicates)."""

    def run_max(d, seg, _lengths):
        low = (-torch.inf if d.dtype.is_floating_point
               else torch.iinfo(d.dtype).min)
        return torch.full_like(d, low).scatter_reduce_(0, seg, d, "amax")

    return _reduce_duplicates(coo, run_max)


def csr_row_op(csr: CSR, fn) -> CSR:
    """``fn(row_ids, values) -> values`` over the stored entries
    (op/row_op.cuh)."""
    return CSR(csr.indptr, csr.indices, fn(csr.row_ids(), csr.data),
               csr.shape)


def csr_row_slice(csr: CSR, start: int, stop: int) -> CSR:
    """Rows [start, stop) as a new CSR (op/slice.cuh csr_row_slice)."""
    start, stop = int(start), int(stop)
    lo = int(csr.indptr[start])
    hi = int(csr.indptr[stop])
    return CSR(csr.indptr[start:stop + 1] - lo, csr.indices[lo:hi],
               csr.data[lo:hi], (stop - start, csr.shape[1]))


def coo_sort(coo: COO) -> COO:
    """Row-major sort (op/sort.cuh coo_sort); padding (-1 rows) last."""
    order = torch.argsort(_linear_key(coo), stable=True)
    return COO(coo.rows[order], coo.cols[order], coo.data[order], coo.shape)
