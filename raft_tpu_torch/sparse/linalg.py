"""Sparse linear algebra (counterpart of ``raft_tpu.sparse.linalg``): spmm,
spmv, sddmm, degree, row norms, transpose, symmetrize and the Laplacian
(RAFT's sparse/linalg/spmm.hpp, sddmm.hpp, degree.cuh, norm.cuh,
symmetrize.cuh, transpose.cuh; spectral/matrix_wrappers.hpp).

SpMM with a dense right-hand side is a gather and a sum by row: each stored
entry contributes data·dense[col] to its row. A CSR's entries are already
grouped by row, so the rows' sums are ``torch.segment_reduce`` over the
entries in order, the same bits on every run (no float atomics on the
card). ``spmm`` cuts the [nnz, d] contributions into pieces of at most
``PIECE_BYTES`` (1 GiB), each piece summed by row and the pieces added in
order. ``symmetrize`` sorts the doubled edge list by (row, col) with the
JAX package's two stable argsorts and sums each coordinate's run in
order. Max reductions are scatters (``scatter_reduce_`` with
``amax``), exact in any order.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.sparse.convert import (coo_to_csr, csr_to_coo,
                                           csr_to_dense, run_ids, run_sums)
from raft_tpu_torch.sparse.types import COO, CSR

#: the bytes of one piece of spmm's [nnz, d] contributions
PIECE_BYTES = 1 << 30


def _sum_by_row(values: torch.Tensor, rows: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """Row sums [n_rows, ...] of ``values`` whose ``rows`` (int64) are
    non-decreasing, each row's entries added in order."""
    lengths = torch.zeros((n_rows,), dtype=torch.int64,
                          device=rows.device).index_add_(
                              0, rows, torch.ones_like(rows))
    if not values.dtype.is_floating_point:
        return values.new_zeros((n_rows,) + tuple(values.shape[1:])
                                ).index_add_(0, rows, values)
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0)


def spmm(csr: CSR, dense, alpha: float = 1.0) -> torch.Tensor:
    """CSR [n, m] @ dense [m, d] → [n, d] (sparse/linalg/spmm.hpp)."""
    dense, = as_tensors(dense, device=csr.data.device)
    rows = csr.row_ids().to(torch.int64)
    cols = csr.indices.to(torch.int64)
    d = dense.shape[1]
    step = max(1, PIECE_BYTES // max(d * dense.element_size(), 1))
    out = None
    for e0 in range(0, csr.nnz, step):
        contrib = csr.data[e0:e0 + step, None] * dense[cols[e0:e0 + step]]
        part = _sum_by_row(contrib, rows[e0:e0 + step], csr.n_rows)
        out = part if out is None else out + part
    if out is None:
        out = torch.zeros((csr.n_rows, d), dtype=torch.promote_types(
            csr.data.dtype, dense.dtype), device=dense.device)
    return alpha * out


def spmv(csr: CSR, vec) -> torch.Tensor:
    """CSR @ vector."""
    vec, = as_tensors(vec, device=csr.data.device)
    contrib = csr.data * vec[csr.indices.to(torch.int64)]
    return _sum_by_row(contrib, csr.row_ids().to(torch.int64), csr.n_rows)


def sddmm(a, b, structure: CSR, alpha: float = 1.0) -> CSR:
    """Sampled dense-dense product (sparse/linalg/sddmm.hpp): the values of
    A·Bᵀ at the stored positions of ``structure``, summed in fp32."""
    a, b = as_tensors(a, b, device=structure.data.device)
    rows = structure.row_ids().to(torch.int64)
    vals = (a[rows].to(torch.float32)
            * b[structure.indices.to(torch.int64)].to(torch.float32)).sum(-1)
    return CSR(structure.indptr, structure.indices,
               alpha * vals.to(a.dtype), structure.shape)


def degree(csr: CSR) -> torch.Tensor:
    """Stored entries per row (sparse/linalg/degree.cuh)."""
    return torch.diff(csr.indptr)


def row_norm(csr: CSR, ord: str = "l2") -> torch.Tensor:
    """Per-row norms over the stored values (sparse/linalg/norm.cuh):
    'l1', 'l2' (squared, as in the JAX package) or 'linf'."""
    rows = csr.row_ids().to(torch.int64)
    if ord == "l1":
        return _sum_by_row(torch.abs(csr.data), rows, csr.n_rows)
    if ord == "l2":
        return _sum_by_row(csr.data * csr.data, rows, csr.n_rows)
    if ord == "linf":
        v = torch.abs(csr.data)
        return v.new_zeros((csr.n_rows,)).scatter_reduce_(0, rows, v, "amax")
    raise ValueError(f"unknown norm {ord!r}")


def row_normalize(csr: CSR, ord: str = "l1") -> CSR:
    """Rows scaled to unit norm (sparse/linalg/norm.cuh rowNormalize)."""
    n = row_norm(csr, ord)
    if ord == "l2":
        n = torch.sqrt(n)
    scale = 1.0 / torch.clamp_min(n, 1e-20)
    return CSR(csr.indptr, csr.indices,
               csr.data * scale[csr.row_ids().to(torch.int64)], csr.shape)


def transpose(csr: CSR) -> CSR:
    """sparse/linalg/transpose.cuh: roles swapped, entries re-sorted."""
    coo = csr_to_coo(csr)
    t = COO(coo.cols, coo.rows, coo.data, (csr.shape[1], csr.shape[0]))
    return coo_to_csr(t)


def symmetrize(coo: COO, op: str = "max") -> COO:
    """A combined with Aᵀ (sparse/linalg/symmetrize.cuh): the entries of
    each coordinate of the doubled edge list reduced by ``op`` ('max' |
    'sum' | 'mean'). The output keeps the doubled nnz, in (row, col) order,
    one entry a coordinate and zero-data entries at (0, 0) where
    duplicates collapsed, as in the JAX package."""
    both_r = torch.cat([coo.rows, coo.cols])
    both_c = torch.cat([coo.cols, coo.rows])
    both_d = torch.cat([coo.data, coo.data])
    o1 = torch.argsort(both_c, stable=True)
    o2 = torch.argsort(both_r[o1], stable=True)
    order = o1[o2]
    r_s, c_s, d_s = both_r[order], both_c[order], both_d[order]
    first = torch.ones_like(r_s, dtype=torch.bool)
    first[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
    seg, lengths = run_ids(first)
    if op == "sum":
        vals = run_sums(d_s, seg, lengths)
    elif op == "max":
        low = (-torch.inf if d_s.dtype.is_floating_point
               else torch.iinfo(d_s.dtype).min)
        vals = torch.full_like(d_s, low).scatter_reduce_(0, seg, d_s, "amax")
    elif op == "mean":
        vals = (run_sums(d_s, seg, lengths)
                / torch.clamp_min(lengths.to(torch.float32), 1.0))
    else:
        raise ValueError(f"unknown symmetrize op {op!r}")
    zero = torch.zeros((), dtype=coo.data.dtype, device=d_s.device)
    d_out = torch.where(first, vals[seg].to(coo.data.dtype), zero)
    r_out = torch.where(first, r_s, 0)
    c_out = torch.where(first, c_s, 0)
    return COO(r_out, c_out, d_out, coo.shape)


def laplacian(adj: CSR, normalized: bool = False) -> torch.Tensor:
    """The dense [n, n] graph Laplacian of a sparse adjacency, made
    symmetric by max(A, Aᵀ) (spectral/matrix_wrappers.hpp
    laplacian_matrix_t): D − A, or I − D^-1/2 A D^-1/2."""
    a = csr_to_dense(adj)
    a = torch.maximum(a, a.T)
    d = torch.sum(a, dim=1)
    if not normalized:
        return torch.diag(d) - a
    inv_sqrt = 1.0 / torch.sqrt(torch.clamp_min(d, 1e-20))
    eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    return eye - inv_sqrt[:, None] * a * inv_sqrt[None, :]
