"""Per-row top-k over a CSR score matrix (counterpart of
``raft_tpu.sparse.selection``; RAFT's sparse/selection/select_k.cuh).

The rows are densified, absent entries filled with the worst value, and
the port's dense ``ops.select_k`` selects."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.ops.select_k import select_k as dense_select_k
from raft_tpu_torch.sparse.types import CSR


def select_k(csr: CSR, k: int, select_min: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k values and column ids of each CSR row, absent entries ranking
    last. Returns (values [n_rows, k], indices [n_rows, k] int32); a row
    with fewer than k stored entries pads with (+inf or -inf, -1)."""
    n_rows, n_cols = csr.shape
    fill = torch.inf if select_min else -torch.inf
    dense = torch.full((n_rows, n_cols), fill, dtype=csr.data.dtype,
                       device=csr.data.device)
    dense[csr.row_ids().to(torch.int64),
          csr.indices.to(torch.int64)] = csr.data
    kk = min(k, n_cols)
    v, i = dense_select_k(dense, kk, select_min=select_min)
    i = torch.where(torch.isfinite(v), i, -1)
    if kk < k:
        v = torch.cat([v, v.new_full((n_rows, k - kk), fill)], 1)
        i = torch.cat([i, i.new_full((n_rows, k - kk), -1)], 1)
    return v, i
