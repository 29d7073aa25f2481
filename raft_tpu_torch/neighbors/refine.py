"""Refine — exact re-ranking of ANN candidate lists.

Counterpart of ``raft_tpu.neighbors.refine``: given candidate row ids per
query (typically ``k·refine_ratio`` of them from ivf_pq), gather the
candidates' rows, recompute exact distances, mask missing (-1) candidates
and keep the top k. Query tiles are sized from the workspace budget.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import (DistanceType, gathered_distances,
                                         resolve_metric)
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.utils.shape import as_query_array


@tracing.range("refine.refine")
def refine(dataset, queries, candidates, k: int, metric="sqeuclidean",
           res: Optional[Resources] = None,
           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank ``candidates`` [nq, n_cand] (row ids into ``dataset``, -1 =
    missing) by exact distance → the top ``k`` ``(distances, ids)``, ids -1
    where fewer than k candidates are valid. Runs on CUDA unless
    ``device="cpu"`` (or ``res``) says otherwise."""
    res = ensure_resources(res, device)
    dataset = as_query_array(dataset, res.device)
    queries = as_query_array(queries, res.device)
    candidates = as_query_array(candidates, res.device, torch.int64)
    if queries.shape[1] != dataset.shape[1]:
        raise ValueError(
            f"query dim {queries.shape[1]} != dataset dim {dataset.shape[1]}")
    if candidates.shape[0] != queries.shape[0]:
        raise ValueError("candidates rows must match queries rows")
    n_cand = candidates.shape[1]
    if k > n_cand:
        raise ValueError(f"k={k} > n_candidates={n_cand}")
    metric = resolve_metric(metric)
    minimize = metric != DistanceType.InnerProduct
    bad = torch.inf if minimize else -torch.inf
    per_q = n_cand * dataset.shape[1] * 4 * 2
    q_tile = int(np.clip(res.workspace_limit_bytes // max(per_q, 1), 1, 1024))
    if q_tile >= 8:
        q_tile -= q_tile % 8
    out_v, out_i = [], []
    for s in range(0, queries.shape[0], q_tile):
        ct = candidates[s:s + q_tile]
        valid = ct >= 0
        vecs = dataset[ct.clamp_min(0)]  # [t, C, dim]
        d = torch.where(valid, gathered_distances(queries[s:s + q_tile], vecs,
                                                  metric), bad)
        v, sel = select_k(d, int(k), select_min=minimize)
        i_out = torch.gather(ct, 1, sel.long())
        finite = torch.isfinite(v) if minimize else v > -torch.inf
        out_v.append(v)
        out_i.append(torch.where(finite, i_out, -1).to(torch.int32))
    if not out_v:
        return (torch.empty((0, k), dtype=torch.float32, device=res.device),
                torch.empty((0, k), dtype=torch.int32, device=res.device))
    return torch.cat(out_v), torch.cat(out_i)
