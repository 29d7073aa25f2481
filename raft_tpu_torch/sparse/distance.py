"""Pairwise distances between sparse (CSR) row sets, and their kNN
(counterpart of ``raft_tpu.sparse.distance``; RAFT's
sparse/distance/distance.cuh, whose metric set this keeps).

The dataset side ``y`` is densified once; ``x`` streams through in row
tiles sized by the workspace budget, each tile densified by
``sparse.convert.densify`` (duplicate coordinates summed in entry order, no
float atomics on the card) and handed to the dense engine
(``ops.distance.pairwise_core``). Jaccard and Dice, the two sparse-only
metrics, come from one fp32 product of the binarised rows
(``ops.distance.dot_fp32``, which refuses TF32 on the card). ``knn`` is
that matrix and ``ops.select_k`` on the ``select_k`` kernel's route
(``SelectAlgo.PALLAS``, as the port's tiled brute force takes it for the
metrics no fused kernel serves) up to ``gk.MAX_K``: on the card the kernel
selects over each [n_queries, n_dataset] row, on the CPU its plain version
does. Ties go to the lower column either way, as ``lax.top_k`` puts them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import (Resources, as_tensors,
                                           ensure_resources)
from raft_tpu_torch.ops.distance import (DistanceType, dot_fp32, is_min_close,
                                         pairwise_core, resolve_metric)
from raft_tpu_torch.sparse.convert import csr_to_dense, densify
from raft_tpu_torch.sparse.types import CSR

SUPPORTED = (
    DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
    DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
    DistanceType.InnerProduct, DistanceType.L1, DistanceType.CosineExpanded,
    DistanceType.JaccardExpanded, DistanceType.Canberra, DistanceType.Linf,
    DistanceType.LpUnexpanded, DistanceType.HammingUnexpanded,
    DistanceType.JensenShannon, DistanceType.KLDivergence,
    DistanceType.DiceExpanded,
)


def placed(csr: CSR, device: torch.device) -> CSR:
    """``csr`` with its arrays on ``device`` (host arrays converted)."""
    indptr, indices, data = as_tensors(csr.indptr, csr.indices, csr.data,
                                       device=device)
    return CSR(indptr.to(torch.int32), indices.to(torch.int32), data,
               csr.shape)


def _binary_overlap(xd: torch.Tensor, yd: torch.Tensor):
    """Row-pair overlap counts of the binarised rows by one fp32 product."""
    xb = (xd != 0).to(torch.float32)
    yb = (yd != 0).to(torch.float32)
    return dot_fp32(xb, yb), xb.sum(1), yb.sum(1)


def pairwise_distance(x: CSR, y: CSR, metric="euclidean",
                      metric_arg: float = 2.0,
                      res: Optional[Resources] = None,
                      device=None) -> torch.Tensor:
    """All-pairs distances between CSR row sets [m, d] × [n, d] → [m, n]
    (sparse::distance::pairwise_distance), on ``res``'s device (CUDA unless
    the caller asks for the CPU)."""
    res = ensure_resources(res, device)
    m = resolve_metric(metric)
    if m not in SUPPORTED:
        raise NotImplementedError(
            f"metric {m.name} not in the sparse metric set "
            "(sparse/distance/distance.cuh:38-48)")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"dim mismatch {x.shape} vs {y.shape}")
    x, y = placed(x, res.device), placed(y, res.device)
    yd = csr_to_dense(y)
    n_x, d = x.shape
    tile = int(np.clip(res.workspace_limit_bytes // max(d * 4 * 4, 1), 8,
                       max(n_x, 8)))
    indptr = x.indptr.cpu().numpy()

    def block(lo: int, hi: int) -> torch.Tensor:
        s, e = int(indptr[lo]), int(indptr[hi])
        bounds = torch.as_tensor(indptr[lo + 1:hi] - indptr[lo],
                                 device=res.device)
        rows = torch.searchsorted(bounds, torch.arange(
            e - s, device=res.device), right=True)
        xt = densify(rows, x.indices[s:e], x.data[s:e], (hi - lo, d))
        if m == DistanceType.JaccardExpanded:
            inter, nx, ny = _binary_overlap(xt, yd)
            union = nx[:, None] + ny[None, :] - inter
            return 1.0 - inter / torch.clamp_min(union, 1.0)
        if m == DistanceType.DiceExpanded:
            inter, nx, ny = _binary_overlap(xt, yd)
            return 1.0 - 2.0 * inter / torch.clamp_min(
                nx[:, None] + ny[None, :], 1.0)
        return pairwise_core(xt, yd, m, float(metric_arg),
                             res.workspace_limit_bytes)

    if n_x <= tile:
        return block(0, n_x)
    return torch.cat([block(lo, min(lo + tile, n_x))
                      for lo in range(0, n_x, tile)])


def knn(queries: CSR, dataset: CSR, k: int, metric="euclidean",
        res: Optional[Resources] = None, device=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse brute-force kNN (sparse/neighbors/knn.cuh brute_force_knn over
    CSR inputs): the distance matrix, then ``ops.select_k`` →
    ``(distances [n_q, k], ids [n_q, k] int32)``."""
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops.select_k import SelectAlgo, select_k

    res = ensure_resources(res, device)
    dist = pairwise_distance(queries, dataset, metric, res=res)
    algo = SelectAlgo.PALLAS if k <= gk.MAX_K else SelectAlgo.AUTO
    return select_k(dist, k, select_min=is_min_close(metric), algo=algo)
