"""Single-linkage agglomerative clustering (counterpart of
``raft_tpu.cluster.single_linkage``; RAFT's cluster/single_linkage.cuh).

The connectivity is the kNN graph of the rows (``brute_force.knn``, which
on the card launches ``fused_l2_topk``), column 0 dropped as the row
itself, both directions kept; then Borůvka's MST (``sparse.mst``) on the
device and the dendrogram's labels by a union-find over the MST edges in
weight order on the host (``native.agglomerative_label``), cut at
``n_clusters``. As in the JAX package, column 0 is taken to be the row
itself: a duplicate row may come first instead, which leaves a self-loop
that Borůvka never selects and drops one real neighbour.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.sparse import mst as mst_mod
from raft_tpu_torch.sparse.types import COO
from raft_tpu_torch.utils.shape import as_query_array


@dataclasses.dataclass
class SingleLinkageParams:
    """single_linkage.cuh's parameters: the cluster count, the metric and
    the kNN connectivity degree."""

    n_clusters: int = 2
    metric: DistanceType = DistanceType.L2SqrtExpanded
    connectivity_k: int = 15

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)


def _knn_connectivity(x: torch.Tensor, k: int, metric: DistanceType,
                      res: Resources) -> COO:
    """The symmetrised kNN graph (detail/connectivities.cuh KNN_GRAPH)."""
    from raft_tpu_torch.neighbors import brute_force

    n = x.shape[0]
    d, idx = brute_force.knn(x, x, k=min(k + 1, n), metric=metric, res=res)
    d, idx = d[:, 1:], idx[:, 1:]  # column 0: the row itself
    rows = torch.arange(n, dtype=torch.int32, device=x.device
                        ).repeat_interleave(idx.shape[1])
    cols = idx.reshape(-1).to(torch.int32)
    data = d.reshape(-1).to(torch.float32)
    # both directions, so that Borůvka sees every edge from each end
    return COO(torch.cat([rows, cols]), torch.cat([cols, rows]),
               torch.cat([data, data]), (n, n))


def _label_dendrogram(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                      n: int, n_clusters: int) -> np.ndarray:
    """Union-find over the MST edges by weight (stable), merging until
    ``n_clusters`` components remain or the forest runs out
    (detail/agglomerative.cuh)."""
    from raft_tpu_torch import native

    order = np.argsort(w, kind="stable")
    keep = np.isfinite(w[order]) & (src[order] >= 0)
    order = order[keep]
    return native.agglomerative_label(src[order], dst[order], n, n_clusters)


def single_linkage(x, params: Optional[SingleLinkageParams] = None,
                   res: Optional[Resources] = None, device=None
                   ) -> np.ndarray:
    """Cluster the rows of ``x`` into ``n_clusters`` by single linkage
    (cluster::single_linkage) → labels [n] (numpy int32), on ``res``'s
    device (CUDA unless the caller asks for the CPU)."""
    params = params or SingleLinkageParams()
    res = ensure_resources(res, device)
    x = as_query_array(x, res.device)
    n = x.shape[0]
    if params.n_clusters < 1 or params.n_clusters > n:
        raise ValueError(f"n_clusters={params.n_clusters} out of range")
    graph = _knn_connectivity(x, params.connectivity_k, params.metric, res)
    src, dst, w = mst_mod.mst(graph)
    return _label_dendrogram(src.cpu().numpy(), dst.cpu().numpy(),
                             w.cpu().numpy(), n, params.n_clusters)
