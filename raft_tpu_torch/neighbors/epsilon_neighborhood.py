"""Epsilon neighbourhood: all pairs within a radius (counterpart of
``raft_tpu.neighbors.epsilon_neighborhood``; RAFT's
neighbors/epsilon_neighborhood.cuh epsUnexpL2SqNeighborhood: a dense
boolean adjacency and the vertex degrees, the input of DBSCAN).

One pass of ``ops.pairwise_distance`` and a threshold."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import pairwise_distance


@tracing.range("epsilon_neighborhood.eps_neighbors")
def eps_neighbors(
    x,
    y,
    eps: float,
    metric="sqeuclidean",
    res: Optional[Resources] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean adjacency [m, n] (the rows of x against the rows of y within
    ``eps``) and the vertex degrees [m] int32, on ``res``'s device (CUDA
    unless the caller asks for the CPU). Under the default metric ``eps``
    bounds the squared L2 distance, as RAFT's UnexpL2Sq does."""
    res = ensure_resources(res, device)
    d = pairwise_distance(x, y, metric=metric, res=res)
    adj = d <= eps
    return adj, torch.sum(adj, dim=1).to(torch.int32)
