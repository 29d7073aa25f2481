"""The legacy ``spatial.knn`` namespace, forwarding to ``neighbors`` and
``distance`` (counterpart of ``raft_tpu.spatial``; RAFT's
spatial/knn/*.cuh, the pre-``neighbors`` API). ``knn_search`` keeps the
legacy argument order, the dataset before the queries."""

from __future__ import annotations

from types import SimpleNamespace

from raft_tpu_torch.neighbors import (ball_cover, brute_force,
                                      epsilon_neighborhood, ivf_flat, ivf_pq)
from raft_tpu_torch.neighbors.brute_force import knn as brute_force_knn
from raft_tpu_torch.ops.distance import pairwise_distance


def knn_search(dataset, queries, k: int, metric="euclidean", **kwargs):
    """spatial/knn/knn.cuh's brute_force_knn: ``brute_force.knn(queries,
    dataset, k, ...)``."""
    return brute_force_knn(queries, dataset, k, metric=metric, **kwargs)


def haversine_distance(x, y, **kwargs):
    """Pairwise haversine over [n, 2] (latitude, longitude) radians
    (spatial/knn/detail/haversine_distance.cuh)."""
    return pairwise_distance(x, y, metric="haversine", **kwargs)


knn = SimpleNamespace(
    knn=knn_search,
    brute_force=brute_force,
    ball_cover=ball_cover,
    epsilon_neighborhood=epsilon_neighborhood,
    ivf_flat=ivf_flat,
    ivf_pq=ivf_pq,
    haversine_distance=haversine_distance,
)

__all__ = ["knn", "knn_search", "haversine_distance"]
