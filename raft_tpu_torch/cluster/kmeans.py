"""Lloyd k-means with k-means++ init.

Counterpart of ``raft_tpu.cluster.kmeans`` (the reference's
``raft::cluster::kmeans``): k-means++ or random init, then Lloyd iterations
of a fused-L2 1-NN assignment (``ops.fused_l2_nn.fused_l2_nn_core``, the
hand-written ``fused_l2_argmin`` kernel on the card) and a scatter-add
centroid update, stopping when the squared centre shift falls below ``tol``.

In PyTorch the JAX package's ``lax.while_loop`` is a Python loop (its
condition reads the shift on the host once per iteration) and ``fori_loop``
is a loop. The scatter-add ``.at[].add`` becomes a stable sort by label and
a segment sum, which adds each cluster's rows in row order on the CPU and
on the card alike: an atomic scatter-add on the card would add them in a
new order every run, so the shift would never reach 0 once the labels
settle. Random draws (the k-means++ samples, the random init's permutation)
come from the resources' ``torch.Generator``, so they differ from
``jax.random``'s: seed them with ``Resources(seed=...)``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import (DistanceType, resolve_metric,
                                         row_norms_sq)
from raft_tpu_torch.ops.fused_l2_nn import (choose_tile_rows,
                                            fused_l2_nn_argmin,
                                            fused_l2_nn_core)
from raft_tpu_torch.utils.shape import as_query_array


class InitMethod(enum.Enum):
    KMeansPlusPlus = "k-means++"
    Random = "random"
    Array = "array"  # user-provided centroids


@dataclasses.dataclass
class KMeansParams:
    """The reference's ``KMeansParams``. ``seed`` is kept for its signature;
    the port draws from the resources' generator."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: InitMethod = InitMethod.KMeansPlusPlus
    n_init: int = 1
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if isinstance(self.init, str):
            self.init = InitMethod(self.init)


def _assign(x, x_norms, centers, tile: Optional[int] = None):
    """E-step: (labels [m] int32, clamped distance² [m]) by the fused 1-NN,
    shared by fit, update_centroids and the Lloyd loop."""
    d2, labels = fused_l2_nn_core(x, centers, x_norms, row_norms_sq(centers),
                                  False, tile)
    return labels, d2


assign = _assign


def _update(x, labels, old_centers, weights=None):
    """M-step: weighted means of the assigned rows; an empty cluster keeps
    its previous centre. Returns (centers, weight per cluster). The rows
    are summed per cluster in row order (a stable sort by label, then a
    segment sum), so the result is the same on every run."""
    n_clusters = old_centers.shape[0]
    lab = labels.to(torch.int64)
    order = torch.argsort(lab, stable=True)
    lengths = torch.bincount(lab, minlength=n_clusters)
    # x·1 is x exactly, so the unweighted sum skips the product
    xw = x if weights is None else x * weights[:, None]
    sums = torch.segment_reduce(xw[order], "sum", lengths=lengths)
    counts = (lengths.to(torch.float32) if weights is None else
              torch.segment_reduce(weights[order], "sum", lengths=lengths))
    centers = torch.where((counts > 0)[:, None],
                          sums / torch.clamp_min(counts, 1e-20)[:, None],
                          old_centers)
    return centers, counts


def _weighted_draw(generator: torch.Generator, w):
    """One index [1] drawn with probability ∝ w (w >= 0, not all 0), by the
    inverse of the float64 cumulative sum; unlike ``torch.multinomial`` it
    takes any number of rows (that one refuses more than 2^24)."""
    cdf = torch.cumsum(w.to(torch.float64), 0)
    u = torch.rand(1, dtype=torch.float64, generator=generator,
                   device=w.device) * cdf[-1]
    # u < total, so a row with cdf > u exists; the min keeps u rounded up
    # to the total on the last row of positive weight
    return torch.minimum(torch.searchsorted(cdf, u, right=True),
                         torch.searchsorted(cdf, cdf[-1:]))


def _kmeans_pp_init(generator: torch.Generator, x, n_clusters: int):
    """k-means++ (the reference's ``initKMeansPlusPlus``): a uniform first
    row, then each next centre drawn with probability ∝ its squared distance
    to the nearest centre so far; uniform when every distance is 0
    (duplicate points)."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centers = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    centers[0] = x[first[0]]
    min_d = row_norms_sq(x - x[first])
    for i in range(1, n_clusters):
        w = torch.where(min_d > 0, min_d, 0.0)
        w = torch.where((min_d <= 0).all(), torch.ones_like(w), w)
        nxt = _weighted_draw(generator, w)
        c = x[nxt]  # [1, dim]
        centers[i] = c[0]
        min_d = torch.minimum(min_d, row_norms_sq(x - c))
    return centers


def _lloyd(x, x_norms, centers, weights, tol: float, max_iter: int,
           tile: int):
    """Lloyd iterations while ``i < max_iter`` and the squared centre shift
    (float32, as JAX compares it) is >= ``tol``; then the final assignment.
    Returns (centers, labels, inertia, n_iter)."""
    i, shift2 = 0, np.float32(np.inf)
    while i < max_iter and shift2 >= np.float32(tol):
        labels, _ = _assign(x, x_norms, centers, tile)
        new_centers, _ = _update(x, labels, centers, weights)
        shift2 = np.float32(((new_centers - centers) ** 2).sum().item())
        centers = new_centers
        i += 1
    labels, d2 = _assign(x, x_norms, centers, tile)
    inertia = (d2 * weights).sum() if weights is not None else d2.sum()
    return centers, labels, inertia, i


def fit(x, params: Optional[KMeansParams] = None, init_centers=None,
        sample_weights=None, res: Optional[Resources] = None, device=None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """K-means fit → ``(centers [k, dim], labels [n] int32, inertia (0-d),
    n_iter)``. ``n_init`` restarts keep the lowest-inertia solution. Runs on
    CUDA unless ``device="cpu"`` (or ``res``) says otherwise."""
    params = params or KMeansParams()
    res = ensure_resources(res, device)
    if params.metric not in (DistanceType.L2Expanded,
                             DistanceType.L2SqrtExpanded):
        raise NotImplementedError(
            "kmeans supports L2 metrics (like the reference)")
    if params.init == InitMethod.Array and init_centers is None:
        raise ValueError("init='array' requires init_centers")
    if init_centers is not None and params.init != InitMethod.Array:
        raise ValueError(
            f"init_centers given but init={params.init.value!r}; use "
            "init='array'")
    x = as_query_array(x, res.device, torch.float32)
    if params.n_clusters > x.shape[0]:
        raise ValueError(
            f"n_clusters={params.n_clusters} > n_rows={x.shape[0]}")
    xn = row_norms_sq(x)
    weights = (None if sample_weights is None else torch.as_tensor(
        sample_weights, dtype=torch.float32, device=res.device))
    tile = choose_tile_rows(x.shape[0], params.n_clusters,
                            res.workspace_limit_bytes)
    gen = res.generator
    # array init is deterministic: extra restarts would be identical
    n_init = 1 if params.init == InitMethod.Array else max(params.n_init, 1)
    best = None
    for _ in range(n_init):
        if params.init == InitMethod.Array:
            c0 = as_query_array(init_centers, res.device, torch.float32)
        elif params.init == InitMethod.Random:
            pick = torch.randperm(x.shape[0], generator=gen,
                                  device=res.device)[:params.n_clusters]
            c0 = x[pick]
        else:
            c0 = _kmeans_pp_init(gen, x, params.n_clusters)
        out = _lloyd(x, xn, c0, weights, params.tol, params.max_iter, tile)
        if best is None or float(out[2]) < float(best[2]):
            best = out
    return best


def predict(centers, x, res: Optional[Resources] = None, device=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centre labels [n] int32 and the inertia (0-d), by the fused
    1-NN (the reference's ``kmeans::predict``)."""
    d2, labels = fused_l2_nn_argmin(x, centers, res=res, device=device)
    return labels, d2.sum()


def fit_predict(x, params: Optional[KMeansParams] = None,
                res: Optional[Resources] = None, device=None):
    centers, labels, _, _ = fit(x, params, res=res, device=device)
    return centers, labels


def cluster_cost(x, centers, res: Optional[Resources] = None, device=None
                 ) -> torch.Tensor:
    """Sum of squared distances to the nearest centre (the reference's
    ``kmeans::cluster_cost``)."""
    d2, _ = fused_l2_nn_argmin(x, centers, res=res, device=device)
    return d2.sum()


def update_centroids(x, centroids, sample_weights=None,
                     res: Optional[Resources] = None, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One weighted M-step: assign the rows to their nearest centroid, then
    ``(new centroids, weight per cluster)``; an empty cluster keeps its
    centroid (``pylibraft.cluster.kmeans.compute_new_centroids``)."""
    res = ensure_resources(res, device)
    x = as_query_array(x, res.device, torch.float32)
    centroids = as_query_array(centroids, res.device, torch.float32)
    w = (None if sample_weights is None else torch.as_tensor(
        sample_weights, dtype=torch.float32, device=res.device))
    tile = choose_tile_rows(x.shape[0], centroids.shape[0],
                            res.workspace_limit_bytes)
    labels, _ = _assign(x, row_norms_sq(x), centroids, tile)
    return _update(x, labels, centroids, w)


compute_new_centroids = update_centroids  # pylibraft name


def find_k(x, k_max: int, k_min: int = 2,
           params: Optional[KMeansParams] = None,
           res: Optional[Resources] = None, device=None) -> int:
    """Elbow search over k in [k_min, k_max]: fit each, pick the k with the
    largest second difference of the inertia (the knee); with fewer than
    three candidates, the lowest inertia."""
    params = params or KMeansParams()
    res = ensure_resources(res, device)
    ks = list(range(k_min, k_max + 1))
    costs = [float(fit(x, dataclasses.replace(params, n_clusters=k),
                       res=res)[2]) for k in ks]
    if len(costs) < 3:
        return ks[int(np.argmin(costs))]
    return ks[int(np.diff(costs, 2).argmax()) + 1]
