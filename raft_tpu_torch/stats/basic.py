"""Summary statistics and model metrics (counterpart of
``raft_tpu.stats.basic``; RAFT's stats/mean.cuh, stddev.cuh, cov.cuh,
histogram.cuh, minmax.cuh, accuracy.cuh, r2_score.cuh,
regression_metrics.cuh, trustworthiness_score.cuh, ...).

Each runs where its tensors are (host arrays go to the card unless the
caller passes CPU tensors); ``trustworthiness_score`` runs on ``res``'s
device. The histogram counts by an integer ``index_add_``, exact in any
order and with no read back to the host.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from raft_tpu_torch.core.resources import as_tensors, ensure_resources


def _f32(x) -> torch.Tensor:
    return as_tensors(x)[0].to(torch.float32)


def _floating(x: torch.Tensor) -> torch.Tensor:
    """x, or x in fp32 when it is an integer tensor (``jnp.mean``'s
    promotion)."""
    return x if x.dtype.is_floating_point else x.to(torch.float32)


def mean(x, axis=0):
    return torch.mean(_f32(x), dim=axis)


def var(x, axis=0, sample: bool = False):
    return torch.var(_f32(x), dim=axis, correction=1 if sample else 0)


def stddev(x, axis=0, sample: bool = False):
    return torch.std(_f32(x), dim=axis, correction=1 if sample else 0)


def cov(x, sample: bool = True):
    """Column covariance [d, d] of x [n, d] (stats/cov.cuh)."""
    xf = _f32(x)
    xc = xf - torch.mean(xf, dim=0, keepdim=True)
    denom = xf.shape[0] - 1 if sample else xf.shape[0]
    return (xc.T @ xc) / denom


def histogram(x, n_bins: int, lo=None, hi=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width histogram of all of x's values (stats/histogram.cuh):
    (counts [n_bins] int32, edges [n_bins + 1]). Values below ``lo`` fall
    in the first bin, values above ``hi`` in the last."""
    xf = _f32(x).reshape(-1)
    lo = torch.min(xf) if lo is None else torch.as_tensor(
        lo, dtype=torch.float32, device=xf.device)
    hi = torch.max(xf) if hi is None else torch.as_tensor(
        hi, dtype=torch.float32, device=xf.device)
    steps = torch.arange(n_bins + 1, dtype=torch.float32, device=xf.device)
    edges = lo + steps * ((hi - lo) / n_bins)
    edges[-1] = hi
    width = torch.clamp_min((hi - lo) / n_bins, 1e-38)
    idx = torch.clamp(((xf - lo) / width).to(torch.int32), 0, n_bins - 1)
    counts = torch.zeros((n_bins,), dtype=torch.int32, device=xf.device)
    counts.index_add_(0, idx.to(torch.int64),
                      torch.ones_like(idx, dtype=torch.int32))
    return counts, edges


def minmax(x, axis=0):
    x, = as_tensors(x)
    return torch.amin(x, dim=axis), torch.amax(x, dim=axis)


def accuracy_score(predictions, labels):
    p, l = as_tensors(predictions, labels)
    return torch.mean((p == l).to(torch.float32))


def r2_score(y_true, y_pred):
    yt, yp = _f32(y_true), _f32(y_pred)
    ss_res = torch.sum((yt - yp) ** 2)
    ss_tot = torch.sum((yt - torch.mean(yt)) ** 2)
    return 1.0 - ss_res / torch.clamp_min(ss_tot, 1e-38)


def mean_squared_error(y_true, y_pred):
    yt, yp = _f32(y_true), _f32(y_pred)
    return torch.mean((yt - yp) ** 2)


def dispersion(centroids, cluster_sizes, global_centroid=None):
    """Between-cluster dispersion Σ_c size_c·||centroid_c − μ||²
    (stats/dispersion.cuh, the k-means auto-find-k criterion)."""
    c = _f32(centroids)
    s = as_tensors(cluster_sizes, device=c.device)[0].to(torch.float32)
    if global_centroid is None:
        global_centroid = torch.sum(c * s[:, None], 0) / torch.clamp_min(
            torch.sum(s), 1e-38)
    else:
        global_centroid = as_tensors(global_centroid, device=c.device)[0]
    d2 = torch.sum((c - global_centroid[None, :]) ** 2, -1)
    return torch.sum(d2 * s)


def trustworthiness_score(x, x_embedded, n_neighbors: int = 5,
                          metric="sqeuclidean", res=None, device=None):
    """Trustworthiness of a low-dimensional embedding
    (stats/trustworthiness_score.cuh): 1 − the penalty of the points that
    enter a point's embedded k-neighbourhood from far in the original
    space. Runs on ``res``'s device (CUDA unless the caller asks for the
    CPU); the embedded kNN goes through ``brute_force.knn``."""
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops.distance import pairwise_distance

    res = ensure_resources(res, device)
    x, x_embedded = as_tensors(x, x_embedded, device=res.device)
    n = x.shape[0]
    k = int(n_neighbors)
    if k >= n / 2:
        raise ValueError(
            f"n_neighbors={k} must be < n_samples/2 = {n / 2} (the "
            "normalizer changes sign beyond that; sklearn's contract)")
    # ranks in the original space: a full stable argsort of each row (an
    # offline metric over an evaluation subsample)
    d_orig = pairwise_distance(x, x, metric=metric, res=res)
    rank_order = torch.argsort(d_orig, dim=1, stable=True)
    ranks = torch.zeros((n, n), dtype=torch.int32, device=x.device)
    ranks.scatter_(1, rank_order, torch.arange(
        n, dtype=torch.int32, device=x.device)[None, :].expand(n, n))
    _, emb_nn = brute_force.knn(x_embedded, x_embedded, k=k + 1,
                                metric=metric, res=res)
    emb_nn = emb_nn[:, 1:].to(torch.int64)  # drop self
    r = torch.gather(ranks, 1, emb_nn)  # original-space ranks
    penalty = torch.sum(torch.clamp_min(r - k, 0).to(torch.float32))
    norm = 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))
    return 1.0 - norm * penalty


def sum(x, axis=0):  # noqa: A001 — RAFT's name
    """Column or row sums (stats/sum.cuh)."""
    x, = as_tensors(x)
    return torch.sum(x, dim=axis)


def mean_center(x, axis=0):
    """(x minus its mean along ``axis``, the means) (stats/mean_center.cuh)."""
    x = _floating(as_tensors(x)[0])
    mu = torch.mean(x, dim=axis, keepdim=True)
    return x - mu, torch.squeeze(mu, dim=axis)


def meanvar(x, axis=0, sample: bool = False):
    """Mean and variance together (stats/meanvar.cuh)."""
    x = _floating(as_tensors(x)[0])
    return (torch.mean(x, dim=axis),
            torch.var(x, dim=axis, correction=1 if sample else 0))


def kl_divergence(p, q):
    """Σ p·log(p/q) over all elements (stats/kl_divergence.cuh); terms with
    p == 0 contribute 0."""
    p = _f32(p)
    q = as_tensors(q, device=p.device)[0].to(torch.float32)
    t = torch.where(p > 0, p * (torch.log(torch.clamp_min(p, 1e-38))
                                - torch.log(torch.clamp_min(q, 1e-38))),
                    0.0)
    return torch.sum(t)


def _median(v: torch.Tensor) -> torch.Tensor:
    """The median of all of v's values, the mean of the two middle ones for
    an even count (``jnp.median``; ``torch.median`` takes the lower)."""
    s = torch.sort(v.reshape(-1)).values
    m = s.shape[0] // 2
    return s[m] if s.shape[0] % 2 else s[m - 1] + 0.5 * (s[m] - s[m - 1])


def regression_metrics(y_true, y_pred):
    """(mean absolute error, mean squared error, median absolute error)
    (stats/regression_metrics.cuh)."""
    y_true, y_pred = _f32(y_true), _f32(y_pred)
    err = y_pred - y_true
    return (torch.mean(torch.abs(err)), torch.mean(err * err),
            _median(torch.abs(err)))


def information_criterion_batched(log_likelihood, n_params: int,
                                  n_samples: int, criterion: str = "aic"):
    """AIC, AICc or BIC of per-series log-likelihoods
    (stats/information_criterion.cuh compute_batched_ics)."""
    ll = _f32(log_likelihood)
    k = float(n_params)
    n = float(n_samples)
    base = -2.0 * ll
    if criterion == "aic":
        return base + 2.0 * k
    if criterion == "aicc":
        return base + 2.0 * k + 2.0 * k * (k + 1.0) / max(n - k - 1.0, 1e-6)
    if criterion == "bic":
        return base + k * math.log(max(n, 1.0))
    raise ValueError(f"unknown criterion: {criterion}")
