"""Clustering quality metrics (counterpart of
``raft_tpu.stats.cluster_metrics``; RAFT's stats/silhouette_score.cuh,
adjusted_rand_index.cuh, rand_index.cuh, mutual_info_score.cuh,
entropy.cuh, homogeneity_score.cuh, completeness_score.cuh, v_measure.cuh,
contingency_matrix.cuh).

All but the silhouette are computations on a contingency table. Labels are
integers in [0, n_classes). The counts are float32, as the JAX package's
are with ``jax_enable_x64`` off (float64 only with it on): adding 1.0 is
exact in any order below 2^24 counts a cell, so ``index_add_`` gives the
same table on every run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.ops.distance import pairwise_distance


def _labels(a, device=None) -> torch.Tensor:
    return as_tensors(a, device=device)[0].to(torch.int64)


def _contingency(a, b, n_a: int, n_b: int) -> torch.Tensor:
    a = _labels(a)
    b = _labels(b, a.device)
    flat = a * n_b + b
    counts = torch.zeros((n_a * n_b,), dtype=torch.float32, device=a.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    return counts.reshape(n_a, n_b)


def rand_index(a, b, n_classes_a: int, n_classes_b: int):
    c = _contingency(a, b, n_classes_a, n_classes_b)
    n = torch.sum(c)
    sum_all = torch.sum(c * (c - 1)) / 2
    sum_rows = torch.sum(torch.sum(c, 1) * (torch.sum(c, 1) - 1)) / 2
    sum_cols = torch.sum(torch.sum(c, 0) * (torch.sum(c, 0) - 1)) / 2
    total = n * (n - 1) / 2
    return (total + 2 * sum_all - sum_rows - sum_cols) / torch.clamp_min(
        total, 1.0)


def adjusted_rand_index(a, b, n_classes_a: int, n_classes_b: int):
    c = _contingency(a, b, n_classes_a, n_classes_b)
    n = torch.sum(c)
    sum_comb = torch.sum(c * (c - 1)) / 2
    comb_a = torch.sum(torch.sum(c, 1) * (torch.sum(c, 1) - 1)) / 2
    comb_b = torch.sum(torch.sum(c, 0) * (torch.sum(c, 0) - 1)) / 2
    total = n * (n - 1) / 2
    expected = comb_a * comb_b / torch.clamp_min(total, 1.0)
    max_idx = 0.5 * (comb_a + comb_b)
    return (sum_comb - expected) / torch.clamp_min(max_idx - expected, 1e-38)


def entropy(labels, n_classes: int):
    l = _labels(labels)
    counts = torch.zeros((n_classes,), dtype=torch.float32, device=l.device)
    counts.index_add_(0, l, torch.ones_like(l, dtype=torch.float32))
    p = counts / torch.clamp_min(torch.sum(counts), 1.0)
    return -torch.sum(torch.where(
        p > 0, p * torch.log(torch.clamp_min(p, 1e-38)), 0.0))


def mutual_info_score(a, b, n_classes_a: int, n_classes_b: int):
    c = _contingency(a, b, n_classes_a, n_classes_b)
    n = torch.clamp_min(torch.sum(c), 1.0)
    pij = c / n
    pi = torch.sum(pij, dim=1, keepdim=True)
    pj = torch.sum(pij, dim=0, keepdim=True)
    ratio = pij / torch.clamp_min(pi * pj, 1e-38)
    return torch.sum(torch.where(
        pij > 0, pij * torch.log(torch.clamp_min(ratio, 1e-38)), 0.0))


def homogeneity_score(truth, pred, n_classes_t: int, n_classes_p: int):
    mi = mutual_info_score(truth, pred, n_classes_t, n_classes_p)
    h = entropy(truth, n_classes_t)
    return torch.where(h > 0, mi / torch.clamp_min(h, 1e-38), 1.0)


def completeness_score(truth, pred, n_classes_t: int, n_classes_p: int):
    return homogeneity_score(pred, truth, n_classes_p, n_classes_t)


def v_measure(truth, pred, n_classes_t: int, n_classes_p: int,
              beta: float = 1.0):
    h = homogeneity_score(truth, pred, n_classes_t, n_classes_p)
    c = completeness_score(truth, pred, n_classes_t, n_classes_p)
    return (1 + beta) * h * c / torch.clamp_min(beta * h + c, 1e-38)


def silhouette_score(x, labels, n_classes: int, metric="l2_expanded"):
    """Mean silhouette coefficient (stats/silhouette_score.cuh), on x's
    device. The default metric is the JAX package's: the squared L2
    (``l2_expanded``). O(n²) distances, for evaluation-sized inputs."""
    x, = as_tensors(x)
    labels = _labels(labels, x.device)
    d = pairwise_distance(x, x, metric=metric, device=x.device)
    onehot = F.one_hot(labels, n_classes).to(torch.float32)  # [n, c]
    cluster_sizes = torch.sum(onehot, dim=0)  # [c]
    sums = d @ onehot  # each point's summed distance to each cluster
    own_size = cluster_sizes[labels]
    # a: mean distance to the own cluster, self excluded (its distance is 0)
    a = torch.where(own_size > 1,
                    torch.gather(sums, 1, labels[:, None])[:, 0]
                    / torch.clamp_min(own_size - 1, 1), 0.0)
    # b: the smallest mean distance to another, non-empty cluster
    means = sums / torch.clamp_min(cluster_sizes[None, :], 1.0)
    classes = torch.arange(n_classes, device=x.device)
    means = torch.where(classes[None, :] == labels[:, None], torch.inf, means)
    means = torch.where(cluster_sizes[None, :] == 0, torch.inf, means)
    b = torch.amin(means, dim=1)
    s = torch.where(own_size > 1, (b - a) / torch.clamp_min(
        torch.maximum(a, b), 1e-38), 0.0)
    return torch.mean(s)


def contingency_matrix(a, b, n_classes_a: int, n_classes_b: int):
    """The contingency table [n_classes_a, n_classes_b] in float32
    (stats/contingency_matrix.cuh contingencyMatrix): counts[i, j] =
    |{k : a[k] = i ∧ b[k] = j}|."""
    return _contingency(a, b, n_classes_a, n_classes_b)
