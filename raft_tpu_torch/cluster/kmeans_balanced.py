"""Balanced hierarchical k-means — the IVF coarse-quantizer trainer.

Counterpart of ``raft_tpu.cluster.kmeans_balanced`` with the same algorithm:
mesoclusters over the trainset, a balanced fine build inside each
mesocluster (padded member sets with row weights, clusters past the
mesocluster's count inactive), a fine-tuning EM over all clusters, then the
balance polish that splits hot clusters into starving ones.

In PyTorch the JAX package's ``lax.while_loop`` is a Python loop (its
condition needs one host read per iteration), ``lax.map`` over mesoclusters
is a loop, and ``.at[].add`` is ``index_add_``. The E-step is a plain fp32
matrix product plus argmin, as the JAX package left it to XLA: no kernel
of this slice runs in the build. Random draws come from the caller's
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.ops.distance import (DistanceType, dot_fp32,
                                         resolve_metric, row_norms_sq)
from raft_tpu_torch.utils.shape import cdiv

_ADJUST_CENTERS_WEIGHT = 7.0
_BUILD_PULLBACK = 2
_BUILD_THRESHOLD = 0.25
_TUNE_PULLBACK = 5
_TUNE_THRESHOLD = 0.2
_DONOR_POOL = 256  # candidate donors sampled per adjust step


@dataclasses.dataclass
class KMeansBalancedParams:
    """Hyper-parameters; ``target_balance_cv``/``balance_polish_rounds``
    drive the balance polish (``target_balance_cv=None`` turns it off)."""

    n_iters: int = 20
    metric: DistanceType = DistanceType.L2Expanded
    target_balance_cv: Optional[float] = 0.24
    balance_polish_rounds: int = 16

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if self.metric not in (
            DistanceType.L2Expanded,
            DistanceType.L2SqrtExpanded,
            DistanceType.InnerProduct,
            DistanceType.CosineExpanded,
        ):
            raise ValueError(
                f"kmeans_balanced supports L2/IP/Cosine metrics, got "
                f"{self.metric.name}")


def _needs_normalized_centers(metric: DistanceType) -> bool:
    return metric in (DistanceType.InnerProduct, DistanceType.CosineExpanded,
                      DistanceType.CorrelationExpanded)


def _normalize_rows(c: torch.Tensor) -> torch.Tensor:
    return c / torch.clamp_min(torch.linalg.norm(c, dim=1, keepdim=True), 1e-20)


def _predict_labels(x, centers, metric: DistanceType, active_mask=None,
                    tile: int = 65536) -> torch.Tensor:
    """E-step: nearest active center per row (argmax of the score for
    IP/cosine), tiled over rows so that only [tile, n_clusters] scores exist
    at once. Ties go to the lowest center index."""
    cf = centers.to(torch.float32)
    cn = row_norms_sq(cf)
    if metric == DistanceType.CosineExpanded:
        c_inv_norm = 1.0 / torch.clamp_min(torch.sqrt(cn), 1e-20)
    out = []
    for s in range(0, x.shape[0], tile):
        xf = x[s:s + tile].to(torch.float32)
        dots = dot_fp32(xf, cf)
        if metric in (DistanceType.InnerProduct, DistanceType.CosineExpanded):
            score = (dots * c_inv_norm[None, :]
                     if metric == DistanceType.CosineExpanded else dots)
            if active_mask is not None:
                score = torch.where(active_mask[None, :], score, -torch.inf)
            out.append(torch.argmax(score, dim=1))
        else:
            d = (row_norms_sq(xf)[:, None] + cn[None, :]) - 2.0 * dots
            if active_mask is not None:
                d = torch.where(active_mask[None, :], d, torch.inf)
            out.append(torch.argmin(d, dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    return torch.cat(out).to(torch.int32)


def calc_centers_and_sizes(x, labels, n_clusters: int, weights=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-step: per-cluster (weighted) mean and size."""
    xf = x.to(torch.float32)
    lab = labels.to(torch.int64)
    if weights is not None:
        w = weights.to(torch.float32)
        xf = xf * w[:, None]
    else:
        w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    counts = torch.zeros(n_clusters, dtype=torch.float32,
                         device=x.device).index_add_(0, lab, w)
    sums = torch.zeros((n_clusters, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, lab, xf)
    return sums / torch.clamp_min(counts, 1.0)[:, None], counts


def _adjust_centers(generator, centers, sizes, x, labels, weights,
                    active_mask, threshold: float):
    """Re-seed starving clusters toward rows of big clusters: starving
    cluster l takes the (l mod n_good)-th good donor of a pool of
    ``_DONOR_POOL`` sampled rows. Returns (adjusted_any, new_centers)."""
    n_rows, n_clusters = x.shape[0], centers.shape[0]
    dev = x.device
    n_eff = weights.sum() if weights is not None else float(n_rows)
    n_active = (active_mask.sum().to(torch.float32) if active_mask is not None
                else float(n_clusters))
    average = n_eff / max(float(n_active), 1.0)
    starving = sizes <= average * threshold
    if active_mask is not None:
        starving = starving & active_mask
    big = sizes >= average

    pool_idx = torch.randint(0, n_rows, (_DONOR_POOL,), generator=generator,
                             device=dev)
    pool_ok = big[labels[pool_idx].long()]
    if weights is not None:
        pool_ok = pool_ok & (weights[pool_idx] > 0)
    order = torch.argsort((~pool_ok).to(torch.int8), stable=True)
    pool_idx = pool_idx[order]
    n_good = pool_ok.sum()
    slot = torch.arange(n_clusters, device=dev) % torch.clamp_min(n_good, 1)
    donor_rows = pool_idx[slot]
    have_donor = (n_good > 0) & starving
    donor_label = labels[donor_rows].long()
    wc = torch.clamp_max(sizes, _ADJUST_CENTERS_WEIGHT)[:, None]
    new = (wc * centers[donor_label] + x[donor_rows].to(torch.float32)) \
        / (wc + 1.0)
    centers = torch.where(have_donor[:, None], new, centers)
    return bool(have_donor.any()), centers


def _balancing_em_loop(generator, x, weights, active_mask, centers, labels,
                       sizes, n_iters: int, pullback: int, threshold: float,
                       metric: DistanceType):
    """Balancing EM: adjust (from the second iteration), normalize for
    IP/cosine, E-step, M-step. Each adjustment counts toward ``pullback``,
    and every ``pullback`` of them grant one more iteration (the counter
    starts full, so the first iteration grants one)."""
    n_clusters = centers.shape[0]
    max_iters = n_iters + cdiv(n_iters, 2) + 1
    i, iters_target, balance_ctr = 0, n_iters, pullback
    while i < min(iters_target, max_iters):
        adjusted = False
        if i > 0:
            adjusted, centers = _adjust_centers(
                generator, centers, sizes, x, labels, weights, active_mask,
                threshold)
        balance_ctr += int(adjusted)
        if balance_ctr >= pullback:
            balance_ctr -= pullback
            iters_target += 1
        if _needs_normalized_centers(metric):
            centers = _normalize_rows(centers)
        labels = _predict_labels(x, centers, metric, active_mask)
        centers, sizes = calc_centers_and_sizes(x, labels, n_clusters, weights)
        i += 1
    return centers, labels, sizes


def build_clusters(generator, x, n_clusters: int,
                   params: Optional[KMeansBalancedParams] = None,
                   weights: Optional[torch.Tensor] = None,
                   n_active: Optional[int] = None):
    """Single-level balanced k-means on ``x``'s device → (centers, labels,
    sizes). Labels start at row % n_clusters. ``n_active`` trains only the
    first n_active clusters (the hierarchical fine stage)."""
    params = params or KMeansBalancedParams()
    n_rows = x.shape[0]
    dev = x.device
    rows = torch.arange(n_rows, device=dev)
    active_mask = None
    if n_active is not None:
        active_mask = torch.arange(n_clusters, device=dev) < int(n_active)
        labels0 = rows % max(int(n_active), 1)
    else:
        labels0 = rows % n_clusters
    labels0 = labels0.to(torch.int32)
    centers0, sizes0 = calc_centers_and_sizes(x, labels0, n_clusters, weights)
    return _balancing_em_loop(generator, x, weights, active_mask, centers0,
                              labels0, sizes0, int(params.n_iters),
                              _BUILD_PULLBACK, _BUILD_THRESHOLD, params.metric)


def _arrange_fine_clusters(n_clusters: int, n_meso: int, n_rows: int,
                           meso_sizes: np.ndarray) -> np.ndarray:
    """Fine-cluster count per mesocluster, proportional to its size."""
    fine_nums = np.zeros(n_meso, dtype=np.int64)
    n_lists_rem = n_clusters
    n_rows_rem = n_rows
    n_nonempty_rem = int((meso_sizes > 0).sum())
    for i in range(n_meso):
        if i < n_meso - 1:
            if meso_sizes[i] == 0:
                fine_nums[i] = 0
            else:
                n_nonempty_rem -= 1
                share = int(n_lists_rem * meso_sizes[i] / max(n_rows_rem, 1)
                            + 0.5)
                fine_nums[i] = min(max(share, 1),
                                   max(n_lists_rem - n_nonempty_rem, 1))
        else:
            fine_nums[i] = n_lists_rem if meso_sizes[i] > 0 else 0
        n_lists_rem -= fine_nums[i]
        n_rows_rem -= int(meso_sizes[i])
    return fine_nums


def fit(generator, x, n_clusters: int,
        params: Optional[KMeansBalancedParams] = None) -> torch.Tensor:
    """Hierarchical balanced k-means → centers [n_clusters, dim] fp32."""
    params = params or KMeansBalancedParams()
    n_rows, dim = x.shape
    if n_clusters > n_rows:
        raise ValueError(f"n_clusters={n_clusters} > n_rows={n_rows}")
    n_meso = min(n_clusters, int(math.sqrt(n_clusters) + 0.5))
    if n_meso <= 1 or n_clusters <= n_meso:
        centers, _, _ = build_clusters(generator, x, n_clusters, params)
        return _balance_polish(generator, x, centers, params)

    # coarse stage: mesoclusters over the whole trainset
    _, meso_labels, meso_sizes_f = build_clusters(generator, x, n_meso, params)
    meso_labels_np = meso_labels.cpu().numpy()
    meso_sizes = meso_sizes_f.cpu().numpy().astype(np.int64)
    fine_nums = _arrange_fine_clusters(n_clusters, n_meso, n_rows, meso_sizes)
    if int(fine_nums.sum()) != n_clusters:
        raise RuntimeError(f"fine cluster counts sum to {fine_nums.sum()}, "
                           f"expected {n_clusters}")
    meso_max = int(min(meso_sizes.max(),
                       max(cdiv(2 * n_rows, max(n_meso, 1)), 1)))
    fine_max = int(fine_nums.max())

    # fine stage: one balanced build per mesocluster over its (capped,
    # weight-padded) member rows, fine_max centers of which fine_nums[i]
    # are trained
    xf = x.to(torch.float32)
    centers_out = torch.zeros((n_clusters, dim), dtype=torch.float32,
                              device=x.device)
    done = 0
    for i in range(n_meso):
        members = np.nonzero(meso_labels_np == i)[0][:meso_max]
        member_idx = np.zeros(meso_max, np.int64)
        member_idx[: len(members)] = members
        wts = torch.zeros(meso_max, dtype=torch.float32, device=x.device)
        wts[: len(members)] = 1.0
        sub = xf[torch.from_numpy(member_idx).to(x.device)]
        c, _, _ = build_clusters(generator, sub, fine_max, params,
                                 weights=wts, n_active=int(fine_nums[i]))
        centers_out[done: done + fine_nums[i]] = c[: fine_nums[i]]
        done += int(fine_nums[i])

    # fine-tuning EM over all clusters
    centers, _, _ = _fine_tune(generator, xf, centers_out,
                               max(params.n_iters // 10, 2), params.metric)
    return _balance_polish(generator, x, centers, params)


def _fine_tune(generator, x, centers0, n_iters: int, metric: DistanceType):
    n_clusters = centers0.shape[0]
    labels0 = _predict_labels(x, centers0, metric)
    sizes0 = torch.zeros(n_clusters, dtype=torch.float32,
                         device=x.device).index_add_(
        0, labels0.long(), torch.ones(x.shape[0], device=x.device))
    return _balancing_em_loop(generator, x, None, None, centers0, labels0,
                              sizes0, n_iters, _TUNE_PULLBACK,
                              _TUNE_THRESHOLD, metric)


def _size_cv(sizes: torch.Tensor) -> float:
    return float(torch.std(sizes, correction=0)
                 / torch.clamp_min(sizes.mean(), 1e-9))


def _polish_round(generator, x, centers, thr_hi: float, thr_lo: float,
                  metric: DistanceType, target_cv: float):
    """One balance-polish round: re-seed the emptiest centers at the hottest
    clusters' centers plus noise ~0.3× their RMS radius, then two EM
    iterations to settle. Returns (centers, cv_pre, cv_post, n_moved)."""
    n_rows, dim = x.shape
    n_clusters = centers.shape[0]
    labels = _predict_labels(x, centers, metric)
    centers_m, sizes = calc_centers_and_sizes(x, labels, n_clusters)
    cv_pre = _size_cv(sizes)
    xsq = torch.zeros(n_clusters, dtype=torch.float32,
                      device=x.device).index_add_(0, labels.long(),
                                                  (x * x).sum(-1))
    msd = xsq / torch.clamp_min(sizes, 1.0) - (centers_m * centers_m).sum(-1)
    order = torch.argsort(sizes, stable=True)
    n_pairs = min(max(n_clusters // 16, 1), 64)
    small = order[:n_pairs]
    large = order.flip(0)[:n_pairs]
    avg = n_rows / n_clusters
    do = ((sizes[large] > thr_hi * avg) & (sizes[small] < thr_lo * avg)
          & (cv_pre > target_cv))
    scale = 0.3 * torch.sqrt(torch.clamp_min(msd[large], 1e-12) / dim)[:, None]
    noise = torch.randn((n_pairs, dim), generator=generator,
                        device=x.device) * scale
    cf = centers_m.clone()
    cf[small] = torch.where(do[:, None], centers_m[large] + noise,
                            centers_m[small])
    sizes2 = sizes
    for _ in range(2):
        if _needs_normalized_centers(metric):
            cf = _normalize_rows(cf)
        labels2 = _predict_labels(x, cf, metric)
        cf, sizes2 = calc_centers_and_sizes(x, labels2, n_clusters)
    return cf, cv_pre, _size_cv(sizes2), int(do.sum())


def _balance_polish(generator, x, centers, params: KMeansBalancedParams):
    """Polish rounds keeping the best-balanced centers seen; thresholds start
    strict (split > 1.4×avg into < 0.5×avg) and relax when nothing moves.
    Stops at the target CV, when the mildest thresholds move nothing, or
    after 4 rounds without progress."""
    target = params.target_balance_cv
    if target is None or params.balance_polish_rounds <= 0:
        return centers
    xf = x.to(torch.float32)
    best, best_cv = centers, np.inf
    stalled = 0
    thr_hi, thr_lo = 1.4, 0.5
    for _ in range(params.balance_polish_rounds):
        new_centers, cv_pre, cv_post, n_moved = _polish_round(
            generator, xf, centers, thr_hi, thr_lo, params.metric,
            float(target))
        if cv_pre <= target:
            return centers
        if cv_pre < best_cv:
            best, best_cv = centers, cv_pre
        if cv_post < best_cv - 1e-3:
            best, best_cv, stalled = new_centers, cv_post, 0
        else:
            stalled += 1
        centers = new_centers
        if best_cv <= target or stalled >= 4:
            break
        if n_moved == 0:
            if thr_hi <= 1.15:
                break
            thr_hi = max(thr_hi - 0.1, 1.15)
            thr_lo = min(thr_lo + 0.1, 0.85)
    return best


def predict(centers, x, params: Optional[KMeansBalancedParams] = None
            ) -> torch.Tensor:
    """Nearest center per row of x (int32 labels), on the centers' device."""
    params = params or KMeansBalancedParams()
    x = torch.as_tensor(x).to(centers.device)
    return _predict_labels(x, centers, params.metric)
