"""Pairwise distances (counterpart of ``raft_tpu.ops.distance``).

The metric set that the brute-force and IVF-Flat searches use: expanded L2
(clamped at 0, with or without the square root), cosine and inner product,
all through one fp32 matrix product. The JAX package's other dense metrics
(L1, Linf, Lp, Canberra, correlation, ...) are still to be ported and raise
``NotImplementedError``.
"""

from __future__ import annotations

import enum

import torch


class DistanceType(enum.IntEnum):
    """Metric enum; values match ``raft_tpu.ops.distance.DistanceType``."""

    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


_METRIC_ALIASES = {
    "euclidean": DistanceType.L2SqrtExpanded,
    "sqeuclidean": DistanceType.L2Expanded,
    "l2": DistanceType.L2SqrtExpanded,
    "l2_expanded": DistanceType.L2Expanded,
    "l2_unexpanded": DistanceType.L2Unexpanded,
    "l2sqrt_expanded": DistanceType.L2SqrtExpanded,
    "l2sqrt_unexpanded": DistanceType.L2SqrtUnexpanded,
    "cosine": DistanceType.CosineExpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "taxicab": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "linf": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "minkowski": DistanceType.LpUnexpanded,
    "lp": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "kldivergence": DistanceType.KLDivergence,
    "russellrao": DistanceType.RusselRaoExpanded,
    "russelrao": DistanceType.RusselRaoExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "dice": DistanceType.DiceExpanded,
    "sqeuclidean_unexpanded": DistanceType.L2Unexpanded,
}

#: the metrics of this slice; the rest wait for ROADMAP Queue A item 14
PORTED_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                  DistanceType.CosineExpanded, DistanceType.InnerProduct)


def resolve_metric(metric) -> DistanceType:
    """A DistanceType, its name, or a pylibraft-style string alias."""
    if isinstance(metric, DistanceType):
        return metric
    if isinstance(metric, int):
        return DistanceType(metric)
    key = str(metric).lower()
    if key in _METRIC_ALIASES:
        return _METRIC_ALIASES[key]
    try:
        return DistanceType[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}") from None


def is_min_close(metric) -> bool:
    """True when a smaller distance means more similar (all but IP)."""
    return resolve_metric(metric) != DistanceType.InnerProduct


def _check_fp32_products(t: torch.Tensor) -> None:
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: exact search "
            "needs fp32 products; set it to False")


def dot_fp32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ yᵀ in full fp32, the counterpart of ``Precision.HIGHEST``. On the
    card this refuses to run while TF32 is allowed for matmuls, which would
    keep only about three decimal digits and reorder exact neighbours."""
    _check_fp32_products(x)
    return torch.matmul(x.to(torch.float32), y.to(torch.float32).T)


def einsum_fp32(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over fp32 copies of the operands, refusing TF32 on
    the card as ``dot_fp32`` does (the counterpart of an einsum with
    ``preferred_element_type=float32``)."""
    _check_fp32_products(operands[0])
    return torch.einsum(equation, *(o.to(torch.float32) for o in operands))


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 row norms in fp32."""
    xf = x.to(torch.float32)
    return (xf * xf).sum(dim=-1)


def l2_expanded(x, y, sqrt: bool, x_norms=None, y_norms=None) -> torch.Tensor:
    """‖x_i‖² + ‖y_j‖² − 2·x_i·y_j, clamped at 0 (square-rooted if asked)."""
    xn = row_norms_sq(x) if x_norms is None else x_norms
    yn = row_norms_sq(y) if y_norms is None else y_norms
    d = (xn[:, None] + yn[None, :]) - 2.0 * dot_fp32(x, y)
    d = torch.clamp_min(d, 0.0)
    return torch.sqrt(d) if sqrt else d


def cosine_expanded(x, y, x_norms=None, y_norms=None) -> torch.Tensor:
    """1 − x·y / (‖x‖ ‖y‖)."""
    xn = row_norms_sq(x) if x_norms is None else x_norms
    yn = row_norms_sq(y) if y_norms is None else y_norms
    denom = torch.sqrt(xn[:, None] * yn[None, :])
    tiny = torch.finfo(torch.float32).tiny
    return 1.0 - dot_fp32(x, y) / torch.clamp_min(denom, tiny)


def inner_product(x, y) -> torch.Tensor:
    return dot_fp32(x, y)


def gathered_distances(queries, vecs, metric: DistanceType,
                       vec_norms_sq=None) -> torch.Tensor:
    """Distances between queries [t, d] and their own candidates [t, c, d]:
    raw dots for InnerProduct, 1 − cos for cosine, clamped squared L2 (square
    root for L2SqrtExpanded). ``vec_norms_sq`` [t, c] gives the candidates'
    squared norms when the caller has them (one pass over ``vecs`` less)."""
    qf = queries.to(torch.float32)
    vf = vecs.to(torch.float32)
    dots = einsum_fp32("td,tcd->tc", qf, vf)
    if metric == DistanceType.InnerProduct:
        return dots
    vn2 = (vf * vf).sum(-1) if vec_norms_sq is None else vec_norms_sq
    if metric == DistanceType.CosineExpanded:
        vn = torch.sqrt(torch.clamp_min(vn2, 1e-20))
        qn = torch.sqrt(torch.clamp_min(row_norms_sq(qf), 1e-20))
        return 1.0 - dots / (vn * qn[:, None])
    d = torch.clamp_min((row_norms_sq(qf)[:, None] + vn2) - 2.0 * dots, 0.0)
    if metric == DistanceType.L2SqrtExpanded:
        d = torch.sqrt(d)
    return d


def pairwise_core(x, y, metric: DistanceType) -> torch.Tensor:
    """All-pairs distances for the ported metrics; the others raise."""
    metric = resolve_metric(metric)
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        return l2_expanded(x, y, sqrt=metric == DistanceType.L2SqrtExpanded)
    if metric == DistanceType.CosineExpanded:
        return cosine_expanded(x, y)
    if metric == DistanceType.InnerProduct:
        return inner_product(x, y)
    raise NotImplementedError(
        f"metric {metric.name} is not ported to raft_tpu_torch yet "
        "(ROADMAP Queue A item 14: the remaining dense metrics)")
