"""Pairwise distances (counterpart of ``raft_tpu.ops.distance``): every
dense metric of the JAX package, in its two engines.

- **Product engine**: the metrics whose cross term is an inner product
  (expanded L2 with or without the square root, cosine, inner product,
  correlation, Hellinger, Russell-Rao, KL divergence) take one fp32 matrix
  product (``dot_fp32``) and an elementwise epilogue.
- **Elementwise engine**: the metrics that need a function of each pair of
  coordinates (L1, unexpanded L2 with or without the square root, Linf,
  Canberra, Bray-Curtis, Jensen-Shannon, Hamming, Minkowski with
  ``metric_arg`` as p) broadcast a tile of x's rows against all of y and
  reduce over the coordinates. The tile's rows are sized so the
  [rows, n, dim] fp32 intermediate fits a quarter of the workspace budget
  (``_choose_tile_rows``), as the JAX package sizes its tiles.

Haversine takes (latitude, longitude) rows in radians. Jaccard and Dice
are sparse-only, as in the JAX package, and raise. ``pairwise_distance``
is the public entry (on CUDA unless the caller asks for the CPU);
``pairwise_core`` the same function on tensors already on their device.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.utils.shape import balanced_tile


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

#: the dense metrics ``pairwise_core`` serves (Jaccard, Dice and
#: Precomputed are not dense metrics, as in the JAX package)
PORTED_METRICS = tuple(m for m in DistanceType
                       if m not in (DistanceType.JaccardExpanded,
                                    DistanceType.DiceExpanded,
                                    DistanceType.Precomputed))


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


def check_fp32_products(t: torch.Tensor) -> None:
    """Refuse a product on the card while TF32 is allowed for matmuls: it
    keeps about three decimal digits and reorders exact neighbours."""
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: exact search "
            "needs fp32 products; set it to False")


def dot_fp32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ yᵀ in full fp32, the counterpart of ``Precision.HIGHEST``. On the
    card this refuses to run while TF32 is allowed for matmuls, which would
    keep only about three decimal digits and reorder exact neighbours."""
    check_fp32_products(x)
    return torch.matmul(x.to(torch.float32), y.to(torch.float32).T)


def einsum_fp32(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over fp32 copies of the operands, refusing TF32 on
    the card as ``dot_fp32`` does (the counterpart of an einsum with
    ``preferred_element_type=float32``)."""
    check_fp32_products(operands[0])
    return torch.einsum(equation, *(o.to(torch.float32) for o in operands))


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    """The bf16 rounding of ``t``, as fp32 values."""
    return t.to(torch.bfloat16).to(torch.float32)


def dot_bf16(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ yᵀ over bf16 operands with fp32 sums and an fp32 result: the
    bf16 fast scan's screen (the JAX package's bf16 ``dot_general`` with
    ``preferred_element_type=float32``). On the card one bf16 matrix
    product with an fp32 output; on the CPU the same function as an fp32
    product of the bf16-rounded operands (each product is exact in fp32)."""
    if x.device.type == "cuda":
        return torch.mm(x.to(torch.bfloat16), y.to(torch.bfloat16).T,
                        out_dtype=torch.float32)
    return torch.matmul(_bf16_f32(x), _bf16_f32(y).T)


def gathered_dot_bf16(queries: torch.Tensor, vecs: torch.Tensor
                      ) -> torch.Tensor:
    """Each query [t, d] against its own candidates [t, c, d] → [t, c], as
    :func:`dot_bf16` computes a product."""
    if queries.device.type == "cuda":
        return torch.bmm(vecs.to(torch.bfloat16),
                         queries.to(torch.bfloat16)[:, :, None],
                         out_dtype=torch.float32)[:, :, 0]
    return torch.einsum("td,tcd->tc", _bf16_f32(queries), _bf16_f32(vecs))


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


_TINY = 1e-38  # the JAX package's guard of logarithms and divisions


def correlation_expanded(x, y) -> torch.Tensor:
    """1 − (k·Σxy − ΣxΣy) / √((k·Σx² − (Σx)²)(k·Σy² − (Σy)²))."""
    k = x.shape[-1]
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    sx, sy = xf.sum(-1), yf.sum(-1)
    sx2, sy2 = (xf * xf).sum(-1), (yf * yf).sum(-1)
    numer = k * dot_fp32(xf, yf) - sx[:, None] * sy[None, :]
    q = k * sx2 - sx * sx
    r = k * sy2 - sy * sy
    denom = torch.sqrt(torch.clamp_min(q[:, None] * r[None, :], 0.0))
    return 1.0 - numer / torch.clamp_min(denom,
                                         torch.finfo(torch.float32).tiny)


def hellinger_expanded(x, y) -> torch.Tensor:
    """√(1 − Σ√(x·y)), the product taken over √x and √y."""
    inner = dot_fp32(torch.sqrt(torch.clamp_min(x.to(torch.float32), 0.0)),
                     torch.sqrt(torch.clamp_min(y.to(torch.float32), 0.0)))
    # rounding can lift the product a hair above 1
    return torch.sqrt(torch.clamp_min(1.0 - inner, 0.0))


def russelrao_expanded(x, y) -> torch.Tensor:
    """(k − Σ x·y) / k, for binary rows."""
    k = x.shape[-1]
    return (k - dot_fp32(x, y)) / k


def _log_pos(t: torch.Tensor) -> torch.Tensor:
    """log t where t > 0, else 0."""
    return torch.where(t > 0, torch.log(torch.clamp_min(t, _TINY)), 0.0)


def kl_divergence(x, y) -> torch.Tensor:
    """0.5·Σ x·log(x / y), the zero entries contributing nothing."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    x_logx = (xf * _log_pos(xf)).sum(-1)
    return 0.5 * (x_logx[:, None] - dot_fp32(xf, _log_pos(yf)))


def haversine(x, y) -> torch.Tensor:
    """Great-circle distance between (latitude, longitude) rows in radians."""
    if x.shape[-1] != 2 or y.shape[-1] != 2:
        raise ValueError("haversine requires dim-2 (lat, lon) inputs")
    x, y = x.to(torch.float32), y.to(torch.float32)
    lat1, lon1 = x[:, 0:1], x[:, 1:2]
    lat2, lon2 = y[None, :, 0], y[None, :, 1]
    sin_dlat = torch.sin(0.5 * (lat2 - lat1))
    sin_dlon = torch.sin(0.5 * (lon2 - lon1))
    a = sin_dlat ** 2 + torch.cos(lat1) * torch.cos(lat2) * sin_dlon ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


# ------------------------------------------------------ elementwise engine


def _elem_l1(xt, yt):
    return (xt - yt).abs().sum(-1)


def _elem_l2_unexp(xt, yt):
    d = xt - yt
    return (d * d).sum(-1)


def _elem_l2_sqrt_unexp(xt, yt):
    return torch.sqrt(_elem_l2_unexp(xt, yt))


def _elem_linf(xt, yt):
    return (xt - yt).abs().amax(-1)


def _elem_canberra(xt, yt):
    num = (xt - yt).abs()
    den = xt.abs() + yt.abs()
    return torch.where(den > 0, num / torch.clamp_min(den, _TINY),
                       0.0).sum(-1)


def _elem_braycurtis(xt, yt):
    num = (xt - yt).abs().sum(-1)
    den = (xt + yt).abs().sum(-1)
    return torch.where(den > 0, num / torch.clamp_min(den, _TINY), 0.0)


def _elem_jensen_shannon(xt, yt):
    log_m = _log_pos(0.5 * (xt + yt))
    px = torch.where(xt > 0, xt * (torch.log(torch.clamp_min(xt, _TINY))
                                   - log_m), 0.0)
    py = torch.where(yt > 0, yt * (torch.log(torch.clamp_min(yt, _TINY))
                                   - log_m), 0.0)
    return torch.sqrt(torch.clamp_min(0.5 * (px + py).sum(-1), 0.0))


def _elem_hamming(xt, yt):
    return (xt != yt).to(torch.float32).sum(-1) / xt.shape[-1]


def _make_elem_lp(p: float):
    def _elem_lp(xt, yt):
        return ((xt - yt).abs() ** p).sum(-1) ** (1.0 / p)

    return _elem_lp


_ELEMENTWISE = {
    DistanceType.L1: _elem_l1,
    DistanceType.L2Unexpanded: _elem_l2_unexp,
    DistanceType.L2SqrtUnexpanded: _elem_l2_sqrt_unexp,
    DistanceType.Linf: _elem_linf,
    DistanceType.Canberra: _elem_canberra,
    DistanceType.BrayCurtis: _elem_braycurtis,
    DistanceType.JensenShannon: _elem_jensen_shannon,
    DistanceType.HammingUnexpanded: _elem_hamming,
}

#: the workspace budget of a ``pairwise_core`` call that names none (the
#: JAX package's sharded and sparse callers pass 1 << 30)
DEFAULT_BUDGET = 1 << 30


def _choose_tile_rows(m: int, n: int, k: int, budget_bytes: int) -> int:
    """Rows of x a tile, so the [rows, n, k] fp32 broadcast fits a quarter
    of the budget (room for the intermediates of the reduction)."""
    per_row = max(n * k * 4, 1)
    tile = max(1, budget_bytes // (4 * per_row))
    tile = min(tile, m, 4096)
    return balanced_tile(m, tile, 8)


def _pairwise_tiled(x, y, elem_fn, tile_rows: int) -> torch.Tensor:
    """``elem_fn(x_tile[:, None, :], y[None, :, :])`` over tiles of x's
    rows."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    return torch.cat([elem_fn(xf[s:s + tile_rows, None, :], yf[None, :, :])
                      for s in range(0, max(xf.shape[0], 1), tile_rows)]
                     ) if xf.shape[0] else xf.new_zeros((0, yf.shape[0]))


def pairwise_core(x, y, metric: DistanceType, metric_arg: float = 2.0,
                  budget: Optional[int] = None) -> torch.Tensor:
    """All-pairs distances [m, n] of tensors on one device, in fp32, for
    every dense metric (``metric_arg``: Minkowski's p; ``budget``: the
    workspace bytes that size the elementwise engine's tiles)."""
    metric = resolve_metric(metric)
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        return l2_expanded(x, y, sqrt=metric == DistanceType.L2SqrtExpanded)
    if metric == DistanceType.CosineExpanded:
        return cosine_expanded(x, y)
    if metric == DistanceType.InnerProduct:
        return inner_product(x, y)
    if metric == DistanceType.CorrelationExpanded:
        return correlation_expanded(x, y)
    if metric == DistanceType.HellingerExpanded:
        return hellinger_expanded(x, y)
    if metric == DistanceType.RusselRaoExpanded:
        return russelrao_expanded(x, y)
    if metric == DistanceType.KLDivergence:
        return kl_divergence(x, y)
    if metric == DistanceType.Haversine:
        return haversine(x, y)
    if metric == DistanceType.LpUnexpanded:
        fn = _make_elem_lp(float(metric_arg))
    elif metric in _ELEMENTWISE:
        fn = _ELEMENTWISE[metric]
    else:
        raise NotImplementedError(
            f"metric {metric.name} is not supported for dense inputs "
            "(Jaccard/Dice are sparse-only in the reference as well)")
    budget = DEFAULT_BUDGET if budget is None else int(budget)
    tile = _choose_tile_rows(x.shape[0], y.shape[0], x.shape[1], budget)
    return _pairwise_tiled(x, y, fn, tile)


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device)


def pairwise_distance(x, y, metric="euclidean", metric_arg: float = 2.0,
                      res: Optional[Resources] = None,
                      device=None) -> torch.Tensor:
    """The distance matrix [m, n] between the rows of x [m, k] and y [n, k]
    (``pylibraft.distance.pairwise_distance``), on ``res``'s device (CUDA
    unless the caller asks for the CPU). ``metric_arg`` is Minkowski's p
    for ``LpUnexpanded``."""
    res = ensure_resources(res, device)
    x, y = _as_tensor(x, res.device), _as_tensor(y, res.device)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"bad shapes {tuple(x.shape)} vs {tuple(y.shape)}: "
                         "need [m,k],[n,k]")
    return pairwise_core(x, y, resolve_metric(metric), float(metric_arg),
                         res.workspace_limit_bytes)
