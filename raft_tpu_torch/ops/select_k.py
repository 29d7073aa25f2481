"""Batched top-k selection (counterpart of ``raft_tpu.ops.select_k``).

``SelectAlgo`` keeps the JAX package's names:

- ``DIRECT``: one selection over the row (glue, as ``lax.top_k`` was);
- ``TWO_PHASE``: a selection per 16384-wide tile, then over the survivors;
- ``PALLAS``: the hand-written streaming kernel
  (``ops.gpu_kernels.streaming_select_k``; its plain version on the CPU);
- ``APPROX`` and ``SCREEN``: aliases of exact ``DIRECT`` selection. The JAX
  package's approximate PartialReduce engine and its certified-threshold
  screen are TPU answers to a slow ``lax.top_k``; the port selects exactly.

``AUTO`` picks ``DIRECT`` or ``TWO_PHASE`` by row width from the JAX
package's builtin default crossover table. A crossover table measured on
the H100, and the SELECT_K_TABLE / TOPK_PAD artifact scanners, are later
work.

Both glue engines return ``lax.top_k``'s order exactly (``topk_lowest_first``):
values in IEEE total order (-0.0 before +0.0), ties by lowest position, so
the members at a tie on the k-th value are the lowest positions too. A bare
``torch.topk`` leaves both the order and the members of a tie unspecified.
The graph merges of NN-descent and CAGRA (``merge_topk_dedup``,
``merge_topk_dedup_flagged``) rest on that order.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.utils.shape import cdiv


class SelectAlgo(enum.Enum):
    AUTO = "auto"
    DIRECT = "direct"
    TWO_PHASE = "two_phase"
    PALLAS = "pallas"
    APPROX = "approx"
    SCREEN = "screen"


_TILE = 16384
#: k_max → row width from which TWO_PHASE is chosen over DIRECT
_DEFAULT_TABLE = {"32": 65536, "256": 65536, "inf": 131072}


def _band(table: dict, k: int) -> Optional[int]:
    """Width threshold of the smallest k-band covering ``k``."""
    for k_max, width in sorted(
            ((float(km) if km != "inf" else float("inf"), w)
             for km, w in table.items())):
        if k <= k_max:
            return width
    return None


def _resolve_auto(n: int, k: int) -> SelectAlgo:
    if k * 4 > n:
        return SelectAlgo.DIRECT
    band = _band(_DEFAULT_TABLE, k)
    if band is None or n < band:
        return SelectAlgo.DIRECT
    return SelectAlgo.TWO_PHASE


def _order_keys(values: torch.Tensor, select_min: bool) -> torch.Tensor:
    """int64 keys whose descending order is ``lax.top_k``'s order of the
    values to select: IEEE total order for floats (NaN above +inf, -0.0
    below +0.0), negated first for ``select_min`` as the JAX package does."""
    if values.dtype.is_floating_point:
        v = values.to(torch.float32)
        bits = (-v if select_min else v).view(torch.int32)
        return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    v = values.to(torch.int64)
    return -v if select_min else v


def topk_lowest_first(values: torch.Tensor, k: int, select_min: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (or largest) entries of each row of values [b, n] in
    ``lax.top_k``'s order: ``(values [b, k], positions [b, k] int64)``.

    One ``torch.topk`` over distinct composite keys (the order key in the
    high 32 bits, ``n - 1 - position`` in the low ones), so it stays O(n),
    needs no host sync and leaves no tie to the library. On the IVF-PQ
    overflow merge (10,000 rows of 1,650, k=10; NVIDIA H100 80GB HBM3,
    700.00 W) it takes 1.40 ms against a float ``torch.topk``'s 0.47 ms;
    the k-th value from a float ``torch.topk`` plus the tied members by a
    cumulative count took 2.22 ms (``bench/ivf_pq_timing.py``, PERF.md)."""
    b, n = values.shape
    if n >= 1 << 31:
        raise ValueError(f"row of {n} entries is too long for the composite key")
    pos = torch.arange(n, device=values.device, dtype=torch.int64)
    key = _order_keys(values, select_min)
    if not values.dtype.is_floating_point:  # int keys can use the full 64 bits
        order = torch.sort(-key, dim=1, stable=True).indices[:, :k]
        return torch.gather(values, 1, order), order
    composite = (key << 32) | (n - 1 - pos)[None, :]
    top = torch.topk(composite, k, dim=1, largest=True, sorted=True).values
    sel = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(values, 1, sel), sel


def _direct(values: torch.Tensor, k: int, select_min: bool):
    v, i = topk_lowest_first(values, k, select_min)
    return v, i.to(torch.int32)


def _two_phase(values: torch.Tensor, k: int, select_min: bool):
    batch, n = values.shape
    tile = max(_TILE, k)
    n_tiles = cdiv(n, tile)
    fill = torch.inf if select_min else -torch.inf
    v = values.new_full((batch, n_tiles * tile), fill)
    v[:, :n] = values
    tv, ti = topk_lowest_first(v.view(batch * n_tiles, tile), min(k, tile),
                               select_min)
    ti = ti.view(batch, n_tiles, -1) \
        + (torch.arange(n_tiles, device=values.device) * tile)[None, :, None]
    # survivors in tile-major order: the lowest survivor index on a tie is
    # the lowest position in the row
    mv, mi = topk_lowest_first(tv.reshape(batch, -1), k, select_min)
    out_i = torch.gather(ti.reshape(batch, -1), 1, mi)
    return mv, out_i.to(torch.int32)


def select_k(values, k: int, select_min: bool = True,
             indices: Optional[torch.Tensor] = None,
             algo: SelectAlgo = SelectAlgo.AUTO
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest (or largest) entries per row of values
    [batch, len] → ``(values [batch, k], positions [batch, k] int32)``.
    With ``indices`` the positions are relabelled through it, keeping -1
    null markers. Every algorithm here is exact."""
    values = torch.as_tensor(values)
    if values.dim() == 1:
        v, i = select_k(values[None], k, select_min, None, algo)
        v, i = v[0], i[0]
        if indices is not None:
            idx = torch.as_tensor(indices, device=values.device)
            i = torch.where(i < 0, -1, idx[i.clamp_min(0).long()].to(torch.int32))
        return v, i
    if k > values.shape[-1]:
        raise ValueError(f"k={k} > row length {values.shape[-1]}")
    if algo == SelectAlgo.AUTO:
        algo = _resolve_auto(values.shape[-1], int(k))
    if algo == SelectAlgo.PALLAS:
        v, out_i = gk.streaming_select_k(values.to(torch.float32).contiguous(),
                                         int(k), bool(select_min))
        out_v = v.to(values.dtype)
    elif algo == SelectAlgo.TWO_PHASE:
        out_v, out_i = _two_phase(values, int(k), bool(select_min))
    else:  # DIRECT, and the exact stand-ins for APPROX and SCREEN
        out_v, out_i = _direct(values, int(k), bool(select_min))
    if indices is not None:
        relabeled = torch.gather(torch.as_tensor(indices, device=values.device),
                                 1, out_i.clamp_min(0).long())
        out_i = torch.where(out_i < 0, -1, relabeled.to(torch.int32))
    return out_v, out_i


def select_k_maybe_approx(values, k: int, select_min: bool,
                          select_recall: float):
    """The selection every search body makes: APPROX below a recall of 1,
    which in the port is exact like AUTO."""
    algo = SelectAlgo.APPROX if select_recall < 1.0 else SelectAlgo.AUTO
    return select_k(values, k, select_min=select_min, algo=algo)


def refine_multiplier(refine_ratio, fast_scan: bool) -> int:
    """A ``refine_ratio`` search parameter rounded to the screen multiple of
    the bf16 fast scan; 1 when the fast scan is off."""
    return max(1, int(round(float(refine_ratio)))) if fast_scan else 1


def _pad_cols(t: torch.Tensor, k: int, fill) -> torch.Tensor:
    if t.shape[1] >= k:
        return t
    return torch.cat([t, t.new_full((t.shape[0], k - t.shape[1]), fill)], 1)


def merge_topk_dedup(ids, dists, k: int, exclude_ids=None):
    """Top-``k`` smallest ``dists`` per row with duplicate ids suppressed
    (the shared merge of the graph builds). ids [b, m] int (-1 invalid),
    dists [b, m]; ``exclude_ids`` [b] bans one id per row (self). Returns
    ``(ids [b, k] int32, dists [b, k])`` ascending, losers (-1, +inf). Of a
    group of copies the first in a stable sort by id stays; ties in
    distance go to the lower position in that sort (``lax.top_k``). Rows
    shorter than k are padded with (-1, +inf)."""
    ids = _pad_cols(ids, k, -1)
    dists = _pad_cols(dists, k, torch.inf)
    if exclude_ids is not None:
        ids = torch.where(ids == exclude_ids[:, None], -1, ids)
    ds = torch.where(ids < 0, torch.inf, dists)
    order = torch.sort(ids, dim=1, stable=True).indices
    ids_s = torch.gather(ids, 1, order)
    ds_s = torch.gather(ds, 1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    ds_s = torch.where(dup, torch.inf, ds_s)
    top, sel = topk_lowest_first(ds_s, k, select_min=True)
    out_ids = torch.gather(ids_s, 1, sel)
    return (torch.where(torch.isfinite(top), out_ids, -1).to(torch.int32),
            top)


def merge_topk_dedup_flagged(ids, dists, flags, k: int):
    """``merge_topk_dedup`` carrying a per-entry flag: copies of an id
    collapse to one entry whose flag is the OR of theirs (the sort key
    ``ids*2 + (not flag)`` puts a flagged copy first). Returns ``(ids [b, k]
    int32, dists [b, k], flags [b, k])`` ascending; a +inf entry has id -1
    and its flag clear."""
    ids = _pad_cols(ids, k, -1)
    dists = _pad_cols(dists, k, torch.inf)
    flags = _pad_cols(flags, k, False)
    ds = torch.where(ids < 0, torch.inf, dists)
    key = ids.to(torch.int32) * 2 + torch.where(flags, 0, 1).to(torch.int32)
    key = torch.where(ids < 0, torch.iinfo(torch.int32).max, key)
    order = torch.sort(key, dim=1, stable=True).indices
    ids_s = torch.gather(ids, 1, order)
    ds_s = torch.gather(ds, 1, order)
    fl_s = torch.gather(flags, 1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    ds_s = torch.where(dup, torch.inf, ds_s)
    top, sel = topk_lowest_first(ds_s, k, select_min=True)
    valid = torch.isfinite(top)
    out_ids = torch.gather(ids_s, 1, sel)
    out_fl = torch.gather(fl_s, 1, sel)
    return (torch.where(valid, out_ids, -1).to(torch.int32), top,
            out_fl & valid)
