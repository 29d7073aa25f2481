"""Batched top-k selection (counterpart of ``raft_tpu.ops.select_k``).

``SelectAlgo`` keeps the JAX package's names:

- ``DIRECT``: one ``torch.topk`` over the row (glue, as ``lax.top_k`` was);
- ``TWO_PHASE``: ``torch.topk`` per 16384-wide tile, then over the survivors;
- ``PALLAS``: the hand-written streaming kernel
  (``ops.gpu_kernels.streaming_select_k``; its plain version on the CPU);
- ``APPROX`` and ``SCREEN``: aliases of exact ``DIRECT`` selection. The JAX
  package's approximate PartialReduce engine and its certified-threshold
  screen are TPU answers to a slow ``lax.top_k``; the port selects exactly.

``AUTO`` picks ``DIRECT`` or ``TWO_PHASE`` by row width from the JAX
package's builtin default crossover table. A crossover table measured on
the H100, and the SELECT_K_TABLE / TOPK_PAD artifact scanners, are later
work.
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


def _direct(values: torch.Tensor, k: int, select_min: bool):
    v, i = torch.topk(values, k, dim=-1, largest=not select_min, sorted=True)
    return v, i.to(torch.int32)


def _two_phase(values: torch.Tensor, k: int, select_min: bool):
    batch, n = values.shape
    tile = max(_TILE, k)
    n_tiles = cdiv(n, tile)
    fill = torch.inf if select_min else -torch.inf
    v = values.new_full((batch, n_tiles * tile), fill)
    v[:, :n] = values
    tv, ti = torch.topk(v.view(batch, n_tiles, tile), min(k, tile), dim=-1,
                        largest=not select_min, sorted=True)
    ti = ti + (torch.arange(n_tiles, device=values.device) * tile)[None, :, None]
    mv, mi = torch.topk(tv.reshape(batch, -1), k, dim=-1,
                        largest=not select_min, sorted=True)
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
