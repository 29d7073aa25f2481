"""Batched top-k selection (counterpart of ``raft_tpu.ops.select_k``).

``SelectAlgo`` keeps the JAX package's names:

- ``DIRECT``: one selection over the row (glue, as ``lax.top_k`` was);
- ``TWO_PHASE``: a selection per 16384-wide tile, then over the survivors;
- ``PALLAS``: the hand-written streaming kernel
  (``ops.gpu_kernels.streaming_select_k``; its plain version on the CPU);
- ``APPROX`` and ``SCREEN``: aliases of exact ``DIRECT`` selection. The JAX
  package's approximate PartialReduce engine and its certified-threshold
  screen are TPU answers to a slow ``lax.top_k``; the port selects exactly.

``AUTO`` picks ``DIRECT`` or ``TWO_PHASE`` by row width from a crossover
table of the device the values lie on, else from the JAX package's builtin
default table; DIRECT's requested k may be padded by the device's k-pad
rules (a selection asked for k takes the top k' >= k and keeps the first k,
which is exact). The tables are keyed by ``platform_key``: the card's name
on CUDA (``torch.cuda.get_device_name``), as the JAX package keys by TPU
kind, so an H100's table arms on no other card; ``"cpu"`` elsewhere. They
come from measured artifacts, ``raft_tpu_torch/artifacts/SELECT_K_TABLE_*.json``
and ``TOPK_PAD_*.json`` (written by ``python -m raft_tpu_torch.bench.probe``
on the card; the JAX package's artifacts at the repo root are never read),
plus an override named by ``RAFT_TPU_TORCH_SELECTK_TABLE`` /
``RAFT_TPU_TORCH_TOPK_PAD``, loaded last and loudly. ``set_auto_table``
and ``set_pad_rules`` install or drop a platform's table by hand. ``select_k_plan`` says what a
selection would resolve to, and ``select_k_filtered`` folds a bitset
filter into a selection.

Both glue engines return ``lax.top_k``'s order exactly (``topk_lowest_first``):
values in IEEE total order (-0.0 before +0.0), ties by lowest position, so
the members at a tie on the k-th value are the lowest positions too. A bare
``torch.topk`` leaves both the order and the members of a tie unspecified.
The graph merges of NN-descent and CAGRA (``merge_topk_dedup``,
``merge_topk_dedup_flagged``) rest on that order.
"""

from __future__ import annotations

import enum
import functools
import glob
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from raft_tpu_torch.core.bitset import filter_mask
from raft_tpu_torch.obs import explain as obs_explain
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
#: where the measured artifacts live (the JAX package's scanners read the
#: repo root; the port's never do)
ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")


def _scan_artifacts(tables: dict, prefix: str, env_var: str,
                    extract: Callable[[dict], object]) -> dict:
    """Fill ``tables`` (platform -> table) from the measured artifacts
    ``<prefix>_*.json`` under :data:`ARTIFACT_DIR`. A malformed artifact is
    skipped; the ``env_var`` override is loaded last and outside the try,
    so an explicit request fails loudly and wins over the committed ones."""
    for path in sorted(glob.glob(os.path.join(ARTIFACT_DIR,
                                              prefix + "_*.json"))):
        try:
            with open(path) as f:
                art = json.load(f)
            tables[art["platform"]] = extract(art)
        except (OSError, KeyError, ValueError, TypeError, AttributeError):
            pass  # malformed artifact: keep what we have
    path = os.environ.get(env_var)
    if path:
        with open(path) as f:
            art = json.load(f)
        tables[art["platform"]] = extract(art)
    return tables


#: crossover tables by platform (the measured artifacts, then what
#: ``set_auto_table`` installs); a platform without one takes "default"
_AUTO_TABLES: Optional[Dict[str, dict]] = None
#: k-pad rules by platform (the artifacts, then ``set_pad_rules``)
_PAD_RULES: Optional[Dict[str, List[dict]]] = None
#: False while no table or pad rule applies to a platform of this host:
#: ``select_k`` then takes the default crossovers, parsed once, and pads
#: nothing
_INSTALLED = False


def _sorted_bands(table: dict) -> List[Tuple[float, int]]:
    return sorted((float(km) if km != "inf" else float("inf"), w)
                  for km, w in table.items())


_DEFAULT_BANDS = _sorted_bands(_DEFAULT_TABLE)


def _load_auto_table() -> Dict[str, dict]:
    global _AUTO_TABLES
    if _AUTO_TABLES is None:
        _AUTO_TABLES = _scan_artifacts(
            {"default": dict(_DEFAULT_TABLE)}, "SELECT_K_TABLE",
            "RAFT_TPU_TORCH_SELECTK_TABLE", lambda art: art["crossovers"])
        _note_installed()
    return _AUTO_TABLES


def _load_pad_rules() -> Dict[str, List[dict]]:
    global _PAD_RULES
    if _PAD_RULES is None:
        _PAD_RULES = _scan_artifacts(
            {}, "TOPK_PAD", "RAFT_TPU_TORCH_TOPK_PAD",
            lambda art: [dict(r) for r in art["pad_rules"]])
        _note_installed()
    return _PAD_RULES


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _host_platforms() -> set:
    """The platform keys a tensor of this process can carry."""
    keys = {"cpu"}
    if torch.cuda.is_available():
        keys.update(_card_name(i) for i in range(torch.cuda.device_count()))
    return keys


def _note_installed() -> None:
    global _INSTALLED
    if _AUTO_TABLES is None or _PAD_RULES is None:
        return
    host = _host_platforms()
    _INSTALLED = any(p in host for p in _PAD_RULES) or any(
        p in host for p in _AUTO_TABLES if p != "default") or \
        _AUTO_TABLES["default"] != _DEFAULT_TABLE


def platform_key(device=None) -> str:
    """The tables' key for a device: the card's name on CUDA, ``"cpu"``
    elsewhere; with no device, the current card when there is one. A CUDA
    device on a host without a card keys as ``"cuda"``."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cuda"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _card_name(index)


def set_auto_table(platform: str, crossovers: Optional[dict]) -> None:
    """Install (or with None, drop) a platform's crossover table:
    ``{"<k_max>"|"inf": min_two_phase_width}``, or the nested form
    ``{"two_phase": {...}, "screen": {...}}``."""
    tables = _load_auto_table()
    if crossovers is None:
        tables.pop(platform, None)
        tables.setdefault("default", dict(_DEFAULT_TABLE))
    else:
        tables[platform] = dict(crossovers)
    _load_pad_rules()
    _note_installed()


def set_pad_rules(platform: str, rules: Optional[list]) -> None:
    """Install (or with None, drop) a platform's k-pad rules:
    ``[{"n": width, "k": requested_k, "k_pad": padded_k}, ...]``."""
    rules_by = _load_pad_rules()
    if rules is None:
        rules_by.pop(platform, None)
    else:
        rules_by[platform] = [dict(r) for r in rules]
    _load_auto_table()
    _note_installed()


def _band(table: dict, k: int) -> Optional[int]:
    """Width threshold of the smallest k-band covering ``k``."""
    for k_max, width in _sorted_bands(table):
        if k <= k_max:
            return width
    return None


def _pad_k(n: int, k: int, platform: str) -> int:
    """The k to select at row width n: the platform's rule for this k whose
    width is nearest within ×1.25, else k."""
    best = None
    for r in _load_pad_rules().get(platform, []):
        if r["k"] != k:
            continue
        ratio = max(n, r["n"]) / max(1, min(n, r["n"]))
        if ratio <= 1.25 and (best is None or ratio < best[0]):
            best = (ratio, r["k_pad"])
    return min(n, best[1]) if best else k


def _resolve_auto(n: int, k: int, floating: bool = True,
                  platform: Optional[str] = None) -> SelectAlgo:
    tables = _load_auto_table()
    table = tables.get(platform or platform_key(), tables["default"])
    nested = "screen" in table or "two_phase" in table
    screen_tab = table.get("screen")
    tp_tab = table.get("two_phase", {}) if nested else table
    if k * 4 > n:
        return SelectAlgo.DIRECT
    if screen_tab and floating:
        band = _band(screen_tab, k)
        if band is not None and n >= band:
            return SelectAlgo.SCREEN
    band = _band(tp_tab, k)
    if band is None or n < band:
        return SelectAlgo.DIRECT
    return SelectAlgo.TWO_PHASE


def _resolve_default(n: int, k: int) -> SelectAlgo:
    """``_resolve_auto`` over the default table, with no table installed."""
    if k * 4 <= n:
        for k_max, width in _DEFAULT_BANDS:
            if k <= k_max:
                return SelectAlgo.TWO_PHASE if n >= width \
                    else SelectAlgo.DIRECT
    return SelectAlgo.DIRECT


def _order_keys(values: torch.Tensor, select_min: bool) -> torch.Tensor:
    """int64 keys whose descending order is ``lax.top_k``'s order of the
    values to select: IEEE total order for floats (NaN above +inf, -0.0
    below +0.0), negated first for ``select_min`` as the JAX package does."""
    if values.dtype.is_floating_point:
        v = values.to(torch.float32)
        # in place on a fresh copy: the keys of a [rows, n] tile take one
        # int32 and one int64 tile beside the values, not five
        bits = (-v if select_min else v.clone()).view(torch.int32)
        sign = bits >> 31
        sign &= 0x7FFFFFFF
        bits ^= sign
        del sign
        return bits.to(torch.int64)
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
    composite = key  # a fresh int64 tile: shifted and merged in place
    composite <<= 32
    composite |= (n - 1 - pos)[None, :]
    top = torch.topk(composite, k, dim=1, largest=True, sorted=True).values
    sel = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(values, 1, sel), sel


def _direct(values: torch.Tensor, k: int, select_min: bool,
            k_pad: int = 0):
    # exact: the first k of a larger selection are the selection of k
    v, i = topk_lowest_first(values, min(values.shape[-1], max(k, k_pad)),
                             select_min)
    return v[:, :k], i[:, :k].to(torch.int32)


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
             algo: SelectAlgo = SelectAlgo.AUTO,
             recall_target: float = 0.95, pad_rules: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest (or largest) entries per row of values
    [batch, len] → ``(values [batch, k], positions [batch, k] int32)``.
    With ``indices`` the positions are relabelled through it, keeping -1
    null markers. Every algorithm here is exact, so ``recall_target``
    (APPROX's in the JAX package) changes nothing; ``pad_rules=False``
    skips the platform's k-pad rules."""
    values = torch.as_tensor(values)
    if values.dim() == 1:
        v, i = select_k(values[None], k, select_min, None, algo,
                        recall_target, pad_rules)
        v, i = v[0], i[0]
        if indices is not None:
            idx = torch.as_tensor(indices, device=values.device)
            i = torch.where(i < 0, -1, idx[i.clamp_min(0).long()].to(torch.int32))
        return v, i
    if k > values.shape[-1]:
        raise ValueError(f"k={k} > row length {values.shape[-1]}")
    k_pad = 0
    if _AUTO_TABLES is None or _PAD_RULES is None:
        _load_auto_table()
        _load_pad_rules()
    if not _INSTALLED:
        if algo == SelectAlgo.AUTO:
            algo = _resolve_default(values.shape[-1], int(k))
    else:
        platform = platform_key(values.device)
        if algo == SelectAlgo.AUTO:
            algo = _resolve_auto(values.shape[-1], int(k),
                                 values.dtype.is_floating_point, platform)
        if pad_rules and algo in (SelectAlgo.DIRECT, SelectAlgo.SCREEN):
            k_pad = _pad_k(values.shape[-1], int(k), platform)
    # capture-only explain note (never the dispatch counter): the resolved
    # algorithm rides the record of the search that selects here
    obs_explain.note_select_k(values.shape[-1], int(k), algo.name, k_pad)
    if algo == SelectAlgo.PALLAS:
        v, out_i = gk.streaming_select_k(values.to(torch.float32).contiguous(),
                                         int(k), bool(select_min))
        out_v = v.to(values.dtype)
    elif algo == SelectAlgo.TWO_PHASE:
        out_v, out_i = _two_phase(values, int(k), bool(select_min))
    else:  # DIRECT, and the exact stand-ins for APPROX and SCREEN
        out_v, out_i = _direct(values, int(k), bool(select_min), k_pad)
    if indices is not None:
        relabeled = torch.gather(torch.as_tensor(indices, device=values.device),
                                 1, out_i.clamp_min(0).long())
        out_i = torch.where(out_i < 0, -1, relabeled.to(torch.int32))
    return out_v, out_i


def select_k_filtered(values, k: int, ids, filter_words,
                      select_min: bool = True,
                      algo: SelectAlgo = SelectAlgo.AUTO,
                      recall_target: float = 0.95, pad_rules: bool = True):
    """``select_k`` over candidates ``values`` [batch, len] labelled by
    ``ids`` ([batch, len], or [len] for every row; -1 marks padding) with a
    bitset filter folded in: an id whose bit in ``filter_words`` is clear is
    never selected. Returns ``(values [batch, k], ids [batch, k],
    n_filtered)``, ``n_filtered`` a 0-d int32 tensor: the live candidates
    (valid id, finite value) that the filter removed."""
    values = torch.as_tensor(values)
    ids = torch.as_tensor(ids, device=values.device)
    if ids.dim() == values.dim() - 1:
        ids = ids[None, :].expand(values.shape)
    valid = ids >= 0
    if values.dtype.is_floating_point:
        valid = valid & torch.isfinite(values)
    allowed = filter_mask(ids, torch.as_tensor(filter_words,
                                               device=values.device))
    n_filtered = (valid & ~allowed).sum().to(torch.int32)
    keep = valid & allowed
    sentinel = torch.inf if select_min else -torch.inf
    v, i = select_k(torch.where(keep, values, sentinel), k, select_min,
                    indices=torch.where(keep, ids, -1), algo=algo,
                    recall_target=recall_target, pad_rules=pad_rules)
    return v, i, n_filtered


def select_k_plan(n: int, k: int, floating: bool = True,
                  pad_rules: bool = True, device=None) -> dict:
    """What ``select_k`` would resolve to for rows of n values at this k on
    ``device``'s platform (``platform_key``), without running it:
    ``{"algo", "k_pad"}``."""
    platform = platform_key(device)
    algo = _resolve_auto(int(n), int(k), bool(floating), platform)
    k_pad = _pad_k(int(n), int(k), platform) if pad_rules and algo in (
        SelectAlgo.DIRECT, SelectAlgo.SCREEN) else 0
    return {"algo": algo.name, "k_pad": int(k_pad)}


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
