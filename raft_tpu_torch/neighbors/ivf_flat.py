"""IVF-Flat — inverted-file index over raw vectors.

Counterpart of ``raft_tpu.neighbors.ivf_flat``, with its layout: lists are
padded dense ``[n_lists, list_pad, dim]`` storage with int32 row ids (-1 at
unfilled slots), capped by ``list_pad_expansion``; rows spilled from hot
lists live in an overflow block that every query scans.

Build: balanced k-means on a trainset subsample, then ``extend``: predict
labels and pack the lists (host-side numpy for a fresh index, a device
scatter when appending).

List rows are float32, bfloat16, float16, int8 or uint8 (BIGANN's and
SPACEV's uint8 and int8 rows take a quarter of float32's memory); the
kernels read them as they are and compute in fp32, and every value of the
narrow types is exact there.

Search: coarse scores (queries × centers, one fp32 matrix product) and a
``select_k`` pick the probed lists. Eligible requests (L2/L2Sqrt, no
filter, no fast scan, k <= 1024) then take the fused kernel
(``ops.gpu_kernels.fused_ivf_topk``), which scans the probed slabs and keeps
each query's top-k without writing the candidates out; the overflow block
is scanned by a matrix product and merged by one ``select_k``. Other
requests (filtered, inner product, cosine, k > 1024) take the tiled path:
per query tile the coarse selection, the probed slots' partial distances
``‖row‖² − 2·q·row`` by the unfused scan kernel (``ops.gpu_kernels.ivf_scan``,
which reads each probed slab where it lies), the metric's distances from
them, and one ``select_k``. Under ``scan_mode="auto"`` each kernel serves
on the card only where the probe's verdict says it wins
(``ops.gpu_kernels.fused_dispatch_explained``; the gather stands in for a
losing scan kernel). ``scan_mode="xla"`` forces the tiled path with
the gather of the probed lists per query tile in place of the scan kernel.
The bf16 fast scan (``scan_dtype="bfloat16"``, float32 lists) takes the
tiled path with the gather: the probed slots' bf16 screen
(``ops.distance.gathered_dot_bf16``) keeps ``refine_ratio·k`` candidates,
which are re-ranked exactly in fp32; neither kernel serves it, as in the
JAX package.

Every search records its engine and why (``obs.explain.record_dispatch``;
``explain=True`` returns the record). ``serialize``/``deserialize`` write
and read the JAX package's file format; ``helpers`` reads and rewrites one
list.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.bitset import filter_mask as bitset_filter_mask
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.neighbors import list_packing
from raft_tpu_torch.neighbors.brute_force import (
    explained, fast_scan_requested, fused_route,
    fused_ineligible_reason, kernel_plan)
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops import rng as rrng
from raft_tpu_torch.ops.distance import (DistanceType, dot_bf16, dot_fp32,
                                         gathered_distances,
                                         gathered_dot_bf16, resolve_metric,
                                         row_norms_sq)
from raft_tpu_torch.ops.select_k import (SelectAlgo, refine_multiplier,
                                         select_k, select_k_maybe_approx)
from raft_tpu_torch.utils.shape import as_query_array, query_bucket


@dataclasses.dataclass
class IndexParams:
    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False
    add_data_on_build: bool = True
    # list capacity is capped so that L·pad plus the overflow block stays
    # within this multiple of the row count
    list_pad_expansion: float = 1.5

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if self.list_pad_expansion < 1.0:
            raise ValueError(
                f"list_pad_expansion must be >= 1.0, got "
                f"{self.list_pad_expansion}")


@dataclasses.dataclass
class SearchParams:
    """``scan_mode``: ``"pallas"`` takes the fused kernel for every
    eligible request and the scan kernel for the others; ``"auto"`` takes
    each where its measured verdict says it wins on the card (always on
    the CPU); ``"xla"`` forces the tiled path with its gather.
    ``select_recall`` < 1 asks for approximate selection, which the port
    answers exactly. ``scan_dtype="bfloat16"`` (float32 lists) asks for the
    bf16 fast scan, which re-ranks ``refine_ratio·k`` candidates a query
    exactly in fp32; a wider ratio buys recall where bf16's rounding of the
    inputs pushes true neighbours out of the screen."""

    n_probes: int = 20
    scan_dtype: Optional[object] = None
    refine_ratio: float = 4.0
    scan_mode: str = "auto"
    select_recall: float = 1.0


class Index:
    """Centers, padded lists, their ids and sizes, and the overflow block,
    all on one device."""

    def __init__(self, params: IndexParams, centers, list_data, list_indices,
                 list_sizes, n_rows: int, overflow_data=None,
                 overflow_indices=None):
        self.params = params
        self.centers = centers  # [n_lists, dim] fp32
        self.list_data = list_data  # [n_lists, list_pad, dim]
        self.list_indices = list_indices  # [n_lists, list_pad] int32, -1 pad
        self.list_sizes = list_sizes  # [n_lists] int32
        self.n_rows = int(n_rows)
        dev = centers.device
        dt = list_data.dtype if list_data is not None else torch.float32
        self.overflow_data = (overflow_data if overflow_data is not None
                              else torch.zeros((0, self.dim), dtype=dt,
                                               device=dev))
        self.overflow_indices = (
            overflow_indices if overflow_indices is not None
            else torch.zeros((0,), dtype=torch.int32, device=dev))
        self._row_norms = None
        self._safe_ids = None

    def ensure_row_norms(self) -> torch.Tensor:
        """Squared norms of every list slot, [n_lists, list_pad] fp32."""
        if self._row_norms is None:
            self._row_norms = row_norms_sq(self.list_data).contiguous()
        return self._row_norms

    def safe_ids(self) -> torch.Tensor:
        """List ids with -1 at every slot past the list's size, so that a
        stale slot can never alias a real row in the kernel."""
        if self._safe_ids is None:
            pad = self.list_data.shape[1]
            valid = (torch.arange(pad, device=self.device)[None, :]
                     < self.list_sizes[:, None])
            self._safe_ids = torch.where(valid, self.list_indices,
                                         -1).to(torch.int32).contiguous()
        return self._safe_ids

    @property
    def metric(self) -> DistanceType:
        return self.params.metric

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def size(self) -> int:
        return self.n_rows

    @property
    def device(self) -> torch.device:
        return self.centers.device


def _as_rows(x, device: torch.device) -> torch.Tensor:
    """Rows for the lists on ``device``: float64 becomes float32 (as a JAX
    array without 64-bit types does); a type the IVF kernels cannot read
    raises."""
    x = _as_tensor(x, device)
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    if x.dtype not in gk.ROW_TYPES:
        raise TypeError(f"ivf_flat list rows must be one of "
                        f"{sorted(str(t) for t in gk.ROW_TYPES)}, got "
                        f"{x.dtype}")
    return x


def _pack_lists(dataset: np.ndarray, labels: np.ndarray, n_lists: int,
                ids: np.ndarray, max_expansion: float):
    """Pack rows into capped padded storage on the host; rows past a hot
    list's cap spill to the returned overflow block.
    Returns (data, idxs, sizes, overflow_rows, overflow_ids)."""
    sizes = np.bincount(labels, minlength=n_lists).astype(np.int32)
    pad = list_packing.choose_list_pad(sizes, max_expansion)
    if int(sizes.max(initial=0)) <= pad:
        data, idxs, sizes = native.pack_lists_numpy(dataset, labels,
                                                    n_lists, pad, ids)
        return data, idxs, sizes, *list_packing.pad_overflow_block(
            dataset[:0], ids[:0])
    keep = list_packing.fit_mask(labels, n_lists, pad)
    data, idxs, sizes = native.pack_lists_numpy(
        np.ascontiguousarray(dataset[keep]), labels[keep], n_lists, pad,
        np.ascontiguousarray(ids[keep]))
    over_rows, over_ids = list_packing.pad_overflow_block(
        np.ascontiguousarray(dataset[~keep]),
        np.ascontiguousarray(ids[~keep]))
    return data, idxs, sizes, over_rows, over_ids


def _as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A device tensor from a tensor or a host array; ``dtype=bfloat16``
    reinterprets the int16 host view that ``_host`` makes of bf16 rows."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
        if dtype == torch.bfloat16:
            x = x.view(torch.bfloat16)
    return x.to(device).contiguous()


def _host(t: torch.Tensor) -> np.ndarray:
    """Host copy of rows for the numpy packer (bf16 as its int16 bits)."""
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@tracing.range("ivf_flat.build")
def build(dataset, params: Optional[IndexParams] = None,
          res: Optional[Resources] = None, device=None) -> Index:
    """Train the coarse quantizer on a subsample and (by default) add the
    dataset. Runs on CUDA unless ``device="cpu"`` (or ``res``) says
    otherwise."""
    params = params or IndexParams()
    res = ensure_resources(res, device)
    dataset = _as_rows(dataset, res.device)
    n_rows = dataset.shape[0]
    if params.n_lists > n_rows:
        raise ValueError(f"n_lists={params.n_lists} > n_rows={n_rows}")
    n_train = max(int(n_rows * params.kmeans_trainset_fraction),
                  params.n_lists)
    n_train = min(n_train, n_rows)
    trainset = rrng.subsample_rows(res.generator, dataset, n_train)
    km_params = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                                     metric=params.metric)
    centers = kmeans_balanced.fit(res.generator, trainset, params.n_lists,
                                  km_params)
    index = Index(params, centers, None, None, None, 0)
    if params.add_data_on_build:
        index = extend(index, dataset, res=res)
    return index


@tracing.range("ivf_flat.extend")
def extend(index: Index, new_vectors, new_indices=None,
           res: Optional[Resources] = None) -> Index:
    """Add vectors (with ids, or ids past every existing one) on the index's
    device and return the new index; ``adaptive_centers`` recomputes the
    centers as list means. The rows are labelled as given and stored in the
    index's row type. ``res``, when given, must be on the index's
    device."""
    dev = index.device
    if res is not None:
        ensure_resources(res, dev)
    new_vectors = _as_rows(new_vectors, dev)
    km_params = KMeansBalancedParams(metric=index.metric)
    labels = kmeans_balanced.predict(index.centers, new_vectors,
                                     km_params).cpu().numpy()
    if index.list_data is not None:
        new_vectors = new_vectors.to(index.list_data.dtype)
    new_np = _host(new_vectors)
    dt = new_vectors.dtype
    if new_indices is None:
        base = index.n_rows
        if index.list_indices is not None:
            base = max(base, int(index.list_indices.max()) + 1)
        if index.overflow_indices.shape[0]:
            base = max(base, int(index.overflow_indices.max()) + 1)
        new_ids = np.arange(base, base + len(new_np), dtype=np.int32)
    else:
        new_ids = np.asarray(torch.as_tensor(new_indices).cpu(), np.int32)

    if index.list_data is None:
        data, idxs, sizes, over_rows, over_ids = _pack_lists(
            new_np, labels, index.n_lists, new_ids,
            index.params.list_pad_expansion)
        data, idxs, sizes = (_as_tensor(data, dev, dt), _as_tensor(idxs, dev),
                             _as_tensor(sizes, dev))
        over_rows = _as_tensor(over_rows, dev, dt)
        over_ids = _as_tensor(over_ids, dev)
    else:
        # grow the pad (capped) if needed, then scatter the batch after each
        # list's tail on the device; rows past a hot list's cap spill
        old_sizes = index.list_sizes.cpu().numpy()
        counts = np.bincount(labels, minlength=index.n_lists)
        n_over_old = int((index.overflow_indices >= 0).sum())
        cap = max(list_packing.choose_list_pad(
            old_sizes + counts, index.params.list_pad_expansion),
            index.list_data.shape[1])
        keep = list_packing.fit_mask(labels, index.n_lists, cap,
                                     sizes=old_sizes)
        data, idxs = list_packing.grow_pad(
            index.list_data, index.list_indices,
            int((old_sizes + np.bincount(labels[keep],
                                         minlength=index.n_lists)).max()))
        keep_t = torch.from_numpy(keep).to(dev)
        data, idxs, sizes = list_packing.append_lists(
            data, idxs, index.list_sizes, new_vectors[keep_t],
            _as_tensor(new_ids[keep], dev),
            _as_tensor(labels[keep].astype(np.int64), dev), index.n_lists)
        over_rows, over_ids = _merge_overflow(
            index.overflow_data, index.overflow_indices, n_over_old,
            new_np[~keep], new_ids[~keep])
    centers = index.centers
    if index.params.adaptive_centers:
        dsum = data.to(torch.float32).sum(dim=1)
        centers = dsum / torch.clamp_min(sizes.to(torch.float32), 1.0)[:, None]
    return Index(index.params, centers, data, idxs, sizes,
                 index.n_rows + len(new_np), over_rows, over_ids)


def _merge_overflow(old_rows, old_ids, n_old_valid: int, new_rows_np,
                    new_ids_np):
    """Append spilled rows to the overflow block (8-aligned); valid rows
    are compacted first."""
    if len(new_rows_np) == 0:
        return old_rows, old_ids
    merged_rows = np.concatenate([_host(old_rows[:n_old_valid]), new_rows_np],
                                 axis=0)
    merged_ids = np.concatenate(
        [old_ids[:n_old_valid].cpu().numpy(),
         np.asarray(new_ids_np, np.int32)])
    rows, ids = list_packing.pad_overflow_block(merged_rows, merged_ids)
    dev = old_rows.device
    return _as_tensor(rows, dev, old_rows.dtype), _as_tensor(ids, dev)


def _coarse_scores(queries, centers, metric: DistanceType):
    """(scores [nq, n_lists], select_min) for the coarse probe selection."""
    dots = dot_fp32(queries, centers)
    if metric == DistanceType.InnerProduct:
        return dots, False
    if metric == DistanceType.CosineExpanded:
        cn = torch.sqrt(torch.clamp_min(row_norms_sq(centers), 1e-20))
        return dots / cn[None, :], False
    qn = row_norms_sq(queries)
    cn = row_norms_sq(centers)
    return (qn[:, None] + cn[None, :]) - 2.0 * dots, True


def _overflow_scan(qf, o_f32, o_norms, o_ok_base, overflow_indices,
                   filter_words, metric: DistanceType, bad_fill,
                   fast_scan: bool = False):
    """Distances of a query tile to every overflow row: ([t, O] distances,
    [t, O] ids, [t, O] validity), ready to join the final select_k; with
    ``fast_scan`` the product is the bf16 screen's."""
    dots = dot_bf16(qf, o_f32) if fast_scan else dot_fp32(qf, o_f32)
    if metric == DistanceType.InnerProduct:
        od = dots
    elif metric == DistanceType.CosineExpanded:
        on = torch.sqrt(torch.clamp_min(o_norms, 1e-20))
        qn = torch.sqrt(torch.clamp_min(row_norms_sq(qf), 1e-20))
        od = 1.0 - dots / (on[None, :] * qn[:, None])
    else:
        od = torch.clamp_min(
            (row_norms_sq(qf)[:, None] + o_norms[None, :]) - 2.0 * dots, 0.0)
        if metric == DistanceType.L2SqrtExpanded:
            od = torch.sqrt(od)
    ok = o_ok_base
    if filter_words is not None:
        ok = ok & bitset_filter_mask(overflow_indices, filter_words)
    od = torch.where(ok[None, :], od, bad_fill)
    shape = (qf.shape[0], overflow_indices.shape[0])
    return od, overflow_indices[None, :].expand(shape), ok[None, :].expand(shape)


def _search_core(queries, index: Index, filter_words, k: int, n_probes: int,
                 q_tile: int, select_recall: float = 1.0,
                 use_scan: bool = False, fast_scan: bool = False,
                 refine_mult: int = 1):
    """Tiled search: per query tile, score every probed slot and select over
    the probed slots plus the overflow block. With ``use_scan`` the slots'
    partials ``‖row‖² − 2·q·row`` come from ``gk.ivf_scan`` (the JAX
    package's ``use_pallas`` arithmetic), else from a gather of the probed
    lists [t, P, pad, dim] and one product. With ``fast_scan`` (which
    ``search`` never combines with ``use_scan``) that product is bf16 with
    the exact row norms, the best ``max(refine_mult·k, k + 8)`` candidates
    are kept, and their exact fp32 distances decide the top k."""
    metric = index.metric
    list_data, list_indices = index.list_data, index.list_indices
    list_pad = list_data.shape[1]
    minimize = metric != DistanceType.InnerProduct
    bad_fill = torch.inf if minimize else -torch.inf
    valid_slot = (torch.arange(list_pad, device=index.device)[None, :]
                  < index.list_sizes[:, None])
    has_overflow = index.overflow_data.shape[0] > 0
    if has_overflow:
        o_f32 = index.overflow_data.to(torch.float32)
        o_norms = row_norms_sq(o_f32)
        o_ok_base = index.overflow_indices >= 0
    out_v, out_i = [], []
    for qs in range(0, queries.shape[0], q_tile):
        qt = queries[qs:qs + q_tile]
        t = qt.shape[0]
        scores, coarse_min = _coarse_scores(qt, index.centers, metric)
        _, probes = select_k_maybe_approx(scores, n_probes, coarse_min,
                                          select_recall)
        probes = probes.long()
        g_idx = list_indices[probes]  # [t, P, pad]
        g_valid = valid_slot[probes]
        qf = qt.to(torch.float32)
        qn2 = row_norms_sq(qf)[:, None, None]
        is_l2 = metric in (DistanceType.L2Expanded,
                           DistanceType.L2SqrtExpanded)
        # each branch keeps its JAX counterpart's arithmetic: dots and the
        # L2 form come from the partials ‖v‖² − 2·q·v with the kernel, from
        # the product and ‖v‖² − 2·dots after the gather without it
        if use_scan:
            row_norms = index.ensure_row_norms()
            qv = qf[:, None, :].expand(t, n_probes, qf.shape[1]).contiguous()
            part = gk.ivf_scan(probes.to(torch.int32).contiguous(), qv,
                               list_data, row_norms)  # ‖v‖² − 2·q·v
            vn2 = row_norms[probes]
            dots = None if is_l2 else 0.5 * (vn2 - part)
            l2 = qn2 + part if is_l2 else None
        elif fast_scan:
            # the bf16 screen; the rows' norms stay exact fp32
            g_data = list_data[probes]  # [t, P, pad, dim]
            dots = gathered_dot_bf16(
                qt, g_data.reshape(t, n_probes * list_pad, -1)).reshape(
                    t, n_probes, list_pad)
            vn2 = (None if metric == DistanceType.InnerProduct
                   else index.ensure_row_norms()[probes])
            l2 = (qn2 + vn2) - 2.0 * dots if is_l2 else None
        else:
            g_data = list_data[probes].to(torch.float32)  # [t, P, pad, dim]
            dots = torch.einsum("td,tpld->tpl", qf, g_data)
            vn2 = (None if metric == DistanceType.InnerProduct
                   else (g_data * g_data).sum(-1))
            l2 = (qn2 + vn2) - 2.0 * dots if is_l2 else None
        if metric == DistanceType.InnerProduct:
            d = dots
        elif metric == DistanceType.CosineExpanded:
            vn = torch.sqrt(torch.clamp_min(vn2, 1e-20))
            qn = torch.sqrt(torch.clamp_min(qn2, 1e-20))
            d = 1.0 - dots / (vn * qn)
        else:
            d = torch.clamp_min(l2, 0.0)
            if metric == DistanceType.L2SqrtExpanded:
                d = torch.sqrt(d)
        ok = g_valid
        if filter_words is not None:
            ok = ok & bitset_filter_mask(g_idx, filter_words)
        d = torch.where(ok, d, bad_fill)
        n_main = n_probes * list_pad
        flat_d = d.reshape(t, n_main)
        flat_i = g_idx.reshape(t, n_main)
        flat_ok = ok.reshape(t, n_main)
        if has_overflow:
            od, oi, o_ok = _overflow_scan(qf, o_f32, o_norms, o_ok_base,
                                          index.overflow_indices,
                                          filter_words, metric, bad_fill,
                                          fast_scan)
            flat_d = torch.cat([flat_d, od], dim=1)
            flat_i = torch.cat([flat_i, oi], dim=1)
            flat_ok = torch.cat([flat_ok, o_ok], dim=1)
        kk = min(k, flat_d.shape[1])
        if fast_scan:
            # the exact fp32 re-rank of the screen's best, masked again by
            # the slots' validity (pad and filter) rather than by the
            # screen's value
            k_ref = min(max(refine_mult * k, k + 8), flat_d.shape[1])
            _, sel = select_k_maybe_approx(flat_d, k_ref, minimize,
                                           select_recall)
            sel = sel.long()
            cand_i = torch.gather(flat_i, 1, sel)
            cand_ok = torch.gather(flat_ok, 1, sel)
            cand_list = torch.gather(
                probes, 1, torch.clamp_max(sel // list_pad, n_probes - 1))
            cand_vecs = list_data[cand_list, sel % list_pad].to(torch.float32)
            if has_overflow:
                o_idx = torch.clamp(sel - n_main, 0, o_f32.shape[0] - 1)
                cand_vecs = torch.where((sel < n_main)[:, :, None],
                                        cand_vecs, o_f32[o_idx])
            exact = torch.where(cand_ok,
                                gathered_distances(qf, cand_vecs, metric),
                                bad_fill)
            v, sel2 = select_k(exact, kk, select_min=minimize)
            i_out = torch.gather(cand_i, 1, sel2.long())
        else:
            v, sel = select_k_maybe_approx(flat_d, kk, minimize,
                                           select_recall)
            i_out = torch.gather(flat_i, 1, sel.long())
        if kk < k:
            v = torch.cat([v, v.new_full((t, k - kk), bad_fill)], dim=1)
            i_out = torch.cat([i_out, i_out.new_full((t, k - kk), -1)], dim=1)
        out_v.append(v)
        out_i.append(i_out.to(torch.int32))
    return torch.cat(out_v), torch.cat(out_i)


def _search_fused_core(queries, index: Index, k: int, n_probes: int):
    """Fused search (L2 metrics): coarse selection by matrix product and
    ``select_k``, then ``fused_ivf_topk`` over the probed slabs; overflow
    rows are scanned in squared space and merged with the kernel's
    survivors by one ``select_k``."""
    nq, dim = queries.shape
    qf = queries.to(torch.float32)
    scores, coarse_min = _coarse_scores(qf, index.centers, index.metric)
    # the streaming select kernel picks the probes: at the coarse-probe
    # shape it beats torch.topk on the card (PERF.md)
    algo = SelectAlgo.PALLAS if n_probes <= gk.MAX_K else SelectAlgo.AUTO
    _, probes = select_k(scores, n_probes, select_min=coarse_min, algo=algo)
    qv = qf[:, None, :].expand(nq, n_probes, dim).contiguous()
    qn = row_norms_sq(qf)[:, None].expand(nq, n_probes).contiguous()
    v, i = gk.fused_ivf_topk(probes.contiguous(), qv, qn, index.list_data,
                             index.ensure_row_norms(), index.safe_ids(), k,
                             clamp=True)
    if index.overflow_data.shape[0] > 0:
        o_f32 = index.overflow_data.to(torch.float32)
        od, oi, _ = _overflow_scan(qf, o_f32, row_norms_sq(o_f32),
                                   index.overflow_indices >= 0,
                                   index.overflow_indices, None,
                                   DistanceType.L2Expanded, torch.inf)
        v, i = select_k(torch.cat([v, od], dim=1), k, select_min=True,
                        indices=torch.cat([i, oi], dim=1))
    if index.metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(torch.clamp_min(v, 0.0))
    return v, i


def scan_bytes_per_query(n_probes: int, list_pad: int, dim: int) -> int:
    """Peak bytes of the tiled scan per query: the gathered [P, pad, dim]
    fp32 tile, ×2 for the distance temporaries live with it."""
    return n_probes * list_pad * dim * 4 * 2


def plan_scan_tiles(n_probes: int, list_pad: int, dim: int,
                    workspace_limit_bytes: int) -> int:
    """Query tile of the tiled scan from the workspace budget."""
    per_q = scan_bytes_per_query(n_probes, list_pad, dim)
    q_tile = int(np.clip(workspace_limit_bytes // max(per_q, 1), 1, 1024))
    if q_tile >= 8:
        q_tile -= q_tile % 8
    return q_tile


def ivf_scan_routed(scan_mode: str, device: torch.device) -> bool:
    """Whether an unfused search scans through the ``ivf_scan`` kernel:
    always under ``"pallas"``, under ``"auto"`` where the measured
    ``ivf_scan`` verdict says it wins on the card (always on the CPU, its
    plain version), never under an explicitly named unfused engine."""
    if scan_mode == "pallas":
        return True
    return scan_mode == "auto" and gk.fused_crossover("ivf_scan", device)


@tracing.range("ivf_flat.search")
def search(index: Index, queries, k: int,
           params: Optional[SearchParams] = None,
           filter: Optional[Bitset] = None,
           res: Optional[Resources] = None, explain: bool = False):
    """Search → ``(distances [nq, k] f32, ids [nq, k] i32)``; ids are source
    row ids, -1 where fewer than k valid candidates were probed. Queries
    keep their type (the products are fp32 whatever the lists' row type),
    as in the JAX package, whose IVF-Flat does not cast them to the lists'
    type. Runs on the index's device. ``explain=True`` returns a third element, the
    search's ``ExplainRecord``."""
    params = params or SearchParams()
    if index.list_data is None:
        raise ValueError("index has no data; call extend() first")
    fast_scan = fast_scan_requested(params.scan_dtype)
    if fast_scan and index.list_data.dtype != torch.float32:
        raise ValueError("scan_dtype requires fp32 list data")
    if params.scan_mode not in ("auto", "xla", "pallas"):
        raise ValueError(f"scan_mode={params.scan_mode!r}: expected 'auto', "
                         "'xla' or 'pallas'")
    res = ensure_resources(res, index.device)
    queries = as_query_array(queries, index.device)
    if queries.shape[1] != index.dim:
        raise ValueError(
            f"query dim {queries.shape[1]} != index dim {index.dim}")
    n_probes = int(min(params.n_probes, index.n_lists))
    nq, list_pad = queries.shape[0], index.list_data.shape[1]
    scan_mode = params.scan_mode
    ineligible = fused_ineligible_reason(
        index.metric, index.list_data.dtype, int(k), filter is not None,
        fast_scan, require_float=False)
    ex_params = {"k": int(k), "nq": nq, "bucket": query_bucket(nq),
                 "n_probes": n_probes, "n_lists": index.n_lists,
                 "list_pad": list_pad, "dim": index.dim,
                 "metric": index.metric.name}
    use_fused, reason = fused_route("ivf_flat", scan_mode, ineligible,
                                    index.device)
    with contextlib.ExitStack() as stack:
        cap = stack.enter_context(obs_explain.capture()) if explain else None
        if use_fused:
            obs_explain.record_dispatch(
                "ivf_flat", scan_mode, "pallas", reason, params=ex_params,
                plan=kernel_plan(index.device, "fused_ivf_topk"))
            out = _search_fused_core(queries, index, int(k), n_probes)
        else:
            # the fast scan keeps off the scan kernel, as in the JAX package
            use_scan = not fast_scan and ivf_scan_routed(scan_mode,
                                                         index.device)
            q_tile = plan_scan_tiles(n_probes, list_pad, index.dim,
                                     res.workspace_limit_bytes)
            plan = {"q_tile": q_tile, "unfused_ivf_scan": use_scan,
                    "predicted_workspace_bytes": q_tile *
                    scan_bytes_per_query(n_probes, list_pad, index.dim)}
            if use_scan:
                plan.update(kernel_plan(index.device, "ivf_scan"))
            obs_explain.record_dispatch(
                "ivf_flat", scan_mode, "xla", reason,
                params=ex_params, plan=plan)
            words = filter.words.to(index.device) if filter is not None \
                else None
            out = _search_core(queries, index, words, int(k), n_probes,
                               q_tile, float(params.select_recall),
                               use_scan=use_scan, fast_scan=fast_scan,
                               refine_mult=refine_multiplier(
                                   params.refine_ratio, fast_scan))
    return explained(out, cap, explain)


_SERIAL_VERSION = 2  # v2: + list_pad_expansion, overflow block


def serialize(index: Index, file) -> None:
    """Write the index to a path (atomically) or a binary stream, in the
    JAX package's format (v2, crc-framed records): the build parameters,
    the centers, the padded lists with their ids and sizes, and the
    overflow block."""
    if index.list_data is None:
        raise ValueError("index has no data; call extend() before serialize()")
    with ser.writer_for(file) as stream:
        w = ser.IndexWriter(stream, "ivf_flat", _SERIAL_VERSION)
        w.scalar(int(index.metric), "<i4")
        w.scalar(index.params.n_lists, "<i8")
        w.scalar(index.params.kmeans_n_iters, "<i4")
        w.scalar(index.params.kmeans_trainset_fraction, "<f8")
        w.scalar(1 if index.params.adaptive_centers else 0, "<i4")
        w.scalar(index.params.list_pad_expansion, "<f8")
        w.scalar(index.n_rows, "<i8")
        w.array(index.centers)
        w.array(index.list_data)
        w.array(index.list_indices)
        w.array(index.list_sizes)
        w.array(index.overflow_data)
        w.array(index.overflow_indices)
        w.finish()


def deserialize(file, res: Optional[Resources] = None, device=None) -> Index:
    """Read an index written by :func:`serialize` or the JAX package (v1 or
    v2) onto ``res``'s device (CUDA unless the caller asks for the CPU)."""
    res = ensure_resources(res, device)
    dev = res.device
    with ser.reader_for(file) as stream:
        r = ser.IndexReader(stream, "ivf_flat", _SERIAL_VERSION)
        metric = DistanceType(r.scalar())
        params = IndexParams(
            n_lists=r.scalar(), metric=metric, kmeans_n_iters=r.scalar(),
            kmeans_trainset_fraction=r.scalar(),
            adaptive_centers=bool(r.scalar()),
            # v1 files predate the capped pad: max-driven layout, no spill
            list_pad_expansion=r.scalar() if r.version >= 2 else 1e30)
        n_rows = r.scalar()
        centers, data, idxs, sizes = (ser.to_tensor(r.array(), dev)
                                      for _ in range(4))
        over_rows = ser.to_tensor(r.array(), dev) if r.version >= 2 else None
        over_ids = ser.to_tensor(r.array(), dev) if r.version >= 2 else None
        r.finish()
    return Index(params, centers, data, idxs, sizes, n_rows, over_rows,
                 over_ids)


class helpers:
    """One list's rows and ids (the JAX package's ``ivf_flat.helpers``).
    The lists are padded dense blocks, so packing and unpacking place rows;
    the results are host arrays, and ``pack_list_data`` returns a new index
    on the old one's device."""

    @staticmethod
    def unpack_list_data(index: Index, label: int) -> np.ndarray:
        """The rows of list ``label``, [size, dim] in the index's row type
        (bfloat16 as its int16 bits)."""
        size = int(index.list_sizes[label])
        return _host(index.list_data[label, :size])

    @staticmethod
    def unpack_list_ids(index: Index, label: int) -> np.ndarray:
        size = int(index.list_sizes[label])
        return index.list_indices[label, :size].cpu().numpy()

    @staticmethod
    def pack_list_data(index: Index, label: int, vectors,
                       ids=None) -> Index:
        """A new index whose list ``label`` holds ``vectors`` (cast to the
        row type) and ``ids`` (kept from the old list where None), with the
        slots after them cleared (rows 0, ids -1); the overflow block is
        kept."""
        dev = index.device
        vectors = torch.as_tensor(np.asarray(vectors)).to(
            device=dev, dtype=index.list_data.dtype)
        n_new = vectors.shape[0]
        pad = index.list_data.shape[1]
        if n_new > pad:
            raise ValueError(f"{n_new} vectors exceed list capacity {pad}")
        data = index.list_data.clone()
        idxs = index.list_indices.clone()
        sizes = index.list_sizes.clone()
        data[label, :n_new] = vectors
        data[label, n_new:] = 0
        if ids is not None:
            idxs[label, :n_new] = torch.as_tensor(
                np.asarray(ids, np.int32)).to(dev)
        idxs[label, n_new:] = -1
        old = int(sizes[label])
        sizes[label] = n_new
        return Index(index.params, index.centers, data, idxs, sizes,
                     index.n_rows - old + n_new, index.overflow_data,
                     index.overflow_indices)
