"""Brute-force (exact) k-nearest neighbours.

Counterpart of ``raft_tpu.neighbors.brute_force``. ``build`` stores the
dataset and its squared norms on the device. ``search`` takes the fused
scan + top-k kernel (``ops.gpu_kernels.fused_l2_topk``) for every request it
serves: L2 or L2Sqrt, no filter, no fast scan, k <= 1024. Other requests
take the tiled path: a distance tile per (query tile, database tile), a
``select_k`` per tile, and one more ``select_k`` over the tiles' survivors.
``scan_mode="xla"`` keeps its name from the JAX package and forces the
tiled path. Every search records its engine and why
(``obs.explain.record_dispatch``; ``explain=True`` returns the record).
``serialize``/``deserialize`` write and read the JAX package's file format.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.bitset import filter_mask
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops.distance import (PORTED_METRICS, DistanceType,
                                         cosine_expanded, is_min_close,
                                         l2_expanded, pairwise_core,
                                         resolve_metric, row_norms_sq)
from raft_tpu_torch.ops.select_k import select_k, select_k_maybe_approx
from raft_tpu_torch.utils.shape import (as_query_array, balanced_tile,
                                        query_bucket)


class Index:
    """Dataset and cached squared norms on one device."""

    def __init__(self, dataset: torch.Tensor, metric: DistanceType,
                 metric_arg: float, norms: Optional[torch.Tensor] = None):
        self.dataset = dataset
        self.metric = metric
        self.metric_arg = metric_arg
        self.norms = norms

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dataset.device


@tracing.range("brute_force.build")
def build(dataset, metric="euclidean", metric_arg: float = 2.0,
          res: Optional[Resources] = None, device=None) -> Index:
    """Store the dataset (on CUDA unless ``device="cpu"``) and its squared
    norms for the expanded metrics."""
    res = ensure_resources(res, device)
    m = resolve_metric(metric)
    if m not in PORTED_METRICS:
        raise NotImplementedError(
            f"metric {m.name} is not ported to raft_tpu_torch yet "
            "(ROADMAP Queue A item 14: the remaining dense metrics)")
    dataset = as_query_array(dataset, res.device)
    norms = None
    if m in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
             DistanceType.CosineExpanded):
        norms = row_norms_sq(dataset)
    return Index(dataset, m, float(metric_arg), norms)


def _choose_tiles(n_queries: int, n_db: int, dim: int, k: int, budget: int
                  ) -> Tuple[int, int]:
    """(query_tile, db_tile) so that the tiled path's distance tiles fit the
    workspace budget (five fp32 tiles of the expanded-L2 chain, after one
    dataset-sized copy)."""
    q_tile = balanced_tile(n_queries, min(n_queries, 1024), 8)
    pad_copy = n_db * dim * 4
    avail = max(budget - pad_copy, budget // 4)
    db_budget = max(avail // (5 * max(q_tile, 1) * 4), 1)
    db_tile = min(n_db, max(db_budget, 4 * k, 1024))
    return q_tile, balanced_tile(n_db, db_tile, 128)


def _knn_tiled(queries, index: Index, filter_words, k: int, q_tile: int,
               db_tile: int, select_recall: float):
    metric = index.metric
    minimize = is_min_close(metric)
    bad_fill = torch.inf if minimize else -torch.inf
    dataset, ndb = index.dataset, index.size
    use_norms = index.norms is not None
    out_v, out_i = [], []
    for qs in range(0, queries.shape[0], q_tile):
        qt = queries[qs:qs + q_tile]
        qn = row_norms_sq(qt) if use_norms else None
        tile_v, tile_i = [], []
        for t0 in range(0, ndb, db_tile):
            db_t = dataset[t0:t0 + db_tile]
            if metric == DistanceType.CosineExpanded:
                d = cosine_expanded(qt, db_t, qn, index.norms[t0:t0 + db_tile])
            elif use_norms:
                d = l2_expanded(qt, db_t,
                                sqrt=metric == DistanceType.L2SqrtExpanded,
                                x_norms=qn,
                                y_norms=index.norms[t0:t0 + db_tile])
            else:
                d = pairwise_core(qt, db_t, metric)
            if filter_words is not None:
                ids = torch.arange(t0, t0 + db_t.shape[0], device=d.device)
                d = torch.where(filter_mask(ids, filter_words)[None, :], d,
                                bad_fill)
            v, i = select_k_maybe_approx(d, min(k, db_t.shape[0]), minimize,
                                         select_recall)
            tile_v.append(v)
            tile_i.append(i + t0)
        all_v, all_i = torch.cat(tile_v, dim=1), torch.cat(tile_i, dim=1)
        v, sel = select_k(all_v, k, select_min=minimize)
        out_v.append(v)
        out_i.append(torch.gather(all_i, 1, sel.long()))
    return torch.cat(out_v), torch.cat(out_i)


#: metrics the fused scan + top-k kernel serves exactly
_FUSED_SCAN_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded)


def fused_ineligible_reason(metric, dtype: torch.dtype, k: int,
                            has_filter: bool, fast_scan: bool,
                            require_float: bool = True) -> Optional[str]:
    """The first clause that keeps a request off the fused kernel, or None
    when it takes the kernel (shared by brute_force and ivf_flat, whose list
    data may also be narrow: ``require_float=False``)."""
    if metric not in _FUSED_SCAN_METRICS:
        return "non_l2"
    if has_filter:
        return "filtered"
    if fast_scan:
        return "fast_scan"
    if k > gk.MAX_K:
        return "k_gt_1024"
    if require_float and not dtype.is_floating_point:
        return "non_float_dtype"
    return None


def _check_deferred(scan_dtype) -> None:
    if scan_dtype is not None:
        raise NotImplementedError(
            "the bf16 fast scan (scan_dtype) is not ported yet (ROADMAP)")


def fused_dispatch_reason(scan_mode: str) -> str:
    """The reason code of a search that took its fused kernel: "forced"
    when ``scan_mode`` named it, "auto_fused" under "auto"."""
    return "auto_fused" if scan_mode == "auto" else "forced"


def kernel_plan(device: torch.device, kernel: str) -> dict:
    """The explain plan of a fused engine: the kernel and its route, the
    hand-written CUDA kernel on the card ("cuda") or its plain PyTorch
    version on the CPU ("plain")."""
    return {"kernel": kernel,
            "route": "cuda" if device.type == "cuda" else "plain"}


def explained(result, cap, explain: bool):
    """``result`` plus the capture's record when ``explain`` is set."""
    return (*result, cap.last) if explain else result


@tracing.range("brute_force.search")
def search(index: Index, queries, k: int, filter=None,
           res: Optional[Resources] = None, scan_dtype=None,
           select_recall: float = 1.0, scan_mode: str = "auto",
           explain: bool = False):
    """Exact kNN → ``(distances [nq, k] f32, ids [nq, k] i32)``.

    ``filter`` is an optional :class:`~raft_tpu_torch.core.bitset.Bitset`
    over dataset rows; cleared rows are never returned. ``scan_mode``:
    ``"auto"`` and ``"pallas"`` take the fused kernel for every eligible
    request, ``"xla"`` forces the tiled path. The search runs on the index's
    device. ``explain=True`` returns ``(distances, ids, ExplainRecord)``.
    """
    _check_deferred(scan_dtype)
    if scan_mode not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"scan_mode={scan_mode!r}: expected 'auto', 'xla' or 'pallas'")
    res = ensure_resources(res, index.device)
    queries = as_query_array(queries, index.device, index.dataset.dtype)
    if queries.shape[1] != index.dim:
        raise ValueError(
            f"query dim {queries.shape[1]} != index dim {index.dim}")
    k = int(min(k, index.size))
    nq = queries.shape[0]
    ineligible = fused_ineligible_reason(
        index.metric, index.dataset.dtype, k, filter is not None, False)
    ex_params = {"k": k, "nq": nq, "bucket": query_bucket(nq),
                 "n_db": index.size, "dim": index.dim,
                 "metric": index.metric.name}
    with contextlib.ExitStack() as stack:
        cap = stack.enter_context(obs_explain.capture()) if explain else None
        if scan_mode != "xla" and ineligible is None:
            obs_explain.record_dispatch(
                "brute_force", scan_mode, "pallas",
                fused_dispatch_reason(scan_mode), params=ex_params,
                plan=kernel_plan(index.device, "fused_l2_topk"))
            x = queries.to(torch.float32)
            y = index.dataset.to(torch.float32)
            v, i = gk.fused_l2_topk(x, y, k, row_norms_sq(x), index.norms)
            if index.metric == DistanceType.L2SqrtExpanded:
                v = torch.sqrt(torch.clamp_min(v, 0.0))
        else:
            q_tile, db_tile = _choose_tiles(nq, index.size, index.dim, k,
                                            res.workspace_limit_bytes)
            obs_explain.record_dispatch(
                "brute_force", scan_mode, "xla",
                "forced" if scan_mode == "xla" else ineligible,
                params=ex_params, plan={"q_tile": q_tile, "db_tile": db_tile})
            words = filter.words.to(index.device) if filter is not None \
                else None
            v, i = _knn_tiled(queries, index, words, k, q_tile, db_tile,
                              float(select_recall))
    return explained((v, i), cap, explain)


@tracing.range("brute_force.knn")
def knn(queries, dataset, k: int, metric="euclidean", metric_arg: float = 2.0,
        res: Optional[Resources] = None, scan_dtype=None,
        select_recall: float = 1.0, scan_mode: str = "auto",
        explain: bool = False, device=None):
    """One-shot exact kNN: ``search(build(dataset), queries, k)``."""
    return search(build(dataset, metric, metric_arg, res, device), queries, k,
                  res=res, scan_dtype=scan_dtype, select_recall=select_recall,
                  scan_mode=scan_mode, explain=explain)


_SERIAL_VERSION = 1


def serialize(index: Index, file) -> None:
    """Write the index to a path (atomically: a temporary file, then
    ``os.replace``) or a binary stream, in the JAX package's format: the
    metric, its argument, the dataset and the cached norms, each record
    crc-framed."""
    with ser.writer_for(file) as stream:
        w = ser.IndexWriter(stream, "brute_force", _SERIAL_VERSION)
        w.scalar(int(index.metric), "<i4").scalar(index.metric_arg, "<f8")
        w.array(index.dataset)
        w.scalar(1 if index.norms is not None else 0, "<i4")
        if index.norms is not None:
            w.array(index.norms)
        w.finish()


def deserialize(file, res: Optional[Resources] = None, device=None) -> Index:
    """Read an index written by :func:`serialize` (or by the JAX package)
    onto ``res``'s device (CUDA unless the caller asks for the CPU)."""
    res = ensure_resources(res, device)
    with ser.reader_for(file) as stream:
        r = ser.IndexReader(stream, "brute_force", _SERIAL_VERSION)
        metric = DistanceType(r.scalar())
        metric_arg = r.scalar()
        dataset = ser.to_tensor(r.array(), res.device)
        norms = ser.to_tensor(r.array(), res.device) if r.scalar() else None
        r.finish()
    return Index(dataset, metric, float(metric_arg), norms)
