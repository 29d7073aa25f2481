"""Brute-force (exact) k-nearest neighbours.

Counterpart of ``raft_tpu.neighbors.brute_force``. ``build`` stores the
dataset and its squared norms on the device. ``search`` takes the fused
scan + top-k kernel (``ops.gpu_kernels.fused_l2_topk``) for every request it
serves: L2 or L2Sqrt, no filter, no fast scan, k <= 1024. Other requests
take the tiled path: a distance tile per (query tile, database tile), a
``select_k`` per tile, and one more ``select_k`` over the tiles' survivors;
it serves every dense metric of ``ops.distance`` (L1, Linf, Minkowski with
``metric_arg`` as p, correlation, Canberra, Hamming, ...).
``scan_mode="xla"`` keeps its name from the JAX package and forces the
tiled path; under ``"auto"`` the kernel serves on the card only where the
measured verdict says it wins (``ops.gpu_kernels.fused_dispatch_explained``). The bf16 fast scan (``scan_dtype="bfloat16"``, an fp32
dataset) runs the tiled path's products in bf16 with fp32 sums
(``ops.distance.dot_bf16``), keeps ``refine_ratio·k`` candidates a tile,
and re-ranks the survivors exactly in fp32. Every search records its
engine and why (``obs.explain.record_dispatch``; ``explain=True`` returns
the record). ``serialize``/``deserialize`` write and read the JAX
package's file format; ``make_batch_k_query`` walks each query's
neighbours a batch at a time.
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
from raft_tpu_torch.ops.distance import (DistanceType,
                                         cosine_expanded, dot_bf16,
                                         gathered_distances, is_min_close,
                                         l2_expanded, pairwise_core,
                                         resolve_metric, row_norms_sq)
from raft_tpu_torch.ops.select_k import (SelectAlgo, refine_multiplier,
                                         select_k, select_k_maybe_approx)
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
    norms for the expanded metrics; ``metric_arg`` is Minkowski's p."""
    res = ensure_resources(res, device)
    m = resolve_metric(metric)
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


def planned_peak_bytes(n_queries: int, n_db: int, dim: int, k: int,
                       budget: int) -> int:
    """The peak the tiled path's solve (``_choose_tiles``) plans for: one
    dataset-sized copy plus the five fp32 distance tiles of the
    expanded-L2 chain at the planned (query tile, database tile)."""
    q_tile, db_tile = _choose_tiles(n_queries, n_db, dim, k, budget)
    return n_db * dim * 4 + 5 * q_tile * db_tile * 4


def _fast_scan_tile(qt, qn, db_t, db_norms, metric: DistanceType):
    """The fast scan's screen of one tile: the bf16 product with the exact
    fp32 norms, squared for both L2 metrics (the ranking is the same)."""
    dots = dot_bf16(qt, db_t)
    if metric == DistanceType.InnerProduct:
        return dots
    if metric == DistanceType.CosineExpanded:
        denom = torch.sqrt(qn[:, None] * db_norms[None, :])
        return 1.0 - dots / torch.clamp_min(denom,
                                            torch.finfo(torch.float32).tiny)
    return torch.clamp_min((qn[:, None] + db_norms[None, :]) - 2.0 * dots,
                           0.0)


#: the product engine's expanded metrics: one product scores a tile (the
#: bf16 fast scan serves these alone), and every other dense metric's tiles
#: select through the select_k kernel
_EXPANDED_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                     DistanceType.CosineExpanded, DistanceType.InnerProduct)


def _knn_tiled(queries, index: Index, filter_words, k: int, q_tile: int,
               db_tile: int, select_recall: float, fast_scan: bool = False,
               refine_mult: int = 1, budget: Optional[int] = None):
    """The tiled path (``budget``: the workspace bytes that size the
    elementwise metrics' tiles, ``ops.distance.pairwise_core``); with ``fast_scan`` each tile keeps its
    ``refine_mult·k`` best by the bf16 screen, and the query tile's
    survivors are re-ranked by their exact fp32 distances."""
    metric = index.metric
    minimize = is_min_close(metric)
    bad_fill = torch.inf if minimize else -torch.inf
    dataset, ndb = index.dataset, index.size
    use_norms = index.norms is not None
    db_norms = index.norms
    if fast_scan and db_norms is None and metric != DistanceType.InnerProduct:
        db_norms = row_norms_sq(dataset)
    k_scan = min(refine_mult * k, db_tile) if fast_scan else k
    kernel_select = (metric not in _EXPANDED_METRICS and filter_words is None
                     and not fast_scan and k <= gk.MAX_K)

    def tile_select(d, kk):
        if kernel_select:
            return select_k(d, kk, select_min=minimize,
                            algo=SelectAlgo.PALLAS)
        return select_k_maybe_approx(d, kk, minimize, select_recall)

    out_v, out_i = [], []
    for qs in range(0, queries.shape[0], q_tile):
        qt = queries[qs:qs + q_tile]
        qn = row_norms_sq(qt) if use_norms or fast_scan else None
        tile_v, tile_i = [], []
        for t0 in range(0, ndb, db_tile):
            db_t = dataset[t0:t0 + db_tile]
            if fast_scan:
                d = _fast_scan_tile(
                    qt, qn, db_t, None if db_norms is None
                    else db_norms[t0:t0 + db_tile], metric)
            elif metric == DistanceType.CosineExpanded:
                d = cosine_expanded(qt, db_t, qn, index.norms[t0:t0 + db_tile])
            elif use_norms:
                d = l2_expanded(qt, db_t,
                                sqrt=metric == DistanceType.L2SqrtExpanded,
                                x_norms=qn,
                                y_norms=index.norms[t0:t0 + db_tile])
            else:
                d = pairwise_core(qt, db_t, metric, index.metric_arg,
                                  budget)
            if filter_words is not None:
                ids = torch.arange(t0, t0 + db_t.shape[0], device=d.device)
                d = torch.where(filter_mask(ids, filter_words)[None, :], d,
                                bad_fill)
            v, i = tile_select(d, min(k_scan, db_t.shape[0]))
            tile_v.append(v)
            tile_i.append(torch.where(i >= 0, i + t0, -1))
        all_v, all_i = torch.cat(tile_v, dim=1), torch.cat(tile_i, dim=1)
        if fast_scan:
            # the exact fp32 re-rank of the screen's survivors; rows the
            # filter clears are masked again (their gathered distance is
            # real)
            _, sel = select_k_maybe_approx(
                all_v, min(max(k_scan, k), all_v.shape[1]), minimize,
                select_recall)
            cand_i = torch.gather(all_i, 1, sel.long())
            exact = gathered_distances(qt, dataset[cand_i.long()], metric)
            if filter_words is not None:
                exact = torch.where(filter_mask(cand_i, filter_words), exact,
                                    bad_fill)
            v, sel = select_k(exact, k, select_min=minimize)
            out_v.append(v)
            out_i.append(torch.gather(cand_i, 1, sel.long()))
            continue
        if kernel_select:
            v, sel = tile_select(all_v, k)
        else:
            v, sel = select_k(all_v, k, select_min=minimize)
        out_v.append(v)
        out_i.append(torch.where(sel >= 0, torch.gather(
            all_i, 1, sel.clamp_min(0).long()), -1))
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


def fast_scan_requested(scan_dtype) -> bool:
    """Whether ``scan_dtype`` asks for the bf16 fast scan (None: no); any
    type other than bfloat16 (a name, a torch dtype, or a dtype object such
    as the JAX package's) raises ``ValueError`` as the JAX package does."""
    if scan_dtype is None:
        return False
    if isinstance(scan_dtype, torch.dtype):
        name = str(scan_dtype).replace("torch.", "")
    elif isinstance(scan_dtype, str):
        name = scan_dtype
    else:
        name = getattr(scan_dtype, "name", None) or getattr(
            scan_dtype, "__name__", str(scan_dtype))
    if name != "bfloat16":
        raise ValueError(
            f"scan_dtype={scan_dtype!r}: only bfloat16 is supported")
    return True


def fused_route(family: str, scan_mode: str, ineligible: Optional[str],
                device: torch.device) -> Tuple[bool, str]:
    """``(use_fused, reason)`` of a family's search: ``"xla"`` names the
    unfused engine (``forced``); an ineligible request keeps off the kernel
    whatever the verdict, and says why (``fused_ineligible_reason`` comes
    first); otherwise the measured gate decides
    (``gpu_kernels.fused_dispatch_explained``)."""
    if scan_mode == "xla":
        return False, "forced"
    if ineligible is not None:
        return False, ineligible
    return gk.fused_dispatch_explained(family, scan_mode, device)


def kernel_plan(device: torch.device, kernel: str) -> dict:
    """The explain plan of a fused engine: the kernel and its route, the
    hand-written CUDA kernel on the card ("cuda") or its plain PyTorch
    version on the CPU ("plain")."""
    return {"kernel": kernel,
            "route": "cuda" if device.type == "cuda" else "plain"}


def explained(result, cap, explain: bool):
    """``result`` plus the capture's record when ``explain`` is set."""
    return (*result, cap.last) if explain else result


def blocks_host(x, device: torch.device) -> bool:
    """Whether putting ``x`` (a tensor, or a host array) on ``device`` waits
    on a card: a copy between host memory and a CUDA device, which torch
    makes synchronous (the host waits for the stream's queued work)."""
    on_card = isinstance(x, torch.Tensor) and x.device.type == "cuda"
    return on_card != (device.type == "cuda")


def host_wait(family: str, site: str, x, device: torch.device):
    """The scope of a ``family`` search's staging of ``x`` onto ``device``:
    where that blocks the host (``blocks_host``), a ``<family>.search.wait``
    span and one count of ``raft_tpu_host_sync_total{site}`` at site
    ``<family>.<site>``; else a no-op scope."""
    if not blocks_host(x, device):
        return contextlib.nullcontext()
    obs_explain.note_host_sync(f"{family}.{site}")
    return tracing.span(f"{family}.search.wait")


@tracing.range("brute_force.search")
def search(index: Index, queries, k: int, filter=None,
           res: Optional[Resources] = None, scan_dtype=None,
           refine_ratio: float = 4.0, select_recall: float = 1.0,
           scan_mode: str = "auto", explain: bool = False):
    """Exact kNN → ``(distances [nq, k] f32, ids [nq, k] i32)``.

    ``filter`` is an optional :class:`~raft_tpu_torch.core.bitset.Bitset`
    over dataset rows; cleared rows are never returned. ``scan_mode``:
    ``"pallas"`` takes the fused kernel for every eligible request,
    ``"auto"`` where the measured verdict says it wins on the card (always
    on the CPU, through its plain version), ``"xla"`` forces the tiled
    path. ``scan_dtype="bfloat16"``
    (an fp32 dataset) takes the tiled path with the bf16 screen and re-ranks
    the best ``refine_ratio·k`` of each tile exactly in fp32: distances are
    exact, and a neighbour is missed only where the screen's rounding
    pushes it out of a tile's survivors. The search runs on the index's
    device. ``explain=True`` returns ``(distances, ids, ExplainRecord)``.
    """
    fast_scan = fast_scan_requested(scan_dtype)
    if fast_scan and index.dataset.dtype != torch.float32:
        raise ValueError("scan_dtype requires an fp32 dataset")
    if fast_scan and index.metric not in _EXPANDED_METRICS:
        raise ValueError(
            f"scan_dtype unsupported for metric {index.metric.name}; "
            "eligible: L2Expanded/L2SqrtExpanded/CosineExpanded/"
            "InnerProduct")
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
        index.metric, index.dataset.dtype, k, filter is not None, fast_scan)
    refine_mult = refine_multiplier(refine_ratio, fast_scan)
    ex_params = {"k": k, "nq": nq, "bucket": query_bucket(nq),
                 "n_db": index.size, "dim": index.dim,
                 "metric": index.metric.name}
    use_fused, reason = fused_route("brute_force", scan_mode, ineligible,
                                    index.device)
    with contextlib.ExitStack() as stack:
        cap = stack.enter_context(obs_explain.capture()) if explain else None
        if use_fused:
            obs_explain.record_dispatch(
                "brute_force", scan_mode, "pallas", reason,
                params=ex_params,
                plan=kernel_plan(index.device, "fused_l2_topk"))
            x = queries.to(torch.float32)
            y = index.dataset.to(torch.float32)
            v, i = gk.fused_l2_topk(x, y, k, row_norms_sq(x), index.norms)
            if index.metric == DistanceType.L2SqrtExpanded:
                v = torch.sqrt(torch.clamp_min(v, 0.0))
        else:
            q_tile, db_tile = _choose_tiles(nq, index.size, index.dim, k,
                                            res.workspace_limit_bytes)
            if fast_scan:
                # the re-rank's gather [q_tile, k_refine, dim] fp32 within
                # the workspace too
                per_row = max(min(refine_mult * k, db_tile), k) * index.dim * 4
                q_cap = max(8, res.workspace_limit_bytes // (4 * per_row))
                q_tile = min(q_tile, q_cap - q_cap % 8 or 8)
            obs_explain.record_dispatch(
                "brute_force", scan_mode, "xla", reason,
                params=ex_params, plan={
                    "q_tile": q_tile, "db_tile": db_tile,
                    "predicted_peak_bytes": planned_peak_bytes(
                        nq, index.size, index.dim, k,
                        res.workspace_limit_bytes)})
            words = filter.words.to(index.device) if filter is not None \
                else None
            v, i = _knn_tiled(queries, index, words, k, q_tile, db_tile,
                              float(select_recall), fast_scan, refine_mult,
                              res.workspace_limit_bytes)
    return explained((v, i), cap, explain)


@tracing.range("brute_force.knn")
def knn(queries, dataset, k: int, metric="euclidean", metric_arg: float = 2.0,
        res: Optional[Resources] = None, scan_dtype=None,
        refine_ratio: float = 4.0, select_recall: float = 1.0,
        scan_mode: str = "auto", explain: bool = False, device=None):
    """One-shot exact kNN: ``search(build(dataset), queries, k)``."""
    return search(build(dataset, metric, metric_arg, res, device), queries, k,
                  res=res, scan_dtype=scan_dtype, refine_ratio=refine_ratio,
                  select_recall=select_recall, scan_mode=scan_mode,
                  explain=explain)


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


def make_batch_k_query(index: Index, queries, batch_size: int,
                       res: Optional[Resources] = None):
    """Each query's neighbours in batches of ``batch_size``: the first
    yield holds the nearest ``batch_size``, the next the following ones, and
    so on to the dataset's end. The searched k grows geometrically (at
    least four batches, then doubling) and several batches are sliced from
    each search, so n neighbours cost O(log(n / batch_size)) searches."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")

    def _iter():
        offset, k = 0, 0
        d = i = None
        while offset < index.size:
            if offset + batch_size > k:
                k = min(max(4 * batch_size, 2 * k), index.size)
                d, i = search(index, queries, k, res=res)
            end = min(offset + batch_size, index.size)
            yield d[:, offset:end], i[:, offset:end]
            offset = end

    return _iter()
