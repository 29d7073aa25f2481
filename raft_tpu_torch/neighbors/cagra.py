"""CAGRA — graph-based ANN index: build, optimize, greedy beam search.

Counterpart of ``raft_tpu.neighbors.cagra``.

- **Build**: an all-neighbours kNN graph at ``intermediate_graph_degree``,
  by NN-descent (default) or by IVF-PQ search + exact refine, then
  ``optimize``.
- **optimize**: per node, each edge's 2-hop detour count (how many
  better-ranked neighbours also reach the edge's target), the
  ``graph_degree`` edges of smallest (count, rank), then reverse edges
  into the tail slots (at most half the degree). Bitwise equal to the JAX
  package on the same kNN graph.
- **Search**: a beam of ``itopk`` (distance, id, expanded) entries per
  query, seeded from a stratified lattice rotated per query by the JAX
  package's own draw (``ops.rng.cagra_seed_offsets``). Two engines:
  ``fused_cagra_topk`` (the whole walk in one CUDA kernel, one block per
  query; its plain version on the CPU) for L2 metrics, unfiltered,
  itopk <= 1024; and ``search_core``, the glue engine in PyTorch, for
  every request (inner product, filters). ``scan_mode``: ``"pallas"``
  takes the kernel wherever it is eligible, ``"auto"`` where the card's
  measured verdict says it wins too (always on the CPU), ``"xla"`` forces
  the glue engine. The bf16 fast scan (``scan_dtype="bfloat16"``, an fp32
  dataset) takes the glue engine: the walk gathers rows from a cached
  bf16 copy of the dataset (``Index.ensure_scan_dataset``, half the
  gathered bytes) and scores them against the bf16-rounded queries, then
  the final beam is re-ranked exactly in fp32.

Every search records its engine and why (``obs.explain.record_dispatch``;
``explain=True`` returns the record). ``serialize``/``deserialize`` write
and read the JAX package's file format. The serving batch bucket is not
needed (a query's seeds depend only on its row).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import time
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.bitset import filter_mask
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.neighbors.brute_force import (explained,
                                                  fast_scan_requested,
                                                  fused_ineligible_reason,
                                                  kernel_plan)
from raft_tpu_torch.neighbors.nn_descent import scatter_last_wins
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops.distance import (DistanceType, gathered_distances,
                                         resolve_metric)
from raft_tpu_torch.ops.rng import cagra_seed_offsets
from raft_tpu_torch.ops.select_k import (merge_topk_dedup_flagged,
                                         topk_lowest_first)
from raft_tpu_torch.utils.shape import as_query_array, query_bucket


class BuildAlgo(enum.IntEnum):
    IVF_PQ = 0
    NN_DESCENT = 1


@dataclasses.dataclass
class IndexParams:
    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    build_algo: BuildAlgo = BuildAlgo.NN_DESCENT
    nn_descent_niter: int = 20
    metric: DistanceType = DistanceType.L2Expanded

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        self.build_algo = BuildAlgo(self.build_algo)
        if self.metric not in (DistanceType.L2Expanded,
                               DistanceType.L2SqrtExpanded,
                               DistanceType.InnerProduct):
            raise ValueError(
                f"cagra supports L2Expanded/L2SqrtExpanded/InnerProduct, got "
                f"{self.metric.name}")


@dataclasses.dataclass
class SearchParams:
    """``max_iterations`` 0 applies the auto heuristic. ``scan_dtype``:
    None scores in fp32; ``"bfloat16"`` walks over the bf16 copy of the
    dataset and re-ranks the final beam exactly in fp32."""

    itopk_size: int = 64
    search_width: int = 1
    max_iterations: int = 0
    num_random_samplings: int = 1
    rand_xor_mask: int = 0x128394
    scan_dtype: Optional[object] = None
    scan_mode: str = "auto"


class Index:
    """Dataset [n, dim] and fixed-degree graph [n, graph_degree] int32 on
    one device. ``build_seconds`` holds the build's stages (``knn_graph``,
    ``optimize``) when ``build`` made the index."""

    def __init__(self, params: IndexParams, dataset: torch.Tensor,
                 graph: torch.Tensor):
        self.params = params
        self.dataset = dataset
        self.graph = graph
        self.build_seconds: dict = {}
        self._dataset_bf16 = None  # the fast scan's copy, made at first use

    def ensure_scan_dataset(self) -> torch.Tensor:
        """The bf16 copy of the dataset that the fast scan gathers from
        (made once, kept on the index)."""
        if self._dataset_bf16 is None:
            self._dataset_bf16 = self.dataset.to(torch.bfloat16)
        return self._dataset_bf16

    @property
    def metric(self) -> DistanceType:
        return self.params.metric

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dataset.device


# ------------------------------------------------------------------ optimize


def _detour_counts(graph: torch.Tensor, node_tile: int) -> torch.Tensor:
    """count[i, a] = #{b < a : G[i,a] ∈ G[G[i,b]]}, per node tile, the
    membership accumulated over chunks of the 2-hop axis (any-over-c, so
    duplicate ids count as the JAX package counts them)."""
    n, k = graph.shape
    chunk = min(16, k)
    before = torch.triu(torch.ones(k, k, dtype=torch.bool,
                                   device=graph.device), 1)  # [b, a]: b < a
    out = []
    for s in range(0, n, node_tile):
        gt = graph[s:s + node_tile]
        valid = gt >= 0
        g2 = graph[gt.clamp_min(0).long()]  # [t, b, c] 2-hop ids
        g2 = torch.where(valid[:, :, None], g2, -1)
        member = torch.zeros((gt.shape[0], k, k), dtype=torch.bool,
                             device=graph.device)
        for c0 in range(0, k, chunk):
            col = g2[:, :, c0:c0 + chunk]
            member |= (col[:, :, :, None] == gt[:, None, None, :]).any(2)
        member &= valid[:, None, :] & valid[:, :, None]
        out.append((member & before).sum(1).to(torch.int32))
    return torch.cat(out)


def _prune(graph: torch.Tensor, counts: torch.Tensor,
           out_degree: int) -> torch.Tensor:
    """Keep the ``out_degree`` edges of smallest (detour count, rank),
    invalid edges last, in rank order."""
    k = graph.shape[1]
    key = counts.to(torch.float32) * (k + 1) + torch.arange(
        k, device=graph.device, dtype=torch.float32)[None, :]
    key = torch.where(graph >= 0, key, torch.inf)
    _, sel = topk_lowest_first(key, out_degree, select_min=True)
    sel = torch.sort(sel, dim=1).values
    return torch.gather(graph, 1, sel)


def _reverse_graph(graph: torch.Tensor, max_rev: int) -> torch.Tensor:
    """Reverse adjacency with ``max_rev`` slots per node: edge (i→j) lands
    in slot (i·2654435761 + rank·40503) mod 2³² mod max_rev of j, the later
    edge (in row-major order) winning a slot, as the JAX package's serial
    scatter leaves it."""
    n, d = graph.shape
    dev = graph.device
    src = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    rank = torch.arange(d, dtype=torch.int64, device=dev)[None, :]
    mask = 0xFFFFFFFF
    slots = ((((src * 2654435761) & mask) + rank * 40503) & mask) % max_rev
    tgt = torch.where(graph >= 0, graph, n)
    return scatter_last_wins(n, max_rev, tgt, slots.expand(n, d),
                             src.expand(n, d).to(torch.int32))


def _augment_reverse(pruned: torch.Tensor, rev: torch.Tensor,
                     row_tile: int = 1 << 16) -> torch.Tensor:
    """Replace the tail slots of the pruned graph with reverse edges not
    already present (forward edges keep priority; at most half the
    degree)."""
    n, d = pruned.shape
    n_rev = rev.shape[1]
    out = []
    slot = torch.arange(d, device=pruned.device)[None, :]
    for s in range(0, n, row_tile):
        p, r = pruned[s:s + row_tile], rev[s:s + row_tile]
        own = torch.arange(s, s + p.shape[0], device=p.device)[:, None]
        dup = (r[:, :, None] == p[:, None, :]).any(2)
        r = torch.where(dup | (r == own), -1, r)
        order = torch.sort((r < 0).to(torch.int8), dim=1, stable=True).indices
        r_c = torch.gather(r, 1, order)
        n_replace = torch.clamp_max((r_c >= 0).sum(1), d // 2)
        first = (d - n_replace)[:, None]
        rev_idx = torch.clamp(slot - first, 0, n_rev - 1)
        out.append(torch.where(slot >= first, torch.gather(r_c, 1, rev_idx),
                               p))
    return torch.cat(out)


def _detour_tile(k: int, workspace_limit_bytes: int) -> int:
    """Node tile of the detour count: the JAX package's per-node scratch
    (≈ 25·K² bytes) against the workspace, capped at 4096 nodes (the JAX
    package caps at 256 for the TPU's VMEM; the tile does not change the
    counts)."""
    per_node = 25 * k * k
    tile = int(np.clip(workspace_limit_bytes // max(per_node, 1), 8, 4096))
    return max(tile - tile % 8, 8)


@tracing.range("cagra.optimize")
def optimize(knn_graph, graph_degree: int, res: Optional[Resources] = None,
             device=None) -> torch.Tensor:
    """Prune an intermediate kNN graph [n, K] to ``graph_degree`` columns
    (a graph already that narrow comes back as it is)."""
    res = ensure_resources(res, device)
    g = as_query_array(knn_graph, res.device, torch.int32)
    k = g.shape[1]
    if graph_degree >= k:
        return g
    counts = _detour_counts(g, _detour_tile(k, res.workspace_limit_bytes))
    pruned = _prune(g, counts, int(graph_degree))
    rev = _reverse_graph(pruned, int(graph_degree))
    return _augment_reverse(pruned, rev)


# --------------------------------------------------------------------- build


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@tracing.range("cagra.build")
def build(dataset, params: Optional[IndexParams] = None,
          res: Optional[Resources] = None, device=None) -> Index:
    """kNN graph at the intermediate degree, then ``optimize`` to
    ``graph_degree``. Runs on CUDA unless ``device="cpu"`` (or ``res``)
    says otherwise."""
    params = params or IndexParams()
    res = ensure_resources(res, device)
    dataset = as_query_array(dataset, res.device)
    n = dataset.shape[0]
    k_inter = int(min(params.intermediate_graph_degree, n - 1))
    t0 = _clock(res.device)
    if params.build_algo == BuildAlgo.NN_DESCENT:
        from raft_tpu_torch.neighbors import nn_descent

        nd_params = nn_descent.IndexParams(
            graph_degree=k_inter,
            intermediate_graph_degree=min(int(k_inter * 1.5), n - 1),
            max_iterations=params.nn_descent_niter, metric=params.metric)
        knn = nn_descent.build(dataset, nd_params, res=res).graph
    else:
        knn = _build_knn_graph_ivf_pq(dataset, k_inter, params, res)
    t1 = _clock(res.device)
    graph = optimize(knn, int(min(params.graph_degree, k_inter)), res=res)
    index = Index(params, dataset, graph)
    index.build_seconds = {"knn_graph": t1 - t0,
                           "optimize": _clock(res.device) - t1}
    return index


def _drop_self(refined: torch.Tensor, row0: int, k_inter: int):
    """Drop each row's own id where present, else its last slot."""
    w = refined.shape[1]
    rows = torch.arange(refined.shape[0], device=refined.device) + row0
    is_self = refined == rows[:, None]
    last = torch.arange(w, device=refined.device)[None, :] == w - 1
    drop = torch.where(is_self.any(1, keepdim=True), is_self, last)
    order = torch.sort(drop.to(torch.int8), dim=1, stable=True).indices
    return torch.gather(refined, 1, order)[:, :k_inter].to(torch.int32)


def _build_knn_graph_ivf_pq(dataset, k_inter: int, params: IndexParams,
                            res: Resources) -> torch.Tensor:
    """IVF-PQ build on the dataset, batched self-search for 2·(k_inter+1)
    candidates, exact refine to k_inter+1, self dropped. The tail batch
    overlaps the one before it, so every batch has the same shape."""
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod
    from raft_tpu_torch.neighbors.refine import refine

    n, dim = dataset.shape
    n_lists = int(np.clip(int(np.sqrt(n) * 2), 16, 8192))
    n_lists = min(n_lists, max(n // 64, 16))
    ipq = ivf_pq_mod.IndexParams(
        n_lists=n_lists,
        metric=(DistanceType.L2Expanded
                if params.metric != DistanceType.InnerProduct
                else DistanceType.InnerProduct),
        pq_dim=max(8, (dim // 2 + 7) // 8 * 8))
    index = ivf_pq_mod.build(dataset, ipq, res=res)
    top = k_inter + 1
    sp = ivf_pq_mod.SearchParams(n_probes=max(min(n_lists, 32),
                                              n_lists // 16))
    batch = min(8192, n)
    parts = []
    for s in range(0, n, batch):
        row0 = min(s, n - batch)
        q = dataset[row0:row0 + batch]
        _, cand = ivf_pq_mod.search(index, q, min(top * 2, n), sp, res=res)
        _, refined = refine(dataset, q, cand, top, metric=params.metric,
                            res=res)
        keep = _drop_self(refined, row0, k_inter)
        parts.append(keep if row0 == s else keep[s - row0:])
    return torch.cat(parts)


# -------------------------------------------------------------------- search


def _distances_to(queries, q_norms, dataset, ids, metric: DistanceType,
                  filter_words):
    """The minimised distance of each query to its rows ``ids`` [b, c]:
    squared L2 for both L2 metrics, the negated dot for inner product;
    +inf for ids < 0 and for rows the filter clears. The arithmetic is the
    kernel's (``gpu_kernels.beam_distances``), so both engines score a row
    bitwise alike."""
    d = gk.beam_distances(queries, q_norms, dataset, ids,
                          inner_product=metric == DistanceType.InnerProduct)
    if filter_words is not None:
        d = torch.where(filter_mask(ids, filter_words), d, torch.inf)
    return d


def _rerank(queries, dataset, buf_d, buf_ids, metric: DistanceType):
    """The fast scan's exact fp32 re-rank of the final beam (the minimised
    distance, as the walk's): entries with no id, or at +inf in the walk
    (filtered out), stay at +inf and last."""
    inner = (DistanceType.L2Expanded
             if metric == DistanceType.L2SqrtExpanded else metric)
    ex = gathered_distances(queries, dataset[buf_ids.clamp_min(0)], inner)
    if metric == DistanceType.InnerProduct:
        ex = -ex
    ex = torch.where((buf_ids < 0) | ~torch.isfinite(buf_d), torch.inf, ex)
    v, pos = topk_lowest_first(ex, ex.shape[1], select_min=True)
    return v, torch.gather(buf_ids, 1, pos)


def _search_glue(queries, dataset, graph, seed_ids, filter_words,
                 metric: DistanceType, itopk: int, width: int, max_iter: int,
                 scan_dataset=None):
    """One chunk of queries through the glue engine; returns the beam. With
    ``scan_dataset`` (the bf16 copy) the walk scores the bf16-rounded
    queries against its rows and the beam is re-ranked in fp32."""
    q_scan = (queries if scan_dataset is None
              else queries.to(torch.bfloat16).to(torch.float32))
    scan_rows = dataset if scan_dataset is None else scan_dataset
    qn = gk.beam_norms(q_scan)

    def score(ids):
        return _distances_to(q_scan, qn, scan_rows, ids, metric,
                             filter_words)

    buf_ids, buf_d, buf_fl = merge_topk_dedup_flagged(
        seed_ids, score(seed_ids), torch.zeros_like(seed_ids, dtype=torch.bool),
        itopk)
    buf_ids = buf_ids.to(torch.int64)
    # The buffer stays sorted by distance between hops, so the parent pick
    # takes the first unexpanded entries, and dedup against the buffer
    # (which holds no duplicate) happens before the merge; the merge is one
    # stable sort of [buffer | targets] (gpu_kernels.beam_hop, the hop of the
    # kernel's plain version too). A target equal to a buffer entry is
    # dropped, so the buffer copy keeps its expanded flag; entries at +inf
    # keep their ids, as in the JAX package.
    done = torch.zeros(queries.shape[0], dtype=torch.bool,
                       device=queries.device)
    for _ in range(max_iter):
        buf_d, buf_ids, buf_fl, active, *_ = gk.beam_hop(
            buf_d, buf_ids, buf_fl, done, graph, width, score,
            clear_inf=False)
        done = done | ~active
        if not bool(active.any()):
            break
    if scan_dataset is not None:
        return _rerank(queries, dataset, buf_d, buf_ids, metric)
    return buf_d, buf_ids


@tracing.range("cagra.search_core")
def search_core(queries, dataset, graph, seed_ids, filter_words,
                metric: DistanceType, k: int, itopk: int, width: int,
                max_iter: int, q_tile: Optional[int] = None,
                scan_dataset: Optional[torch.Tensor] = None):
    """The glue engine (the JAX package's ``search_core``): seeds merged by
    ``merge_topk_dedup_flagged``, then at most ``max_iter`` hops; a query
    whose pick finds no unexpanded finite entry freezes, and the loop ends
    when every query has. ``filter_words`` (None: no filter) are a bitset's
    words: cleared rows never enter the beam as candidates. Queries run in
    chunks of ``q_tile``; a query's result does not depend on its chunk.
    ``scan_dataset`` (the bf16 copy) is the fast scan. Returns
    ``(distances [nq, k], ids [nq, k])`` in the metric's units."""
    nq = queries.shape[0]
    q_tile = nq if q_tile is None else max(int(q_tile), 1)
    outs = [_search_glue(queries[s:s + q_tile], dataset, graph,
                         seed_ids[s:s + q_tile], filter_words, metric, itopk,
                         width, max_iter, scan_dataset)
            for s in range(0, nq, q_tile)]
    if not outs:
        outs = [(queries.new_empty((0, itopk)),
                 queries.new_empty((0, itopk), dtype=torch.int32))]
    out_d = torch.cat([o[0] for o in outs])[:, :k]
    out_i = torch.cat([o[1] for o in outs])[:, :k].to(torch.int32)
    if metric == DistanceType.InnerProduct:
        out_d = -out_d
    elif metric == DistanceType.L2SqrtExpanded:
        out_d = torch.sqrt(torch.clamp_min(out_d, 0.0))
    return out_d, out_i


def search_fused_core(queries, dataset, graph, seed_ids,
                      metric: DistanceType, k: int, itopk: int, width: int,
                      max_iter: int):
    """The kernel engine: ``fused_cagra_topk`` (squared L2), then the
    square root for L2SqrtExpanded."""
    qf = queries.to(torch.float32).contiguous()
    v, i = gk.fused_cagra_topk(
        qf, dataset.to(torch.float32).contiguous(),
        graph.to(torch.int32).contiguous(),
        seed_ids.to(torch.int32).contiguous(), gk.beam_norms(qf), int(k),
        itopk, width, max_iter)
    if metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(torch.clamp_min(v, 0.0))
    return v, i


def resolve_search_plan(params: SearchParams, k: int, size: int):
    """The resolved beam plan ``(itopk, width, max_iter, n_seeds)``."""
    itopk = max(int(params.itopk_size), int(k))
    width = max(int(params.search_width), 1)
    max_iter = gk.resolve_max_iter(itopk, width, int(params.max_iterations))
    n_rand = max(int(params.num_random_samplings), 1)
    n_seeds = min(max(itopk, 32) * n_rand, int(size))
    return itopk, width, max_iter, n_seeds


def seed_table(params: SearchParams, n_queries: int, size: int,
               n_seeds: int, device) -> torch.Tensor:
    """Seeds [n_queries, n_seeds] int32: a stratified lattice over the
    dataset's ids (every size/n_seeds stretch holds one), rotated per row
    by the JAX package's draw, so row q's seeds depend only on q and the
    mask. Only the per-row offsets are drawn on the host; the lattice is
    laid out on ``device``."""
    base = torch.arange(n_seeds, dtype=torch.int64, device=device) * size \
        // n_seeds
    offsets = torch.from_numpy(cagra_seed_offsets(
        params.rand_xor_mask, n_queries, size)).to(device)
    seeds = base[None, :] + offsets[:, None]  # < 2·size: one wrap is enough
    return torch.where(seeds >= size, seeds - size, seeds).to(torch.int32)


@dataclasses.dataclass
class SearchPlan:
    """``engine``: "pallas" (the kernel) or "xla" (the glue engine);
    ``reason``: why the kernel was not taken (None when it was: the
    search's explain record says why, ``gpu_kernels.fused_dispatch_explained``);
    ``plan``: the resolved beam plan."""

    engine: str
    reason: Optional[str]
    plan: dict


def plan_search(index: Index, k: int, params: Optional[SearchParams] = None,
                has_filter: bool = False) -> SearchPlan:
    """The engine ``search`` takes for this request, and why."""
    params = params or SearchParams()
    if params.scan_mode not in ("auto", "xla", "pallas"):
        raise ValueError(f"scan_mode={params.scan_mode!r}: expected 'auto', "
                         "'xla' or 'pallas'")
    itopk, width, max_iter, n_seeds = resolve_search_plan(params, k,
                                                          index.size)
    plan = {"itopk": itopk, "search_width": width, "max_iter": max_iter,
            "n_seeds": n_seeds}
    fast_scan = fast_scan_requested(params.scan_dtype)
    if fast_scan and index.dataset.dtype != torch.float32:
        raise ValueError("scan_dtype requires an fp32 dataset")
    if params.scan_mode == "xla":
        return SearchPlan("xla", "scan_mode_xla", plan)
    reason = fused_ineligible_reason(index.metric, index.dataset.dtype, itopk,
                                     has_filter, fast_scan)
    if reason is None and gk.cagra_topk_smem_bytes(
            itopk, index.dim, width, index.graph_degree) > gk.SMEM_LIMIT:
        reason = "smem"
    if reason:
        return SearchPlan("xla", reason, plan)
    use_fused, reason = gk.fused_dispatch_explained("cagra", params.scan_mode,
                                                    index.device)
    return SearchPlan("pallas", None, plan) if use_fused \
        else SearchPlan("xla", reason, plan)


@tracing.range("cagra.search")
def search(index: Index, queries, k: int,
           params: Optional[SearchParams] = None, filter=None,
           res: Optional[Resources] = None, explain: bool = False,
           seeds: Optional[torch.Tensor] = None):
    """Greedy graph search → ``(distances [nq, k] f32, ids [nq, k] int32)``
    in the metric's units. ``filter`` is an optional
    :class:`~raft_tpu_torch.core.bitset.Bitset` over dataset rows; cleared
    rows never enter the beam. Runs on the index's device; ``plan_search``
    says which engine it takes, and ``explain=True`` returns a third
    element, the search's ``ExplainRecord``. ``seeds`` is the
    ``seed_table`` of these params and this batch's row count, drawn
    beforehand (the serving searcher keeps one a bucket); None draws it
    here, on the host."""
    params = params or SearchParams()
    fast_scan = fast_scan_requested(params.scan_dtype)
    res = ensure_resources(res, index.device)
    if isinstance(queries, torch.Tensor) and queries.dim() == 1:
        queries = queries[None]
    elif not isinstance(queries, torch.Tensor) and np.ndim(queries) == 1:
        queries = np.asarray(queries)[None]
    queries = as_query_array(queries, index.device)
    if queries.shape[1] != index.dim:
        raise ValueError(
            f"query dim {queries.shape[1]} != index dim {index.dim}")
    sp = plan_search(index, k, params, filter is not None)
    itopk, width, max_iter = (sp.plan["itopk"], sp.plan["search_width"],
                              sp.plan["max_iter"])
    nq = queries.shape[0]
    if seeds is None:
        seeds = seed_table(params, nq, index.size, sp.plan["n_seeds"],
                           index.device)
    elif tuple(seeds.shape) != (nq, sp.plan["n_seeds"]):
        raise ValueError(f"seeds {tuple(seeds.shape)} != "
                         f"({nq}, {sp.plan['n_seeds']})")
    ex_params = {"k": int(k), "nq": nq, "bucket": query_bucket(nq),
                 "metric": index.metric.name,
                 "graph_degree": index.graph_degree, "fast_scan": fast_scan}
    if sp.engine == "pallas":
        reason = gk.fused_dispatch_explained("cagra", params.scan_mode,
                                             index.device)[1]
        ex_plan = {**sp.plan, **kernel_plan(index.device,
                                            "fused_cagra_topk")}
    else:
        reason = "forced" if sp.reason == "scan_mode_xla" else sp.reason
        ex_plan = dict(sp.plan)
    with contextlib.ExitStack() as stack:
        cap = stack.enter_context(obs_explain.capture()) if explain else None
        obs_explain.record_dispatch("cagra", params.scan_mode, sp.engine,
                                    reason, params=ex_params, plan=ex_plan)
        if sp.engine == "pallas":
            out = search_fused_core(queries, index.dataset, index.graph,
                                    seeds, index.metric, int(k), itopk, width,
                                    max_iter)
        else:
            words = filter.words.to(index.device) if filter is not None \
                else None
            wd = width * index.graph_degree
            per_q = (wd * (itopk + wd) + (itopk + wd) * 16
                     + (wd + sp.plan["n_seeds"]) * index.dim * 8)
            q_tile = max(1, res.workspace_limit_bytes // per_q)
            out = search_core(queries, index.dataset, index.graph, seeds,
                              words, index.metric, int(k), itopk, width,
                              max_iter, q_tile,
                              index.ensure_scan_dataset() if fast_scan
                              else None)
    return explained(out, cap, explain)


_SERIAL_VERSION = 1


def serialize(index: Index, file, include_dataset: bool = True) -> None:
    """Write the index to a path (atomically) or a binary stream, in the
    JAX package's format: the metric, the graph degree, the graph and,
    with ``include_dataset``, the dataset (without it, ``deserialize``
    needs ``dataset=``)."""
    with ser.writer_for(file) as stream:
        w = ser.IndexWriter(stream, "cagra", _SERIAL_VERSION)
        w.scalar(int(index.metric), "<i4")
        w.scalar(index.graph_degree, "<i4")
        w.scalar(1 if include_dataset else 0, "<i4")
        w.array(index.graph)
        if include_dataset:
            w.array(index.dataset)
        w.finish()


def deserialize(file, dataset=None, res: Optional[Resources] = None,
                device=None) -> Index:
    """Read an index written by :func:`serialize` or the JAX package onto
    ``res``'s device (CUDA unless the caller asks for the CPU); a file
    written without its dataset takes ``dataset``."""
    res = ensure_resources(res, device)
    with ser.reader_for(file) as stream:
        r = ser.IndexReader(stream, "cagra", _SERIAL_VERSION)
        metric = DistanceType(r.scalar())
        graph_degree = r.scalar()
        has_ds = bool(r.scalar())
        graph = ser.to_tensor(r.array(), res.device)
        if has_ds:
            ds = ser.to_tensor(r.array(), res.device)
        elif dataset is not None:
            ds = as_query_array(dataset, res.device)
        else:
            raise ValueError(
                "index file has no dataset; pass dataset= to deserialize")
        r.finish()
    params = IndexParams(graph_degree=graph_degree, metric=metric)
    return Index(params, ds, graph)
