"""Sharded index build and search over the ranks of a communicator.

Counterpart of ``raft_tpu.parallel.sharded``: the MNMG pattern that
raft-dask and cuML run over ``raft::comms``. Each rank holds a row shard
and a local index over it (ids global); queries are replicated to every
rank; each rank searches locally with the port's single-device search, so
its scan runs the hand-written kernels of that search; and the per-rank
top-k lists are merged across ranks by the plan's engine:

- ``"allgather"``: every rank concatenates all candidates in rank order and
  selects with ``select_k`` (``lax.top_k``'s order: ties to the lowest
  position, -0.0 before +0.0);
- ``"tree"``: log₂(size) hypercube rounds of ``Comms.tree_topk_merge``;
- ``"ring"``: size-1 hops of ``Comms.ring_topk_merge``, the block moved by
  the hand-written ``ring_shift`` kernel on CUDA devices (its plain version
  only when every rank is on the CPU; a communicator holds one kind of
  device);
- ``"auto"``: the tree on a power-of-two axis, else allgather.

The three return the same bits wherever the JAX package's three do: they
differ only where -0.0 and +0.0 tie, as the JAX engines do (ROADMAP,
reference caveats).

Where the JAX package stacks per-shard arrays into [S, ...] for
``shard_map``, the port keeps a list of per-rank single-device indexes,
built one rank after another (``_map_shards``), each rank with Resources
on its own device whose generator is seeded from the caller's.

Every sharded search records its merge (``obs.explain.record_dispatch``,
family ``sharded_<family>``, engine the merge, with the JAX package's
``params`` keys; ``params["engine"]`` is the ranks' local engine, from
the records their single-device searches emit). With a span sink
installed (:func:`set_span_sink`) each rank's local search is timed with
CUDA events on its device (the host clock on the CPU) and emitted as a
``shard_search`` span, and the whole search as a ``sharded_search`` span;
the ranks run and merge exactly as without a sink, so the results are
bitwise the same.

Not ported (each raises ``NotImplementedError``; ROADMAP Queue A item 13):
sharded CAGRA, persistence and elastic restore, and the from-file and pod
builds.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops.distance import (DistanceType, dot_fp32,
                                         is_min_close, pairwise_core,
                                         resolve_metric)
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.parallel.comms import Comms
from raft_tpu_torch.utils.shape import cdiv

MERGE_MODES = ("auto", "allgather", "tree", "ring")


# ------------------------------------------------------ placement planning


def shard_bounds(size: int, n: int) -> np.ndarray:
    """[S+1] balanced row offsets, the row partition of every sharded build
    (shard sizes within one row of each other)."""
    return np.linspace(0, n, size + 1).astype(np.int64)


def _check_n_lists(bounds: np.ndarray, n_lists: int, n: int,
                   size: int) -> None:
    min_shard = int(np.diff(bounds).min())
    if n_lists > min_shard:
        raise ValueError(
            f"n_lists={n_lists} exceeds the smallest shard's "
            f"{min_shard} rows ({n} rows over {size} devices); every shard "
            f"builds its own index, so n_lists must be ≤ rows-per-shard")


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One sharded search's merge, solved: the per-rank candidate width,
    the merged width, the cross-rank engine with its reason, and the ring's
    shift."""

    size: int
    nq: int
    k: int
    kk: int                   # per-rank candidate width entering the merge
    k_out: int                # merged width = min(k, size·kk)
    merge_mode: str           # resolved: "allgather" | "tree" | "ring"
    merge_reason: str         # "forced" | "merge_tree" | "merge_allgather"
    ring_shift: str           # "kernel" | "plain" | ""
    mask_invalid: bool        # candidates with id < 0 become ±inf first


def merge_dispatch_explained(merge_mode: str, size: int,
                             all_cpu: bool = True) -> Tuple[str, str, str]:
    """Resolve the cross-rank merge engine: ``(engine, reason,
    ring_shift)``. An explicit mode is ``"forced"``; ``"auto"`` takes the
    tree on a power-of-two axis (``"merge_tree"``) and allgather otherwise
    (``"merge_allgather"``: the tree pairs ranks by XOR). The ring's shift
    is its plain version only when every rank is on the CPU (``all_cpu``),
    else the ``ring_shift`` kernel. The port has no probe artifact, which
    leaves ``"auto"`` where the JAX package leaves it off the TPU."""
    pow2 = size >= 2 and (size & (size - 1)) == 0
    if merge_mode == "allgather":
        return "allgather", "forced", ""
    if merge_mode == "tree":
        if not pow2:
            raise ValueError(
                f"merge_mode='tree' needs a power-of-two mesh axis "
                f"(size={size}); use 'allgather' or 'auto'")
        return "tree", "forced", ""
    if merge_mode == "ring":
        if size < 2:
            raise ValueError("merge_mode='ring' needs a mesh axis of at "
                             "least 2 devices")
        return "ring", "forced", "plain" if all_cpu else "kernel"
    if merge_mode != "auto":
        raise ValueError(f"unknown merge_mode: {merge_mode!r} "
                         f"(one of {MERGE_MODES})")
    if not pow2:
        return "allgather", "merge_allgather", ""
    return "tree", "merge_tree", ""


def plan_sharded_search(comms: Comms, nq: int, k: int, kk: int,
                        merge_mode: str = "auto",
                        mask_invalid: bool = False) -> PlacementPlan:
    """Solve the merge of one sharded search of ``nq`` queries whose ranks
    each bring ``kk`` candidates toward ``k``."""
    all_cpu = all(d.type == "cpu" for d in comms.devices)
    mode, reason, ring_shift = merge_dispatch_explained(merge_mode,
                                                        comms.size, all_cpu)
    return PlacementPlan(
        size=comms.size, nq=int(nq), k=int(k), kk=int(kk),
        k_out=min(int(k), comms.size * int(kk)), merge_mode=mode,
        merge_reason=reason, ring_shift=ring_shift,
        mask_invalid=bool(mask_invalid))


def _plan_merge(comms: Comms, plan: PlacementPlan, vs, ids, minimize: bool
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Run the plan's cross-rank merge on per-rank [nq, kk] candidates;
    returns per-rank (values, ids), the same on every rank."""
    if plan.mask_invalid:
        fill = torch.inf if minimize else -torch.inf
        vs = [torch.where(i < 0, fill, v) for v, i in zip(vs, ids)]
    if plan.merge_mode == "allgather":
        v_all = comms.allgather(vs, axis=1)
        i_all = comms.allgather(ids, axis=1)
        out_v, out_i = [], []
        for va, ia in zip(v_all, i_all):
            vm, sel = select_k(va, plan.k_out, select_min=minimize)
            out_v.append(vm)
            out_i.append(torch.gather(ia, 1, sel.long()))
        return out_v, out_i
    if plan.merge_mode == "tree":
        return comms.tree_topk_merge(vs, ids, plan.k_out, select_min=minimize)
    shift = gk.ring_shift if plan.ring_shift == "kernel" else None
    return comms.ring_topk_merge(vs, ids, plan.k_out, select_min=minimize,
                                 shift=shift)


def _record_plan(plan: PlacementPlan, family: str, requested: str,
                 local_engine: str, params: dict) -> None:
    """Emit the merge-dispatch ExplainRecord of one sharded search."""
    p = {"nq": plan.nq, "k": plan.k, "engine": local_engine}
    p.update(params)
    obs_explain.record_dispatch(
        f"sharded_{family}", requested, plan.merge_mode, plan.merge_reason,
        params=p, plan={"size": plan.size, "kk": plan.kk,
                        "k_out": plan.k_out, "merge_mode": plan.merge_mode,
                        "ring_shift": plan.ring_shift})


# ------------------------------------------------------------ span sink

_SPAN_SINK_LOCK = threading.Lock()
_SPAN_SINK: Optional[object] = None  # guarded_by: _SPAN_SINK_LOCK


def set_span_sink(sink: Optional[object]) -> Optional[object]:
    """Install (or clear, with None) the sharded-search span sink.
    Anything with ``emit(dict)`` works (:class:`raft_tpu_torch.obs.
    RingSink`, :class:`~raft_tpu_torch.obs.JsonlSink`, ...). Returns the
    previous sink so callers can restore it."""
    global _SPAN_SINK
    with _SPAN_SINK_LOCK:
        prev, _SPAN_SINK = _SPAN_SINK, sink
    return prev


def _span_sink() -> Optional[object]:
    with _SPAN_SINK_LOCK:
        return _SPAN_SINK


def _search_and_merge(comms: Comms, family: str, local: Callable, per_rank,
                      plan: PlacementPlan, minimize: bool, requested: str,
                      params: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``local(r, *per_rank[r])`` → (values, ids) on every rank, record
    the merge, merge by ``plan``; returns rank 0's (values, ids). With a
    span sink, each rank's local search is bracketed by CUDA events on its
    device (host clock on the CPU) and emitted as a ``shard_search`` span
    (``device_ms``: that rank's search), then the whole search as a
    ``sharded_search`` span (``launch_ms``: the ranks' calls on the host,
    ``merge_ms``, ``total_ms``). The sink changes no computation."""
    sink = _span_sink()
    marks = []

    def timed(r, *args):
        if comms.devices[r].type != "cuda":
            t = time.perf_counter()
            out = local(r, *args)
            marks.append((time.perf_counter() - t) * 1e3)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = local(r, *args)
        end.record()
        marks.append((start, end))
        return out

    t0 = time.perf_counter()
    with obs_explain.capture() as cap:
        found = comms.map(local if sink is None else timed, *per_rank)
    local_engine = cap.records[-1].engine if cap.records else "none"
    _record_plan(plan, family, requested, local_engine, params)
    if sink is None:
        out_v, out_i = _plan_merge(comms, plan, [f[0] for f in found],
                                   [f[1] for f in found], minimize)
        return out_v[0], out_i[0]
    trace_id = obs_spans.new_trace_id()
    t_launch = time.perf_counter()
    for r, mark in enumerate(marks):
        if isinstance(mark, tuple):
            mark[1].synchronize()
            mark = mark[0].elapsed_time(mark[1])
        obs_spans.safe_emit(sink, {
            "kind": "shard_search", "trace_id": trace_id, "family": family,
            "rank": r, "device": str(comms.devices[r]),
            "device_ms": round(mark, 3)})
    t_merge = time.perf_counter()
    out_v, out_i = _plan_merge(comms, plan, [f[0] for f in found],
                               [f[1] for f in found], minimize)
    if out_v[0].device.type == "cuda":
        torch.cuda.synchronize(out_v[0].device)
    t_end = time.perf_counter()
    obs_spans.safe_emit(sink, {
        "kind": "sharded_search", "trace_id": trace_id, "family": family,
        "n_shards": comms.size,
        "launch_ms": round((t_launch - t0) * 1e3, 3),
        "merge_ms": round((t_end - t_merge) * 1e3, 3),
        "total_ms": round((t_end - t0) * 1e3, 3)})
    return out_v[0], out_i[0]


# ------------------------------------------------------ per-rank resources


def _rank_resources(res: Optional[Resources], device: torch.device,
                    seed: int = 0) -> Resources:
    """Resources of one rank: its own device, the caller's budgets."""
    if res is None:
        return Resources(device=device, seed=seed)
    return Resources(device=device, seed=seed,
                     workspace_limit_bytes=res._workspace_limit,
                     device_memory_bytes=res._device_memory)


def _map_shards(comms: Comms, fn, res: Optional[Resources]) -> list:
    """``[fn(r, rank_res) for each rank]``, one rank after another, each
    rank's generator seeded by a draw from the caller's (seed 0 without
    ``res``), so a build is the same whatever order the ranks ran in."""
    if res is None:
        res = Resources(device=comms.devices[0])
    g = res.generator
    seeds = torch.randint(0, 2**62, (comms.size,), generator=g,
                          device=g.device).tolist()
    return comms.map(lambda r: fn(r, _rank_resources(res, comms.devices[r],
                                                     seeds[r])))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _pad_candidates(v, i, kk: int, fill: float):
    """Widen [nq, w] candidates to kk columns of (fill, -1)."""
    w = v.shape[1]
    if w == kk:
        return v, i
    nq = v.shape[0]
    return (torch.cat([v, v.new_full((nq, kk - w), fill)], 1),
            torch.cat([i, i.new_full((nq, kk - w), -1)], 1))


# ----------------------------------------------------------- sharded knn


@tracing.range("sharded.knn")
def knn(comms: Comms, queries, dataset, k: int, metric="sqeuclidean",
        res: Optional[Resources] = None, merge_mode: str = "auto"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over a row-sharded dataset: rank r holds rows
    [r·shard, (r+1)·shard) (shard = ceil(n / size), the last one ragged),
    searches them with the port's brute force (``fused_l2_topk`` for the L2
    metrics) and the plan merges the ranks' top-k. Returns (distances,
    global ids) [nq, min(k, size·kk)] on rank 0's device."""
    m = resolve_metric(metric)
    minimize = is_min_close(m)
    fill = torch.inf if minimize else -torch.inf
    dataset = _as_tensor(dataset)
    n = dataset.shape[0]
    size = comms.size
    shard = cdiv(n, size)
    kk = min(int(k), shard)
    q = comms.shard(_as_tensor(queries), None)

    def local(r, q_r):
        lo, hi = min(r * shard, n), min((r + 1) * shard, n)
        dev = comms.devices[r]
        width = min(kk, hi - lo)
        if width == 0:
            return (torch.full((q_r.shape[0], kk), fill, device=dev),
                    torch.full((q_r.shape[0], kk), -1, dtype=torch.int32,
                               device=dev))
        rank_res = _rank_resources(res, dev)
        index = brute_force.build(dataset[lo:hi].to(dev), m, res=rank_res)
        v, i = brute_force.search(index, q_r, width, res=rank_res)
        gids = torch.where(i >= 0, i + lo, -1).to(torch.int32)
        return _pad_candidates(v, gids, kk, fill)

    plan = plan_sharded_search(comms, q[0].shape[0], int(k), kk,
                               merge_mode=merge_mode)
    return _search_and_merge(comms, "brute_force", local, (q,), plan,
                             minimize, merge_mode, {"metric": m.name})


# ---------------------------------------------- sharded pairwise distance


@tracing.range("sharded.pairwise_distance")
def pairwise_distance(comms: Comms, x, y, metric="sqeuclidean",
                      res: Optional[Resources] = None) -> List[torch.Tensor]:
    """All-pairs distances with both operands row-sharded, by the ring
    schedule: x's shards stay, y's rotate one rank a step (``Comms.shift``),
    and each step every rank fills the [n/S, m/S] block of the y shard it
    holds. Returns rank r's rows of the [n, m] matrix as a per-rank list
    (``torch.cat`` of the list is the matrix)."""
    m_ = resolve_metric(metric)
    x, y = _as_tensor(x), _as_tensor(y)
    n, m = x.shape[0], y.shape[0]
    size = comms.size
    xs_rows, ys_rows = cdiv(n, size), cdiv(m, size)
    xp = torch.nn.functional.pad(x, (0, 0, 0, xs_rows * size - n))
    yp = torch.nn.functional.pad(y, (0, 0, 0, ys_rows * size - m))
    xsh, y_cur = comms.shard(xp), comms.shard(yp)
    out = comms.map(lambda r, xr: torch.zeros(
        (xs_rows, ys_rows * size), dtype=torch.float32, device=xr.device),
        xsh)
    for step in range(size):
        # after `step` shifts, rank r holds y's shard (r - step) mod size
        def tile(r, xr, yr, o):
            src = (r - step) % size
            o[:, src * ys_rows:(src + 1) * ys_rows] = pairwise_core(
                xr, yr, m_).to(torch.float32)
        comms.map(tile, xsh, y_cur, out)
        if step < size - 1:  # the last rotation would never be read
            y_cur = comms.shift(y_cur, 1)
    return [o[:max(0, min(xs_rows, n - r * xs_rows)), :m]
            for r, o in enumerate(out)]


# ------------------------------------------------------- sharded k-means


def _initial_rows(generator: torch.Generator, n: int,
                  n_clusters: int) -> torch.Tensor:
    """The k-means init's rows: ``n_clusters`` distinct row indices drawn
    uniformly (the JAX package draws them with ``jax.random.choice``, which
    torch cannot replay; a test hands both packages the same rows)."""
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:n_clusters]


def _donor_rows(generator: torch.Generator, n: int,
                donor_pool: int) -> torch.Tensor:
    """The rescue's donor pool: ``donor_pool`` row indices drawn uniformly
    with replacement (``jax.random.randint`` in the JAX package)."""
    return torch.randint(0, n, (donor_pool,), generator=generator,
                         device=generator.device)


def _local_sums(x_loc, labels, n_clusters: int):
    """Per-cluster row sums and counts of one rank, summed in row order (a
    stable sort by label, then a segment sum), the same on every run."""
    if x_loc.shape[0] == 0:
        return (x_loc.new_zeros((n_clusters, x_loc.shape[1])),
                x_loc.new_zeros((n_clusters,)))
    lab = labels.to(torch.int64)
    order = torch.argsort(lab, stable=True)
    lengths = torch.bincount(lab, minlength=n_clusters)
    sums = torch.segment_reduce(x_loc[order], "sum", lengths=lengths)
    return sums, lengths.to(torch.float32)


def _assign(x_loc, centers):
    """Labels by ``‖c‖² − 2·x·c`` (the row norm does not move the argmin),
    lowest cluster on ties."""
    cn = (centers * centers).sum(-1)
    d = cn[None, :] - 2.0 * dot_fp32(x_loc, centers)
    return torch.argmin(d, dim=1)


def _rescue(it: int, new_c, counts, donors, n: int, n_clusters: int,
            balance_threshold: float):
    """Re-seed the clusters whose global size is at most ``threshold·n/K``
    toward a donor row from a cluster of at least average size:
    (wc·center[donor's cluster] + donor)/(wc + 1), wc = min(size, 7)."""
    avg = torch.tensor(float(n), dtype=torch.float32) / n_clusters
    starving = counts <= avg * torch.tensor(balance_threshold,
                                            dtype=torch.float32)
    big = counts >= avg
    dlab = _assign(donors, new_c)
    pool_ok = big[dlab]
    order = torch.argsort((~pool_ok).to(torch.int8), stable=True)
    drows, dlab = donors[order], dlab[order]
    n_good = pool_ok.to(torch.int64).sum()
    slot = ((torch.arange(n_clusters, device=new_c.device) + it * 131)
            % torch.clamp_min(n_good, 1))
    have = (n_good > 0) & starving
    wc = torch.clamp_max(counts, 7.0)[:, None]
    resc = (wc * new_c[dlab[slot]] + drows[slot]) / (wc + 1.0)
    return torch.where(have[:, None], resc, new_c)


@tracing.range("sharded.kmeans_fit")
def kmeans_fit(comms: Comms, x, n_clusters: int, n_iters: int = 20,
               res: Optional[Resources] = None,
               balance_threshold: Optional[float] = None,
               donor_pool: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data-parallel Lloyd k-means over a row-sharded dataset (cuML's MNMG
    k-means over raft::comms): per rank the E-step (one fp32 product and an
    argmin) and the per-cluster sums in row order, then an ``allreduce`` in
    rank order of the sums and counts; ``n_iters`` iterations, no early
    stop. The init takes ``n_clusters`` distinct rows drawn from ``res``'s
    generator. ``balance_threshold`` turns on the rescue of small clusters
    from a donor pool drawn once (``kmeans_balanced``'s adjust_centers fed by
    the global counts). Returns (centers [K, dim], labels [n] int32), on
    rank 0's device."""
    if res is None:
        res = Resources(device=comms.devices[0])
    x = _as_tensor(x).to(torch.float32)
    n = x.shape[0]
    size = comms.size
    shard = cdiv(n, size)
    init = _initial_rows(res.generator, n, n_clusters).to(x.device)
    centers = comms.shard(x[torch.sort(init).values], None)
    balanced = balance_threshold is not None
    donors = (comms.shard(x[_donor_rows(res.generator, n, donor_pool)
                            .to(x.device)], None) if balanced
              else [None] * size)
    xs = [x[min(r * shard, n):min((r + 1) * shard, n)].to(d)
          for r, d in enumerate(comms.devices)]
    for it in range(n_iters):
        parts = comms.map(lambda r, xl, c: _local_sums(xl, _assign(xl, c),
                                                       n_clusters),
                          xs, centers)
        sums = comms.allreduce([p[0] for p in parts])
        counts = comms.allreduce([p[1] for p in parts])

        def update(r, s, cnt, c, dn):
            new_c = torch.where((cnt > 0)[:, None],
                                s / torch.clamp_min(cnt, 1.0)[:, None], c)
            if balanced:
                new_c = _rescue(it, new_c, cnt, dn, n, n_clusters,
                                float(balance_threshold))
            return new_c

        centers = comms.map(update, sums, counts, centers, donors)
    labels = comms.map(lambda r, xl, c: _assign(xl, c).to(torch.int32),
                       xs, centers)
    d0 = comms.devices[0]
    return centers[0], torch.cat([l.to(d0) for l in labels])


# ---------------------------------------------------------- sharded IVF


def _globalize(ids: torch.Tensor, lo: int) -> torch.Tensor:
    return torch.where(ids >= 0, ids + int(lo), -1).to(torch.int32)


class ShardedIvfFlat:
    """An IVF-Flat index over the ranks of ``comms``: ``indexes[r]`` is rank
    r's single-device index over its row shard, on ``comms.devices[r]``,
    with global row ids (lists and overflow block)."""

    def __init__(self, comms: Comms, indexes: List[ivf_flat.Index],
                 metric: DistanceType, n_rows: int, bounds):
        self.comms = comms
        self.indexes = list(indexes)
        self.metric = metric
        self.n_rows = int(n_rows)
        self.bounds = np.asarray(bounds, np.int64)  # [S+1] row offsets


@tracing.range("sharded.build_ivf_flat")
def build_ivf_flat(comms: Comms, dataset,
                   params: Optional[ivf_flat.IndexParams] = None,
                   res: Optional[Resources] = None) -> ShardedIvfFlat:
    """Build one IVF-Flat index per rank over ``shard_bounds`` row spans,
    with global ids (each rank's build is the single-device build)."""
    params = params or ivf_flat.IndexParams()
    dataset = _as_tensor(dataset)
    n = dataset.shape[0]
    bounds = shard_bounds(comms.size, n)
    _check_n_lists(bounds, params.n_lists, n, comms.size)

    def one(r, rank_res):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        idx = ivf_flat.build(dataset[lo:hi], params, res=rank_res)
        idx.list_indices = _globalize(idx.list_indices, lo)
        idx.overflow_indices = _globalize(idx.overflow_indices, lo)
        return idx

    return ShardedIvfFlat(comms, _map_shards(comms, one, res), params.metric,
                          n, bounds)


@tracing.range("sharded.search_ivf_flat")
def search_ivf_flat(index: ShardedIvfFlat, queries, k: int,
                    params: Optional[ivf_flat.SearchParams] = None,
                    res: Optional[Resources] = None,
                    merge_mode: str = "auto"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank searches its index with the replicated queries (the
    port's ``ivf_flat.search``: ``fused_ivf_topk`` for L2 requests), then
    the plan merges the ranks' top-k. Returns (distances, global ids) on
    rank 0's device."""
    params = params or ivf_flat.SearchParams()
    comms = index.comms
    minimize = is_min_close(index.metric)
    q = comms.shard(_as_tensor(queries), None)
    plan = plan_sharded_search(comms, q[0].shape[0], int(k), int(k),
                               merge_mode=merge_mode, mask_invalid=True)
    return _search_and_merge(
        comms, "ivf_flat", lambda r, q_r, idx: ivf_flat.search(
            idx, q_r, int(k), params, res=_rank_resources(res, idx.device)),
        (q, index.indexes), plan, minimize, merge_mode,
        {"n_probes": int(min(params.n_probes, index.indexes[0].n_lists))})


class ShardedIvfPq:
    """An IVF-PQ index over the ranks of ``comms``: ``indexes[r]`` is rank
    r's single-device index, with global row ids. ``scan_mode`` is the
    memory regime it was built for: ``"cache"`` keeps each rank's decoded
    scan cache resident beside its packed codes (``fused_ivf_topk``),
    ``"lut"`` only the packed codes (``fused_pq_topk``)."""

    def __init__(self, comms: Comms, indexes: List[ivf_pq.Index],
                 metric: DistanceType, n_rows: int, bounds,
                 scan_mode: str = "cache"):
        if scan_mode not in ("cache", "lut"):
            raise ValueError(f"unknown scan_mode: {scan_mode!r}")
        self.comms = comms
        self.indexes = list(indexes)
        self.metric = metric
        self.n_rows = int(n_rows)
        self.bounds = np.asarray(bounds, np.int64)
        self.scan_mode = scan_mode


@tracing.range("sharded.build_ivf_pq")
def build_ivf_pq(comms: Comms, dataset,
                 params: Optional[ivf_pq.IndexParams] = None,
                 res: Optional[Resources] = None, scan_mode: str = "cache",
                 scan_cache_dtype=torch.bfloat16) -> ShardedIvfPq:
    """Build one IVF-PQ index per rank over ``shard_bounds`` row spans, with
    global ids. ``scan_mode="cache"`` decodes each rank's scan cache (in
    ``scan_cache_dtype``); ``"lut"`` keeps only the packed codes. A rank
    with spilled rows decodes its overflow block in ``scan_cache_dtype``."""
    if scan_mode not in ("cache", "lut"):
        raise ValueError(f"unknown scan_mode: {scan_mode!r}")
    params = params or ivf_pq.IndexParams()
    dataset = _as_tensor(dataset)
    n = dataset.shape[0]
    bounds = shard_bounds(comms.size, n)
    _check_n_lists(bounds, params.n_lists, n, comms.size)

    def one(r, rank_res):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        idx = ivf_pq.build(dataset[lo:hi], params, res=rank_res)
        idx.list_indices = _globalize(idx.list_indices, lo)
        idx.overflow_indices = _globalize(idx.overflow_indices, lo)
        ivf_pq.ensure_overflow_decoded(idx, scan_cache_dtype)
        if scan_mode == "cache":
            ivf_pq.ensure_scan_cache(idx, scan_cache_dtype)
        return idx

    return ShardedIvfPq(comms, _map_shards(comms, one, res), params.metric,
                        n, bounds, scan_mode)


def _resolve_pq_scan_mode(params: ivf_pq.SearchParams,
                          index: ShardedIvfPq) -> str:
    """``"auto"`` (and ``"pallas"``) follow the regime the index was built
    for; ``"cache"``/``"lut"`` name one."""
    mode = params.scan_mode
    if mode not in ("auto", "pallas", "cache", "lut"):
        raise ValueError(f"unknown scan_mode: {mode!r}")
    return index.scan_mode if mode in ("auto", "pallas") else mode


@tracing.range("sharded.search_ivf_pq")
def search_ivf_pq(index: ShardedIvfPq, queries, k: int,
                  params: Optional[ivf_pq.SearchParams] = None,
                  res: Optional[Resources] = None, merge_mode: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank searches its index in the memory regime of ``params``'
    ``scan_mode`` (``"auto"``: the one the index was built for) through the
    port's ``ivf_pq`` engines (the fused kernel of that regime where the
    request allows), then the plan merges the ranks' top-k. Returns
    (distances, global ids) on rank 0's device."""
    params = params or ivf_pq.SearchParams()
    comms = index.comms
    minimize = is_min_close(index.metric)
    mode = _resolve_pq_scan_mode(params, index)
    local_params = dataclasses.replace(params, scan_mode="auto")
    q = comms.shard(_as_tensor(queries), None)
    plan = plan_sharded_search(comms, q[0].shape[0], int(k), int(k),
                               merge_mode=merge_mode, mask_invalid=True)
    return _search_and_merge(
        comms, "ivf_pq", lambda r, q_r, idx: ivf_pq.search(
            idx, q_r, int(k), local_params,
            res=_rank_resources(res, idx.device), memory_mode=mode),
        (q, index.indexes), plan, minimize, merge_mode,
        {"n_probes": int(min(params.n_probes, index.indexes[0].n_lists))})


# ------------------------------------------------------------ not ported


def _deferred(name: str, what: str):
    def raise_deferred(*_args, **_kwargs):
        raise NotImplementedError(
            f"sharded.{name} is not ported yet: {what} (ROADMAP Queue A "
            "item 13)")
    raise_deferred.__name__ = name
    return raise_deferred


build_cagra = _deferred("build_cagra", "sharded CAGRA")
search_cagra = _deferred("search_cagra", "sharded CAGRA")
build_ivf_flat_from_file = _deferred("build_ivf_flat_from_file",
                                     "the from-file builds")
build_ivf_pq_from_file = _deferred("build_ivf_pq_from_file",
                                   "the from-file builds")
build_ivf_pq_from_file_pod = _deferred("build_ivf_pq_from_file_pod",
                                       "the pod build")
serialize_ivf_flat = _deferred("serialize_ivf_flat", "persistence")
deserialize_ivf_flat = _deferred("deserialize_ivf_flat", "persistence")
deserialize_ivf_flat_elastic = _deferred("deserialize_ivf_flat_elastic",
                                         "elastic restore")
serialize_ivf_pq = _deferred("serialize_ivf_pq", "persistence")
deserialize_ivf_pq = _deferred("deserialize_ivf_pq", "persistence")
deserialize_ivf_pq_elastic = _deferred("deserialize_ivf_pq_elastic",
                                       "elastic restore")
verify_checkpoint = _deferred("verify_checkpoint", "persistence")
load_manifest = _deferred("load_manifest", "persistence")
