"""NN-descent — all-neighbours kNN-graph construction.

Counterpart of ``raft_tpu.neighbors.nn_descent``, with the same rounds:
each node expands its closest still-new neighbours (and marks them joined)
and a sample of its reverse neighbours, adds a few random candidates,
scores every candidate exactly, and keeps the top ``k`` of the union by a
flagged merge that suppresses duplicates and self loops. Rounds stop at
``max_iterations`` or when the share of changed graph entries falls to
``termination_threshold``.

The JAX package's ``lax.map`` over node tiles is a Python loop over tiles
here, sized by the same workspace formula; results do not depend on the
tile. Random draws come from ``Resources.generator``, so a build differs
from the JAX package's in its random numbers and is held to it by graph
recall, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import (DistanceType, gathered_distances,
                                         resolve_metric, row_norms_sq)
from raft_tpu_torch.ops.select_k import (merge_topk_dedup,
                                         merge_topk_dedup_flagged)
from raft_tpu_torch.utils.shape import as_query_array


@dataclasses.dataclass
class IndexParams:
    """graph_degree, intermediate_graph_degree, max_iterations,
    termination_threshold and the metric, as in the JAX package."""

    graph_degree: int = 64
    intermediate_graph_degree: int = 128
    max_iterations: int = 20
    termination_threshold: float = 0.0001
    metric: DistanceType = DistanceType.L2Expanded

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if self.metric not in (DistanceType.L2Expanded,
                               DistanceType.L2SqrtExpanded,
                               DistanceType.InnerProduct,
                               DistanceType.CosineExpanded):
            raise ValueError(
                f"nn_descent supports L2/IP/Cosine, got {self.metric.name}")


def _minimized(x, norms, rows, cand, metric: DistanceType) -> torch.Tensor:
    """d(x[rows[i]], x[cand[i, j]]) as the quantity to minimise (IP
    negated); ``norms`` are the rows' squared norms, gathered instead of
    recomputed from the gathered rows."""
    c = cand.clamp_min(0).long()
    d = gathered_distances(x[rows], x[c], metric, norms[c])
    return -d if metric == DistanceType.InnerProduct else d


def _candidate_distances(x, norms, cand, metric: DistanceType,
                         node_tile: int):
    """d(i, cand[i, j]) for all i, tiled over nodes."""
    out = []
    for s in range(0, x.shape[0], node_tile):
        rows = torch.arange(s, min(s + node_tile, x.shape[0]),
                            device=x.device)
        out.append(_minimized(x, norms, rows, cand[s:s + node_tile], metric))
    return torch.cat(out)


def _merge_topk(graph, dists, cand, cand_d, k: int):
    """Top-k of the union of the graph and candidate lists, duplicates and
    self loops suppressed."""
    n = graph.shape[0]
    return merge_topk_dedup(
        torch.cat([graph, cand], 1), torch.cat([dists, cand_d], 1), k,
        exclude_ids=torch.arange(n, device=graph.device))


def scatter_last_wins(n_rows: int, n_cols: int, rows, cols, values,
                      fill: int = -1) -> torch.Tensor:
    """out [n_rows, n_cols] with ``out[rows[e], cols[e]] = values[e]``,
    where the largest ``e`` wins a collision (the order of JAX's serial
    scatter). Rows outside [0, n_rows) are dropped. ``index_put_`` with
    duplicate indices leaves the winner unspecified, so the winner is made
    explicit: per cell, the largest edge index by ``scatter_reduce``."""
    rows, cols, values = rows.reshape(-1), cols.reshape(-1), values.reshape(-1)
    keep = (rows >= 0) & (rows < n_rows)
    e = torch.arange(rows.numel(), device=rows.device)
    cell = rows.clamp(0, n_rows - 1).to(torch.int64) * n_cols + cols
    win = torch.full((n_rows * n_cols,), -1, dtype=torch.int64,
                     device=rows.device)
    win.scatter_reduce_(0, torch.where(keep, cell, 0), torch.where(keep, e, -1),
                        reduce="amax")
    out = torch.where(win >= 0, values[win.clamp_min(0)], fill)
    return out.view(n_rows, n_cols).to(values.dtype)


def _reverse_sample(generator, graph, n_rev: int):
    """Each edge (i→j) lands in a random one of j's ``n_rev`` reverse slots;
    the later edge wins a slot, so a random subset survives. Invalid (-1)
    edges are dropped."""
    n, k = graph.shape
    slots = torch.randint(0, n_rev, (n, k), generator=generator,
                          device=graph.device)
    src = torch.arange(n, dtype=torch.int32,
                       device=graph.device)[:, None].expand(n, k)
    tgt = torch.where(graph >= 0, graph, n)
    return scatter_last_wins(n, n_rev, tgt, slots, src)


def _join_tile(x, norms, ids_t, g_t, d_t, f_t, rev_t, rand_t, nb, metric, k: int,
               fwd_expand: int, rev_expand: int):
    """One node tile of a round: candidates from the closest still-new
    forward neighbours (marked joined), the sampled reverse neighbours'
    lists, the reverse neighbours themselves and random nodes; exact
    distances; the flagged merge."""
    t = ids_t.shape[0]
    # new neighbours first, in rank order (entries stay distance-sorted)
    order = torch.sort((f_t | (g_t < 0)).to(torch.int8), dim=1,
                       stable=True).indices
    pick = order[:, :fwd_expand]
    fwd = torch.gather(g_t, 1, pick)
    fwd_ok = torch.gather((g_t >= 0) & ~f_t, 1, pick)
    f_t = f_t.scatter(1, pick, True)
    fwd_nofn = nb[fwd.clamp_min(0)].reshape(t, fwd_expand * k)
    fwd_nofn = torch.where(fwd_ok.repeat_interleave(k, dim=1), fwd_nofn, -1)
    rexp = rev_t[:, :rev_expand]
    rev_nofn = nb[rexp.clamp_min(0)].reshape(t, rev_expand * k)
    rev_nofn = torch.where((rexp >= 0).repeat_interleave(k, dim=1), rev_nofn,
                           -1)
    cand = torch.cat([fwd_nofn, rev_nofn, rev_t, rand_t], 1)
    cand = torch.where(cand == ids_t[:, None], -1, cand)
    cd = _minimized(x, norms, ids_t.long(), cand, metric)
    cd = torch.where(cand < 0, torch.inf, cd)
    return merge_topk_dedup_flagged(
        torch.cat([g_t, cand], 1), torch.cat([d_t, cd], 1),
        torch.cat([f_t, torch.zeros_like(cand, dtype=torch.bool)], 1), k)


def _build(generator, x, term_threshold: float, k: int, n_iters: int,
           metric: DistanceType, node_tile: int, fwd_expand: int,
           rev_expand: int, rev_sample: int):
    n = x.shape[0]
    dev = x.device
    # init: random neighbours, every surviving edge "new"
    graph = torch.randint(0, n, (n, k), generator=generator, device=dev,
                          dtype=torch.int32)
    norms = row_norms_sq(x)
    d0 = _candidate_distances(x, norms, graph, metric, node_tile)
    graph, dists = _merge_topk(
        torch.full((n, k), -1, dtype=torch.int32, device=dev),
        torch.full((n, k), torch.inf, device=dev), graph, d0, k)
    flags = torch.zeros((n, k), dtype=torch.bool, device=dev)
    node_ids = torch.arange(n, dtype=torch.int32, device=dev)
    rate, it = 1.0, 0
    # the JAX package compares the float32 rate with a float32 threshold
    term_threshold = float(np.float32(term_threshold))
    while it < n_iters and rate > term_threshold:
        rev = _reverse_sample(generator, graph, rev_sample)
        rand = torch.randint(0, n, (n, 8), generator=generator, device=dev,
                             dtype=torch.int32)
        nb = graph.clamp_min(0)
        parts = [
            _join_tile(x, norms, node_ids[s:s + node_tile], graph[s:s + node_tile],
                       dists[s:s + node_tile], flags[s:s + node_tile],
                       rev[s:s + node_tile], rand[s:s + node_tile], nb, metric,
                       k, fwd_expand, rev_expand)
            for s in range(0, n, node_tile)]
        new_graph = torch.cat([p[0] for p in parts])
        dists = torch.cat([p[1] for p in parts])
        flags = torch.cat([p[2] for p in parts])
        rate = float((new_graph != graph).to(torch.float32).mean())
        graph = new_graph
        it += 1
    return graph, dists, it


class Index:
    """The [n, graph_degree] neighbour matrix, its distances (minimised
    quantity, ascending) and the metric."""

    def __init__(self, graph, distances, metric: DistanceType,
                 n_iterations: int = 0):
        self.graph = graph
        self.distances = distances
        self.metric = metric
        #: rounds the build ran
        self.n_iterations = n_iterations


def plan_build(n: int, dim: int, k_inter: int, workspace_limit_bytes: int):
    """The build's candidate sizing and node tile, as the JAX package
    computes them: ``(fwd_expand, rev_expand, rev_sample, node_tile)``."""
    fwd_expand = min(int(np.clip(768 // max(k_inter, 1), 3, 12)), k_inter)
    rev_expand = min(int(np.clip(384 // max(k_inter, 1), 2, 6)), k_inter)
    rev_sample = min(max(k_inter // 2, 16), 64)
    n_cand = (fwd_expand + rev_expand) * k_inter + rev_sample + 8
    per_node = n_cand * (dim + 8) * 4 * 2
    node_tile = int(np.clip(workspace_limit_bytes // max(per_node, 1),
                            64, 4096))
    node_tile -= node_tile % 8
    return fwd_expand, rev_expand, rev_sample, max(node_tile, 8)


@tracing.range("nn_descent.build")
def build(dataset, params: Optional[IndexParams] = None,
          res: Optional[Resources] = None, device=None) -> Index:
    """Build the kNN graph. Runs on CUDA unless ``device="cpu"`` (or
    ``res``) says otherwise."""
    params = params or IndexParams()
    res = ensure_resources(res, device)
    x = as_query_array(dataset, res.device, torch.float32)
    n, dim = x.shape
    k_inter = int(min(params.intermediate_graph_degree, n - 1))
    k_out = int(min(params.graph_degree, k_inter))
    fwd_expand, rev_expand, rev_sample, node_tile = plan_build(
        n, dim, k_inter, res.workspace_limit_bytes)
    graph, dists, n_iter = _build(
        res.generator, x, float(params.termination_threshold), k_inter,
        int(params.max_iterations), params.metric, node_tile, fwd_expand,
        rev_expand, rev_sample)
    return Index(graph[:, :k_out].contiguous(),
                 dists[:, :k_out].contiguous(), params.metric, n_iter)
