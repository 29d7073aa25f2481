"""Minimum spanning tree (forest): Borůvka over an edge list (counterpart of
``raft_tpu.sparse.mst``; RAFT's sparse/mst/mst_solver.cuh).

Each round: (1) each component's lightest outgoing edge, by three
scatter-mins (``scatter_reduce(..., "amin")``: the weight, then the
canonical endpoints (lo, hi) of the edges at that weight, a strict total
order that is the same for both directions of an edge and so never closes
a cycle); (2) the union, the larger component label pointing at the
smaller; (3) pointer jumping to flatten the labels. A min is exact in any
order, so the selected set is the JAX package's bit for bit, on the CPU and
on the card alike. The round and jump counts are static,
``ceil(log2 n) + 1`` (components at least halve each round). Scatters to
the JAX package's dropped index ``n`` land in one spare slot that is sliced
off. The two directions of each selected edge are merged on the host
(``canonical_edges``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.sparse.types import COO


def _scatter_min(n: int, fill, index: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """[n] of ``fill`` lowered to the min of ``values`` at ``index``."""
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, index, values, "amin", include_self=True)


def boruvka(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, n: int,
            n_rounds: int, n_jumps: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Borůvka's rounds over the directed edges (u, v, w) of n vertices →
    ``(component [n] int64, selected [n_edges] bool)``."""
    u, v = u.to(torch.int64), v.to(torch.int64)
    lo_e = torch.minimum(u, v)
    hi_e = torch.maximum(u, v)
    comp = torch.arange(n, dtype=torch.int64, device=u.device)
    selected = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for _ in range(n_rounds):
        cu, cv = comp[u], comp[v]
        alive = cu != cv
        w_eff = torch.where(alive, w, torch.inf)
        # pass 1: each component's lightest outgoing weight
        is_min = alive & (w_eff == _scatter_min(n, torch.inf, cu, w_eff)[cu])
        # passes 2 and 3: the lexicographic (lo, hi) tie-break
        lo_eff = torch.where(is_min, lo_e, n)
        is_min2 = is_min & (lo_e == _scatter_min(n, n, cu, lo_eff)[cu])
        hi_eff = torch.where(is_min2, hi_e, n)
        chosen = is_min2 & (hi_e == _scatter_min(n, n, cu, hi_eff)[cu])
        selected |= chosen
        # union: the larger component label points at the smaller; index n
        # is the spare slot of the edges not chosen
        parent = torch.arange(n + 1, dtype=torch.int64, device=u.device)
        parent.scatter_reduce_(0, torch.where(chosen, torch.maximum(cu, cv), n),
                               torch.where(chosen, torch.minimum(cu, cv), n),
                               "amin", include_self=True)
        parent = parent[:n]
        for _ in range(n_jumps):
            parent = parent[parent]
        comp = parent[comp]
    return comp, selected


def canonical_edges(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    selected: torch.Tensor, n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The selected directed edges as one canonical (src < dst) edge each,
    the first in edge order, padded with (-1, -1, inf) to n - 1; merged on
    the host (int64 keys)."""
    e = torch.nonzero(selected).flatten().cpu().numpy()
    un = u[e].cpu().numpy().astype(np.int64)
    vn = v[e].cpu().numpy().astype(np.int64)
    wn = w[e].cpu().numpy()
    lo, hi = np.minimum(un, vn), np.maximum(un, vn)
    _, first = np.unique(lo * n + hi, return_index=True)
    keep = np.sort(first)
    m = n - 1
    src = np.full((m,), -1, np.int32)
    dst = np.full((m,), -1, np.int32)
    wt = np.full((m,), np.inf, np.float32)
    cnt = min(len(keep), m)
    src[:cnt] = lo[keep[:cnt]]
    dst[:cnt] = hi[keep[:cnt]]
    wt[:cnt] = wn[keep[:cnt]]
    dev = w.device
    return (torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
            torch.from_numpy(wt).to(dev))


def mst(graph: COO) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The MST (a forest where the graph is disconnected) of a weighted
    undirected graph given as a symmetric COO edge list → ``(src, dst,
    weight)`` of the selected edges in canonical (src < dst) direction,
    padded with (-1, -1, inf) to n - 1 (mst_solver.cuh's Graph_COO output),
    on the graph's device."""
    n = graph.shape[0]
    u, v, w = as_tensors(graph.rows, graph.cols, graph.data)
    w = w.to(torch.float32)
    n_rounds = max(int(math.ceil(math.log2(max(n, 2)))) + 1, 1)
    _, selected = boruvka(u, v, w, n, n_rounds, n_rounds)
    return canonical_edges(u, v, w, selected, n)
