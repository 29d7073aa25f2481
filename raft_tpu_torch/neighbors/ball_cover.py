"""Random ball cover: landmark-pruned exact kNN (counterpart of
``raft_tpu.neighbors.ball_cover``).

RAFT's ``raft::neighbors::ball_cover`` (neighbors/ball_cover-inl.cuh; types
ball_cover_types.hpp:35-92: √n sampled landmarks, each with the list of the
rows nearest to it and the list's radius; the triangle-inequality-pruned
scan passes of spatial/knn/detail/ball_cover/registers-inl.cuh), for the L2
metrics and haversine, as in RAFT. cuML's ``NearestNeighbors(algorithm=
"rbc")`` and its haversine search sit on it.

The index is an IVF-like padded layout ([L, pad, dim] member lists, their
ids and sizes, and the radii in the rooted metric). ``knn`` is the JAX
package's two-pass search with a host decision between the passes:

- **pass 1** scans the ``n_init_probes`` nearest landmarks' lists of each
  query for a k-th distance;
- **the host** drops every list whose bound d(q, landmark) − radius
  reaches a query's k-th distance: such a list cannot improve it;
- **pass 2** scans the lists some query still needs, under a mask per
  query, and selects over the pass-1 best and those candidates.

Both passes run in query chunks sized by ``res.workspace_limit_bytes``.
Pass 2 takes the queries in the order of their nearest landmark, so the
queries of a chunk lie close together, and each chunk scans only the union
of the lists its own queries need. That changes no answer: a query's
candidates are its pass-1 best followed by its own needed lists' rows in
ascending list order, whatever the chunk, so the selection (ties to the
lower position) returns the same entries as one chunk would. ``eps_nn``
prunes whole lists by the same bound, with the JAX package's slack for the
rounding of the expanded L2, and scans its queries in tiles within the
workspace budget, sorted and each over its own union in the same way.

``build`` draws the landmarks through the module-level helper
``_landmark_rows`` (a test may replace it with the JAX package's draw) and
packs the lists with ``native.pack_lists``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops import rng
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.utils.shape import as_query_array, round_up_to

_SUPPORTED = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
              DistanceType.Haversine)


class BallCoverIndex:
    """Landmarks, padded member lists and radii (ball_cover_types.hpp)."""

    def __init__(self, landmarks, list_data, list_indices, list_sizes, radii,
                 metric: DistanceType, n_rows: int):
        self.landmarks = landmarks  # [L, dim]
        self.list_data = list_data  # [L, pad, dim]
        self.list_indices = list_indices  # [L, pad] int32
        self.list_sizes = list_sizes  # [L] int32
        self.radii = radii  # [L] largest member distance (rooted metric)
        self.metric = metric
        self.n_rows = n_rows

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def device(self) -> torch.device:
        return self.landmarks.device


def _rooted_dist(q, pts, metric: DistanceType) -> torch.Tensor:
    """Distances [t, C] in the rooted metric, where the triangle inequality
    holds (haversine, or the square root of the expanded L2), between the
    queries q [t, dim] and points [C, dim] or each query's own [t, C, dim].

    Each distance is computed elementwise (the dot product as a sum over
    the coordinates, not a matrix product), so a (query, point) pair gets
    the same bits whatever the chunk of queries and points around it: pass
    1, pass 2 and any chunking agree exactly."""
    qf, pf = q.to(torch.float32), pts.to(torch.float32)
    pb = pf if pf.dim() == 3 else pf[None]
    if metric == DistanceType.Haversine:
        lat1, lon1 = qf[:, 0:1], qf[:, 1:2]
        lat2, lon2 = pb[..., 0], pb[..., 1]
        sin_dlat = torch.sin(0.5 * (lat2 - lat1))
        sin_dlon = torch.sin(0.5 * (lon2 - lon1))
        a = sin_dlat ** 2 + torch.cos(lat1) * torch.cos(lat2) * sin_dlon ** 2
        return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    dots = (qf[:, None, :] * pb).sum(-1)
    d = ((qf * qf).sum(-1)[:, None] + (pb * pb).sum(-1)) - 2.0 * dots
    return torch.sqrt(torch.clamp_min(d, 0.0))


def _landmark_rows(generator: torch.Generator, dataset: torch.Tensor,
                   n_landmarks: int) -> torch.Tensor:
    """The landmarks: a uniform sample of distinct rows, in row order
    (``ops.rng.subsample_rows``; the JAX package draws them from its key
    stream, which torch cannot replay, so a test hands both packages the
    same rows)."""
    return rng.subsample_rows(generator, dataset, n_landmarks)


def _chunk_rows(budget: int, bytes_per_row: int, n: int) -> int:
    """Rows a chunk so that a chunk's bytes stay within ``budget``."""
    return int(np.clip(budget // max(bytes_per_row, 1), 1, max(n, 1)))


def _union_chunks(needed: np.ndarray, order: np.ndarray, list_bytes: int,
                  budget: int, max_rows: int) -> list:
    """Cut the queries taken in ``order`` into runs [start, end) of at most
    ``max_rows``, each as long as its queries times the union of the lists
    they need, at ``list_bytes`` a list and query, stay within ``budget``
    (one query at least)."""
    chunks, start = [], 0
    union = np.zeros(needed.shape[1], bool)
    for pos, qi in enumerate(order):
        grown = union | needed[qi]
        rows = pos - start + 1
        if pos > start and (rows > max_rows or rows * int(grown.sum())
                            * list_bytes > budget):
            chunks.append((start, pos))
            start, union = pos, needed[qi].copy()
        else:
            union = grown
    chunks.append((start, len(order)))
    return chunks


def _nearest_landmarks(x, landmarks, metric: DistanceType, budget: int):
    """(label, rooted distance) of each row's nearest landmark (the first
    on a tie), in row chunks within ``budget``."""
    step = _chunk_rows(budget, landmarks.shape[0] * (x.shape[1] + 8) * 4,
                       x.shape[0])
    labels, dmin = [], []
    for s in range(0, x.shape[0], step):
        v, i = torch.min(_rooted_dist(x[s:s + step], landmarks, metric),
                         dim=1)
        labels.append(i)
        dmin.append(v)
    return torch.cat(labels), torch.cat(dmin)


@tracing.range("ball_cover.build")
def build(
    dataset,
    metric="euclidean",
    n_landmarks: Optional[int] = None,
    res: Optional[Resources] = None,
    device=None,
) -> BallCoverIndex:
    """Build (ball_cover::build_index): sample √n landmarks, assign every
    row to its nearest landmark, record each list's radius. On ``res``'s
    device (CUDA unless the caller asks for the CPU)."""
    res = ensure_resources(res, device)
    m = resolve_metric(metric)
    if m not in _SUPPORTED:
        raise ValueError(f"ball_cover supports L2/haversine, got {m.name}")
    dataset = as_query_array(dataset, res.device)
    n = dataset.shape[0]
    L = int(n_landmarks or max(int(math.sqrt(n)), 1))

    landmarks = _landmark_rows(res.generator, dataset, L).to(res.device)
    labels_t, dmin_t = _nearest_landmarks(dataset, landmarks, m,
                                          res.workspace_limit_bytes)
    labels = labels_t.cpu().numpy().astype(np.int32)
    dmin = dmin_t.cpu().numpy()
    sizes = np.bincount(labels, minlength=L).astype(np.int32)
    pad = max(int(round_up_to(max(int(sizes.max()), 1), 8)), 8)
    data, idxs, sizes = native.pack_lists(dataset.cpu().numpy(), labels, L,
                                          pad)
    radii = np.zeros((L,), np.float32)
    np.maximum.at(radii, labels, dmin)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(res.device)

    return BallCoverIndex(landmarks, t(data), t(idxs), t(sizes), t(radii), m,
                          n)


def _slot_valid(index: BallCoverIndex, lists: torch.Tensor) -> torch.Tensor:
    """[len(lists), pad]: the slots of ``lists`` that hold a row."""
    pad = index.list_data.shape[1]
    return (torch.arange(pad, device=index.device)[None, :]
            < index.list_sizes[lists][:, None])


def _pass1(q, index: BallCoverIndex, k: int, p: int):
    """Scan of each query's ``p`` nearest landmarks' lists → (best_d [t,
    kk], best_i [t, kk], landmark distances [t, L], probes [t, p])."""
    t, dim = q.shape
    lm_d = _rooted_dist(q, index.landmarks, index.metric)  # [t, L]
    _, probes = select_k(lm_d, p, select_min=True)
    pr = probes.to(torch.int64)
    qd = _rooted_dist(q, index.list_data[pr].reshape(t, -1, dim),
                      index.metric)
    d1 = torch.where(_slot_valid(index, pr.reshape(-1)).reshape(t, -1), qd,
                     torch.inf)
    i1 = index.list_indices[pr].reshape(t, -1)
    best_d, sel = select_k(d1, min(k, d1.shape[1]), select_min=True)
    return best_d, torch.gather(i1, 1, sel.to(torch.int64)), lm_d, probes


def _pass2(q, index: BallCoverIndex, sub: np.ndarray, needed: np.ndarray,
           best_d, best_i, k: int):
    """Selection over the pass-1 best and the rows of lists ``sub``
    (ascending), each query masked to the lists it ``needed`` [t, M]."""
    t = q.shape[0]
    pad, dim = index.list_data.shape[1:]
    sub_t = torch.from_numpy(sub).to(index.device)
    flat = index.list_data[sub_t].reshape(-1, dim)
    d_all = _rooted_dist(q, flat, index.metric)  # [t, M·pad]
    mask = (torch.from_numpy(needed).to(index.device)
            .repeat_interleave(pad, dim=1)
            & _slot_valid(index, sub_t).reshape(1, -1))
    d_all = torch.where(mask, d_all, torch.inf)
    i_all = index.list_indices[sub_t].reshape(1, -1).expand(t, -1)
    cat_d = torch.cat([best_d, d_all], dim=1)
    cat_i = torch.cat([best_i, i_all], dim=1)
    out_d, sel = select_k(cat_d, min(k, cat_d.shape[1]), select_min=True)
    return out_d, torch.gather(cat_i, 1, sel.to(torch.int64))


def _pad_k(d, i, k: int):
    """(d, i) widened to k columns with (inf, -1)."""
    if d.shape[1] < k:
        d = torch.cat([d, d.new_full((d.shape[0], k - d.shape[1]),
                                     torch.inf)], 1)
        i = torch.cat([i, i.new_full((i.shape[0], k - i.shape[1]), -1)], 1)
    return d, i


def _finalize(out_d, out_i, k: int, metric: DistanceType):
    out_d, out_i = _pad_k(out_d, out_i, k)
    if metric == DistanceType.L2Expanded:
        out_d = out_d * out_d  # unrooted output for sqeuclidean parity
    return out_d, out_i


@tracing.range("ball_cover.knn")
def knn(
    index: BallCoverIndex,
    queries,
    k: int,
    n_init_probes: Optional[int] = None,
    res: Optional[Resources] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN by the two-pass search (ball_cover::knn_query /
    all_knn_query) → (distances [nq, k] f32, ids [nq, k] int32), on the
    index's device."""
    res = ensure_resources(res, index.device)
    queries = as_query_array(queries, index.device, torch.float32)
    nq, dim = queries.shape
    k = int(k)
    L = index.n_landmarks
    pad = index.list_data.shape[1]
    p = int(n_init_probes or max(min(L, int(math.sqrt(L)) + 1), 1))
    p = min(max(p, 1), L)
    budget = res.workspace_limit_bytes

    # pass 1: a gathered [t, p·pad, dim] block and its distances a chunk
    step = _chunk_rows(budget, p * pad * (dim + 8) * 4 + L * 8, nq)
    parts = [_pass1(queries[s:s + step], index, k, p)
             for s in range(0, nq, step)]
    best_d, best_i, lm_d, probes = (torch.cat(c) for c in zip(*parts))

    # the host's pruning: the lists some query still needs (the bound
    # d(q, landmark) − radius below its k-th distance), less those pass 1
    # scanned
    kth = best_d[:, -1].cpu().numpy()
    probes_np = probes.cpu().numpy()
    needed = (lm_d.cpu().numpy() - index.radii.cpu().numpy()[None, :]
              < kth[:, None])
    np.put_along_axis(needed, probes_np.astype(np.int64), False, axis=1)
    if not needed.any():
        return _finalize(best_d, best_i, k, index.metric)

    # pass 2: query chunks in the order of their nearest landmark, each
    # over its own union of needed lists, within the budget
    order = np.argsort(probes_np[:, 0], kind="stable")
    out_d = best_d.new_full((nq, k), torch.inf)
    out_i = best_i.new_full((nq, k), -1)
    for s, e in _union_chunks(needed, order, pad * (dim + 8) * 4, budget,
                              nq):
        qsel = order[s:e]
        qsel_t = torch.from_numpy(qsel).to(index.device)
        need_c = needed[qsel]
        sub = np.nonzero(need_c.any(axis=0))[0]
        if len(sub):
            d_c, i_c = _pass2(queries[qsel_t], index, sub, need_c[:, sub],
                              best_d[qsel_t], best_i[qsel_t], k)
        else:
            d_c, i_c = best_d[qsel_t], best_i[qsel_t]
        d_c, i_c = _pad_k(d_c, i_c, k)
        out_d[qsel_t], out_i[qsel_t] = d_c, i_c
    return _finalize(out_d, out_i, k, index.metric)


@tracing.range("ball_cover.eps_nn")
def eps_nn(index: BallCoverIndex, queries, eps: float,
           res: Optional[Resources] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All rows within ``eps`` of each query (ball_cover::eps_nn,
    ball_cover-inl.cuh:313-365), ``eps`` in the rooted metric (true L2 or
    haversine). Returns (adjacency [nq, n_rows] bool, degrees [nq] int32),
    the shape of ``epsilon_neighborhood``'s output.

    Whole lists are pruned on the host by the bound d(q, landmark) −
    radius ≤ eps, with a small slack for the rounding of the expanded L2
    so that a boundary neighbour is never dropped; membership itself is an
    exact compare of the distance. Query tiles (in the order of the
    nearest landmark, within the workspace budget) each scan the union of
    the lists their own queries need."""
    res = ensure_resources(res, index.device)
    queries = as_query_array(queries, index.device)
    nq = queries.shape[0]
    L, pad, dim = index.list_data.shape
    lm_d = _rooted_dist(queries, index.landmarks, index.metric).cpu().numpy()
    radii = index.radii.cpu().numpy()[None, :]
    slack = 1e-3 * np.abs(lm_d) + 1e-3 * radii + 1e-5
    needed = (lm_d - radii - slack) <= eps
    adj = torch.zeros((nq, index.n_rows), dtype=torch.bool,
                      device=index.device)
    # query tiles in the order of the nearest landmark, each over the union
    # of the lists its own queries need, within the budget (at most 512
    # queries, as the JAX package's tiles)
    order = np.argsort(np.argmin(lm_d, axis=1), kind="stable")
    for s, e in _union_chunks(needed, order, pad * (dim + 8) * 4,
                              res.workspace_limit_bytes, 512):
        qsel = order[s:e]
        sub = np.nonzero(needed[qsel].any(axis=0))[0]
        if len(sub) == 0:
            continue
        sub_t = torch.from_numpy(sub).to(index.device)
        flat = index.list_data[sub_t].reshape(-1, dim)
        valid = _slot_valid(index, sub_t).reshape(1, -1)
        ids = torch.clamp_min(index.list_indices[sub_t].reshape(1, -1),
                              0).to(torch.int64)
        qsel_t = torch.from_numpy(qsel).to(index.device)
        hit = (_rooted_dist(queries[qsel_t], flat, index.metric)
               <= eps) & valid
        # max of 0/1 is an OR; padding slots (id 0, never a hit) add nothing
        rows = torch.zeros((len(qsel), index.n_rows), dtype=torch.uint8,
                           device=index.device)
        rows.scatter_reduce_(1, ids.expand(len(qsel), -1),
                             hit.to(torch.uint8), "amax")
        adj[qsel_t] = rows.to(torch.bool)
    return adj, adj.sum(dim=1).to(torch.int32)
