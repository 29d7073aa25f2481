"""Phase 6j of ``chip_smoke.py``: the graph layer on the card.

``phase(...)`` drives, at users' sizes, with ``allow_tf32`` off:

- ``single_linkage``: cuML's ``AgglomerativeClustering(connectivity="knn")``
  on SIFT-1M's shape, phase 3's 1,000,000 × 128 rows, ``connectivity_k``
  15, 1,000 clusters, through ``cluster.single_linkage.single_linkage``
  with its steps timed apart (the kNN graph, which launches
  ``fused_l2_topk`` at 1M × 1M × 128, k = 16; Borůvka's rounds; the host
  extraction; the labelling). Held to: the forest's total weight within
  1e-5 relative of ``scipy.sparse.csgraph.minimum_spanning_tree`` in
  float64 over the same graph on the host (the lighter direction of each
  pair, as scipy reads a matrix); the partition equal to the connected
  components of the graph's edges at or below the m-th smallest forest
  weight, m = min(n - 1,000, forest edges), when the m-th and (m+1)-th
  weights differ (a tie is reported, not compared); two card runs of
  ``mst`` bitwise equal, and the card's ``mst`` bitwise the CPU's on a
  100,000-edge sample of the graph.
- ``cross_component_nn``: the same rows coloured by those labels, through
  ``connect_components_edges`` (the 1-NN with each row as the source),
  timed;
  200 sampled rows against float64 numpy over all rows (distances within
  1e-5 of the largest ‖x‖², the rounding of an expanded L2 in fp32; ids
  equal where the float64 gap to the second-nearest other-colour row is
  more than twice that; at k = 1 ``assert_topk_close`` compares no id);
  ``connect_components_edges`` with the kNN graph leaves one component.
- ``sparse``: a TF-IDF-like CSR, 20,000 rows × 131,072 columns, about 130
  entries a row, Zipf (a = 1) column frequencies, smoothed idf, rows
  L2-normalised, and 2,000 query rows (a bag-of-words corpus such as 20
  Newsgroups under cuML's sparse ``NearestNeighbors``). ``knn`` at k = 10
  in cosine, Jaccard and expanded L2 (the ``select_k`` kernel over
  [2,000 × 20,000] rows): seconds, QPS, 500 sampled queries held by
  ``assert_topk_close`` against scipy's float64 products. ``pairwise_distance`` for every metric
  in ``SUPPORTED`` on a 32 × 1,000 block against float64 numpy within
  1e-5 of the block's largest |value| (each pair's sum over the columns
  either side touches; Hamming over the full width).
- ``spectral``: 20,000 rows drawn as 10 well-separated ``datagen``
  clusters (spread 4); their 16-NN graph (``fused_l2_topk``, k = 17 with
  self) splits into one component per cluster, and a spectral method
  needs a connected graph (one start vector's Krylov space holds one
  vector of a degenerate null space), so ``spectral_adjacency`` joins the
  components by ``connect_components_edges`` (the nearest row of another
  component, one edge a row), all weights 1. ``partition(adj, 10)``,
  ``partition(adj, 10, n_eig_vects=24)`` and ``modularity_maximization(adj,
  10)``, each held to: its Ritz values within 1e-5 of the largest of
  ``lanczos64``'s, the same Lanczos in float64 on the host from the start
  vector the run drew; the span of its embedding within a sine of 1e-3 of
  float64's where the Ritz values at the embedding's edges are 0.01 apart
  (reported otherwise); its labels the float64 nearest of k-means' final
  centres away from near-ties; labels in range, the embedding finite.
  Each one's contingency against the planted clusters (the diagonal share,
  one label per planted cluster) is recorded beside 0.99, not asserted:
  the JAX package's own runs of this graph on the CPU miss it too
  (``tests/_torch_spectral_reference.py``). k-means' E-step is
  ``fused_l2_argmin`` at d = 10 and 24 with 10 centres.
  ``analyze_partition`` of the planted partition against a float64 recount
  on the host (within 1e-6), of each run beside it. ``lanczos_smallest`` (ncv 64)
  over the normalised Laplacian I - D^-1/2 A D^-1/2 of phase 6i's
  16-NN graph of 100,000 rows: its first eigenvalue within 1e-4 of float64
  ``eigsh`` (1 - the largest eigenvalue of D^-1/2 A D^-1/2).
- ``lap``: ``solver.solve`` on a seeded 1,000 × 1,000 uniform fp32 cost: a
  full permutation, the total within n·eps of ``solve_host``'s optimum,
  its rounds and seconds, two card runs bitwise equal and bitwise the CPU
  port's assignment.
- ``labels``: ``make_monotonic`` and ``merge_labels`` of the 1M single
  linkage labels (merged with ``datagen``'s cluster ids) against numpy;
  ``resources_manager`` hands out card Resources round-robin;
  ``common.auto_sync_resources`` around ``brute_force.knn`` (bitwise the
  direct call); ``debug.checked`` passes ``ivf_flat.search`` on phase 4's
  index and raises on a NaN it is handed; ``debug_mode`` raises on a NaN.
  The wrapped calls are counted, the direct calls they are held to not.
- ``kernel rows``: ``fused_l2_topk`` at the single-linkage shape (held and
  timed on 10,000 of the 1M queries), ``fused_l2_argmin`` at 20,000 × 10 ×
  d 10 and 24, ``select_k`` at [2,000 × 20,000], k = 10: each against its
  plain version, with kernel, plain and (for ``select_k``) ``torch.topk``
  ms and the bound.
- ``graph_launches``: the phase's main-path launches by kernel (each
  counted call has the counts set to 0 just before it and read just
  after; references and holds run outside), asserted above 0 for
  ``fused_l2_topk``, ``select_k`` and ``fused_l2_argmin``.

Every line carries the card's name and power limit and the seconds since
the phase began (``phase_seconds``). A failed check prints
a ``check_failed`` line; the phase raises after its last line if any
did. ``phase`` returns the launches and the new kernel rows. Standalone (its own rows, and an
IVF-Flat index of 1,024 lists searched at 32 probes)::

    python3 -m raft_tpu_torch.bench.graph [--seed N]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from raft_tpu_torch.bench.breadth import _bitwise as _bitwise_one
from raft_tpu_torch.bench.breadth import _ms, _sync

#: single linkage: the kNN degree, the clusters; the determinism sample
SL_K, SL_CLUSTERS, DET_EDGES = 15, 1000, 100_000
#: cross-component 1-NN: rows held against float64
CC_SAMPLE = 200
#: the sparse corpus: rows, columns, Zipf draws a row (about 130 distinct
#: columns), queries, k, the pairwise block
SP_ROWS, SP_COLS, SP_DRAWS, SP_QUERIES, SP_K = 20_000, 131_072, 175, 2_000, 10
SP_BLOCK, SP_LP = (32, 1000), 3.0
#: the sparse kNN's queries held against scipy's float64 products
SP_HELD = 500
SP_METRICS = ("cosine", "jaccard", "sqeuclidean")
#: spectral: rows, clusters, datagen spread, the kNN degree, the partition
#: also run with more eigenvectors (ncv 100)
SPEC_ROWS, SPEC_CLUSTERS, SPEC_SPREAD, SPEC_K, SPEC_N_EIG = (
    20_000, 10, 4.0, 16, 24)
#: the spectral holds: the Ritz values against float64, relative to the
#: largest |Ritz value| (fp32 products of 20,000 terms); the embedding's
#: span where the Ritz gap at its edges allows; the k-means distances
#: (unit rows)
SPEC_RITZ_RTOL, SPEC_SIN_TOL, SPEC_GAP, SPEC_KM_TOL = 1e-5, 1e-3, 1e-2, 1e-5
#: the eigenpairs: graph rows, kNN degree, Lanczos steps
EIG_ROWS, EIG_K, EIG_NCV = 100_000, 16, 64
#: the assignment problem's size
LAP_N = 1000
#: phase 3's generator: rows and their width
N_ROWS, DIM = 1_000_000, 128
#: the workspace budget of the phase's calls: the card still holds the
#: earlier phases' indexes
WORKSPACE = 4 << 30
#: fused_l2_topk's hold: queries of the 1M held and timed
L2_SAMPLE = 10_000


def _bitwise(a, b) -> bool:
    """Two tuples of tensors bitwise equal."""
    return all(_bitwise_one(u, v) for u, v in zip(a, b))


def _tfidf(rng, n_rows: int, p: np.ndarray, perm: np.ndarray):
    """(rows, cols, term counts) of ``n_rows`` documents of ``SP_DRAWS``
    Zipf draws each, duplicates counted."""
    draws = perm[rng.choice(SP_COLS, size=(n_rows, SP_DRAWS), p=p)]
    keys, tf = np.unique((np.arange(n_rows, dtype=np.int64)[:, None]
                          * SP_COLS + draws).ravel(), return_counts=True)
    return keys // SP_COLS, keys % SP_COLS, tf.astype(np.float64)


def _csr64(rows, cols, vals, n_rows):
    """A scipy CSR of float64 values with each row L2-normalised."""
    from scipy.sparse import csr_matrix

    m = csr_matrix((vals, (rows, cols)), shape=(n_rows, SP_COLS))
    norms = np.sqrt(np.asarray(m.multiply(m).sum(axis=1)).ravel())
    return csr_matrix(m.multiply(1.0 / norms[:, None]))


def _corpus(rng):
    """The TF-IDF corpus and queries as scipy float64 CSRs."""
    p = 1.0 / np.arange(1, SP_COLS + 1)
    p /= p.sum()
    perm = rng.permutation(SP_COLS)
    dr, dc, dtf = _tfidf(rng, SP_ROWS, p, perm)
    qr, qc, qtf = _tfidf(rng, SP_QUERIES, p, perm)
    df = np.bincount(dc, minlength=SP_COLS)
    idf = np.log((1.0 + SP_ROWS) / (1.0 + df)) + 1.0
    return (_csr64(dr, dc, dtf * idf[dc], SP_ROWS),
            _csr64(qr, qc, qtf * idf[qc], SP_QUERIES))


def _pair_sums(xd, y, f):
    """Σ over the columns either side touches of f(x_c, y_c), f(0, 0) = 0,
    for each row of the dense float64 ``xd`` [a, D] and each row of the
    scipy CSR ``y`` [b, D]: at y's entries, plus x's entries where y is 0."""
    xe = xd[:, y.indices]
    starts = y.indptr[:-1]
    at_y = np.add.reduceat(f(xe, y.data[None, :]), starts, axis=1)
    x_only = np.where(xd != 0, f(xd, 0.0), 0.0).sum(1)
    x_at_y = np.add.reduceat(np.where(xe != 0, f(xe, 0.0), 0.0), starts,
                             axis=1)
    return at_y + x_only[:, None] - x_at_y


def _linf(xd, y):
    """max |x_c - y_c| over the columns either side touches."""
    xe = xd[:, y.indices]
    at_y = np.maximum.reduceat(np.abs(xe - y.data[None, :]), y.indptr[:-1],
                               axis=1)
    x_only = []
    for row in xd:  # max |x_c| over x's columns where y is 0
        cols = np.nonzero(row)[0]
        in_y = y[:, cols].toarray() != 0  # [b, nnz of the row]
        x_only.append(np.where(in_y, 0.0, np.abs(row[cols])[None, :]).max(
            1, initial=0.0))
    return np.maximum(at_y, np.stack(x_only))


def _safe_log(t):
    return np.log(np.where(t > 0, t, 1.0))


def _host_pairwise(metric: str, xd, y) -> np.ndarray:
    """raft_tpu's sparse metric ``metric`` in float64 numpy."""
    dot = _pair_sums(xd, y, lambda a, b: a * b)
    nx = (xd * xd).sum(1)[:, None]
    ny = np.asarray(y.multiply(y).sum(axis=1)).ravel()[None, :]
    if metric in ("L2Expanded", "L2Unexpanded"):
        return _pair_sums(xd, y, lambda a, b: (a - b) ** 2)
    if metric in ("L2SqrtExpanded", "L2SqrtUnexpanded"):
        return np.sqrt(_pair_sums(xd, y, lambda a, b: (a - b) ** 2))
    if metric == "InnerProduct":
        return dot
    if metric == "CosineExpanded":
        return 1.0 - dot / np.sqrt(nx * ny)
    if metric == "L1":
        return _pair_sums(xd, y, lambda a, b: np.abs(a - b))
    if metric == "Linf":
        return _linf(xd, y)
    if metric == "LpUnexpanded":
        return _pair_sums(xd, y, lambda a, b: np.abs(a - b) ** SP_LP) ** (
            1.0 / SP_LP)
    if metric == "Canberra":
        def can(a, b):
            den = np.abs(a) + np.abs(b)
            return np.where(den > 0, np.abs(a - b) / np.where(den > 0, den, 1),
                            0.0)
        return _pair_sums(xd, y, can)
    if metric == "HammingUnexpanded":
        return _pair_sums(xd, y, lambda a, b: (a != b).astype(np.float64)
                          ) / xd.shape[1]
    if metric == "JensenShannon":
        def js(a, b):
            log_m = _safe_log(0.5 * (a + b))
            return (np.where(a > 0, a * (_safe_log(a) - log_m), 0.0)
                    + np.where(b > 0, b * (_safe_log(b) - log_m), 0.0))
        return np.sqrt(np.maximum(0.5 * _pair_sums(xd, y, js), 0.0))
    if metric == "KLDivergence":
        return 0.5 * _pair_sums(xd, y, lambda a, b: np.where(
            a > 0, a * _safe_log(a), 0.0) - a * np.where(b > 0, _safe_log(b),
                                                        0.0))
    inter = _pair_sums(xd, y, lambda a, b: ((a != 0) & (b != 0)).astype(
        np.float64))
    cx = (xd != 0).sum(1)[:, None].astype(np.float64)
    cy = np.diff(y.indptr)[None, :].astype(np.float64)
    if metric == "JaccardExpanded":
        return 1.0 - inter / np.maximum(cx + cy - inter, 1.0)
    if metric == "DiceExpanded":
        return 1.0 - 2.0 * inter / np.maximum(cx + cy, 1.0)
    raise ValueError(metric)


def _topk64(d: np.ndarray, k: int):
    """The k smallest of each row of a float64 matrix, ascending, ties to
    the lower column (values as float32 for the hold)."""
    part = np.argpartition(d, k, axis=1)[:, :k]
    pv = np.take_along_axis(d, part, 1)
    order = np.lexsort((part, pv), axis=1)
    ids = np.take_along_axis(part, order, 1)
    return (np.take_along_axis(d, ids, 1).astype(np.float32),
            ids.astype(np.int64))


def _contingency(truth: np.ndarray, labels: np.ndarray, k: int) -> dict:
    """The planted clusters against the labels: the diagonal share (each
    planted cluster's largest label) and whether every planted cluster's
    largest label is its own."""
    c = np.zeros((k, int(labels.max()) + 1), np.int64)
    np.add.at(c, (truth, labels), 1)
    return {"diagonal": float(c.max(1).sum() / len(truth)),
            "one_label_per_cluster": len(set(c.argmax(1).tolist())) == k}


def spectral_adjacency(xs: torch.Tensor, k: int, res):
    """6j's spectral input: the k-NN graph of ``xs`` (each row's own list,
    weights 1) joined across its components by ``connect_components_edges``
    (each row's nearest row of another component) → ``(CSR, components)``.
    The components come from scipy on the host."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from raft_tpu_torch import sparse
    from raft_tpu_torch.cluster import single_linkage as sl

    n, dev = xs.shape[0], xs.device
    knn = sl._knn_connectivity(xs, k, "sqeuclidean", res)
    half = knn.nnz // 2  # the first half: each row's own list
    r, c = knn.rows[:half].to(torch.int64), knn.cols[:half].to(torch.int64)
    n_comp, comp = connected_components(coo_matrix(
        (np.ones(half), (r.cpu().numpy(), c.cpu().numpy())), shape=(n, n)),
        directed=False)
    ei, ej, _ = sparse.neighbors.connect_components_edges(
        xs, torch.from_numpy(comp.astype(np.int32)).to(dev))
    r = torch.cat([r, ei.to(torch.int64)])
    c = torch.cat([c, ej.to(torch.int64)])
    return sparse.convert.coo_to_csr(sparse.coo_from_arrays(
        r, c, torch.ones(r.numel(), device=dev), (n, n))), int(n_comp)


def spectral_operator64(adj, modularity: bool) -> Callable:
    """The float64 matvec of the operator that ``sparse.spectral`` hands
    Lanczos, over A = max(adj, adjᵀ) on the host: the normalised Laplacian
    I - D^-1/2 A D^-1/2 (``partition``) or B = A - d·dᵀ/2m
    (``modularity_maximization``)."""
    from scipy.sparse import csr_matrix

    a = csr_matrix((adj.data.double().cpu().numpy(),
                    adj.indices.cpu().numpy(), adj.indptr.cpu().numpy()),
                   shape=adj.shape)
    a = a.maximum(a.T).tocsr()
    d = np.asarray(a.sum(axis=1)).ravel()
    if modularity:
        two_m = max(float(d.sum()), 1e-20)
        return lambda v: a @ v - d * (d @ v / two_m)
    inv = 1.0 / np.sqrt(np.maximum(d, 1e-20))
    return lambda v: v - inv * (a @ (inv * v))


def lanczos64(matvec: Callable, v0: np.ndarray, ncv: int, k: int,
              which: str):
    """``ops.linalg.lanczos`` in float64 on the host from the start vector
    ``v0``: ``ncv`` steps with one full reorthogonalisation pass each, the
    tridiagonal problem by ``eigh``, the k extremal Ritz pairs → ``(values
    [k], vectors [n, k], every Ritz value [ncv])``."""
    v = np.asarray(v0, np.float64)
    vs = np.zeros((ncv, v.shape[0]))
    vs[0] = v / np.linalg.norm(v)
    alphas, betas = np.zeros(ncv), np.zeros(ncv)
    for j in range(ncv):
        w = matvec(vs[j])
        alphas[j] = vs[j] @ w
        w = w - alphas[j] * vs[j]
        if j > 0:
            w = w - betas[j - 1] * vs[j - 1]
        w = w - vs[:j + 1].T @ (vs[:j + 1] @ w)
        betas[j] = np.linalg.norm(w)
        if j + 1 < ncv:
            vs[j + 1] = w / max(betas[j], 1e-300)
    t = (np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1))
    theta, u = np.linalg.eigh(t)
    sel = np.argsort(-theta if which == "largest" else theta,
                     kind="stable")[:k]
    vecs = vs.T @ u[:, sel]
    return theta[sel], vecs / np.linalg.norm(vecs, axis=0), theta


def subspace_sin(a: np.ndarray, b: np.ndarray) -> float:
    """The sine of the largest principal angle between the column spans
    of ``a`` and ``b`` [n, k]."""
    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    cos = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - float(cos.min()) ** 2)))


def nearest_centre_misses(x, centres, labels, tol: float) -> Tuple[int, int]:
    """k-means' labels against the float64 nearest of its final centres:
    ``(rows whose label is not the nearest centre although the nearest
    two differ by more than 2·tol, rows clear of such ties)``."""
    x = np.asarray(x, np.float64)
    c = np.asarray(centres, np.float64)
    d = ((x * x).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * x @ c.T)
    two = np.sort(d, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 2 * tol
    miss = np.asarray(labels) != d.argmin(1)
    return int((miss & clear).sum()), int(clear.sum())


def phase(*, smi, dev, seed, dataset, flat, flat_probes, replaces,
          emit: Callable, timed: Callable, launch_counts: Callable
          ) -> Tuple[Dict[str, int], List[dict]]:
    """Phase 6j (module docstring). Returns the phase's main-path launches
    by kernel (``select_k_shapes`` too) and its kernel rows."""
    from scipy.sparse import coo_matrix, csr_matrix
    from scipy.sparse.csgraph import connected_components, minimum_spanning_tree
    from scipy.sparse.linalg import eigsh

    from raft_tpu_torch import common, label, solver, sparse
    from raft_tpu_torch.bench.datagen import (low_rank_cluster_ids,
                                              low_rank_clusters)
    from raft_tpu_torch.bench.kernel_ab import graph_ms
    from raft_tpu_torch.cluster import kmeans as kmeans_mod
    from raft_tpu_torch.cluster import single_linkage as sl
    from raft_tpu_torch.core import resources_manager
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.obs import costs as obs_costs
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops import linalg as linalg_mod
    from raft_tpu_torch.ops.distance import row_norms_sq
    from raft_tpu_torch.sparse import mst as mst_mod
    from raft_tpu_torch.testing import assert_topk_close
    from raft_tpu_torch.utils import debug

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    mem_start = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                 else None)
    res = Resources(device=dev, seed=seed, workspace_limit_bytes=WORKSPACE)
    total = {name: 0 for name in gk.LAUNCHES}
    shapes: Dict[str, int] = {}
    rng = np.random.default_rng(seed + 7)

    def counted(fn):
        """(fn(), seconds, its launches), the counts set to 0 just before
        and read just after; the launches added to the phase's."""
        gk.reset_launch_counts()
        out, secs = timed(fn)
        _sync(dev)
        got = launch_counts()
        for name in gk.LAUNCHES:
            total[name] += got[name]
        for key, n in got.get("select_k_shapes", {}).items():
            shapes[key] = shapes.get(key, 0) + n
        return out, secs, got

    def line(name, **kw):
        emit({"phase": "graph", "part": name, "card": smi, **kw,
              "phase_seconds": time.perf_counter() - t_phase})

    failures = []

    def fail(msg):
        """Record a failed check; the phase raises after its last line, so
        that one run shows every check."""
        failures.append(msg)
        line("check_failed", message=msg)

    def hold(got, want, atol, rtol, name) -> dict:
        """``assert_topk_close``, its failure recorded by ``fail``."""
        try:
            return assert_topk_close(got, want, atol, rtol, name)
        except AssertionError as e:
            fail(str(e))
            return {"held": False}

    # ---- single linkage at SIFT-1M's shape, its steps timed apart
    n = dataset.shape[0]
    steps, kept = {}, {}

    def timed_attr(mod, name):
        real = getattr(mod, name)

        def wrapper(*a, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = real(*a, **kw)
            _sync(dev)
            steps[name] = steps.get(name, 0.0) + time.perf_counter() - t0
            kept[name] = out
            return out

        setattr(mod, name, wrapper)
        return real

    patched = [(sl, "_knn_connectivity"), (mst_mod, "boruvka"),
               (mst_mod, "canonical_edges"), (sl, "_label_dendrogram")]
    reals = [timed_attr(mod, name) for mod, name in patched]
    try:
        params = sl.SingleLinkageParams(n_clusters=SL_CLUSTERS,
                                        connectivity_k=SL_K)
        labels, sl_s, sl_l = counted(lambda: sl.single_linkage(
            dataset, params, res=res))
    finally:
        for (mod, name), real in zip(patched, reals):
            setattr(mod, name, real)
    graph = kept["_knn_connectivity"]
    src, dst, wt = kept["canonical_edges"]
    if sl_l["fused_l2_topk"] < 1:
        fail("single linkage launched no fused_l2_topk")
    # the forest against scipy's in float64: the first half of the graph
    # is each row's own list; scipy takes the lighter of G[i,j], G[j,i]
    half = graph.nnz // 2
    g_rows = graph.rows[:half].cpu().numpy()
    g_cols = graph.cols[:half].cpu().numpy()
    g_w = graph.data[:half].cpu().numpy()
    wt_np, src_np = wt.cpu().numpy(), src.cpu().numpy()
    forest = np.isfinite(wt_np) & (src_np >= 0)
    host_g = csr_matrix((g_w.astype(np.float64), (g_rows, g_cols)),
                        shape=(n, n))
    ref_tree, scipy_s = timed(lambda: minimum_spanning_tree(host_g))
    ref_w = float(ref_tree.sum())
    got_w = float(wt_np[forest].astype(np.float64).sum())
    w_rel = abs(got_w - ref_w) / ref_w
    if w_rel > 1e-5:
        fail(f"the forest weighs {got_w}, scipy's {ref_w} (rel {w_rel})")
    # the partition: the components of the graph's edges at or below the
    # m-th smallest forest weight
    fw = np.sort(wt_np[forest])
    m_cut = min(n - SL_CLUSTERS, len(fw))
    thr = float(fw[m_cut - 1])
    tied = m_cut < len(fw) and fw[m_cut] == fw[m_cut - 1]
    partition_equal = None
    if not tied:
        keep = graph.data.cpu().numpy() <= thr
        _, comps = connected_components(
            coo_matrix((np.ones(int(keep.sum())),
                        (graph.rows.cpu().numpy()[keep],
                         graph.cols.cpu().numpy()[keep])), shape=(n, n)),
            directed=False)
        pairs = np.unique(labels.astype(np.int64) * n + comps)
        partition_equal = (len(pairs) == len(np.unique(labels))
                           == len(np.unique(comps)))
        if not partition_equal:
            fail("single linkage's clusters differ from the components of "
                 "the graph's edges below the cut")
    # determinism: two card runs of mst bitwise, and the card's bitwise the
    # CPU's on a sample of the graph
    again = mst_mod.mst(graph)
    twice = _bitwise(again, (src, dst, wt))
    pick = torch.from_numpy(rng.choice(half, DET_EDGES // 2, replace=False)
                            ).to(dev)
    sample = sparse.COO(torch.cat([graph.rows[pick], graph.cols[pick]]),
                        torch.cat([graph.cols[pick], graph.rows[pick]]),
                        torch.cat([graph.data[pick], graph.data[pick]]),
                        graph.shape)
    on_card = mst_mod.mst(sample)
    on_cpu = mst_mod.mst(sparse.COO(sample.rows.cpu(), sample.cols.cpu(),
                                    sample.data.cpu(), sample.shape))
    card_cpu = _bitwise(tuple(t.cpu() for t in on_card), on_cpu)
    if not (twice and card_cpu):
        fail(f"mst not bitwise: two card runs {twice}, card and CPU "
             f"{card_cpu}")
    sizes = np.bincount(labels)
    line("single_linkage", rows=n, dim=dataset.shape[1], connectivity_k=SL_K,
         card_bytes_allocated_at_start=mem_start,
         n_clusters=SL_CLUSTERS, seconds=sl_s,
         knn_graph_seconds=steps["_knn_connectivity"],
         boruvka_seconds=steps["boruvka"],
         host_extraction_seconds=steps["canonical_edges"],
         labelling_seconds=steps["_label_dendrogram"],
         graph_edges=graph.nnz, forest_edges=int(forest.sum()),
         forest_weight=got_w, scipy_weight=ref_w, weight_rel_err=w_rel,
         scipy_seconds=scipy_s, cut_weight=thr, cut_tied=bool(tied),
         partition_equals_components=partition_equal,
         largest_cluster=int(sizes.max()),
         singleton_clusters=int((sizes == 1).sum()),
         mst_bitwise_two_runs=twice, mst_bitwise_card_cpu=card_cpu,
         determinism_sample_edges=DET_EDGES, launches=sl_l)
    del again, on_card, on_cpu, sample, host_g, ref_tree

    # ---- the cross-component 1-NN over the same rows, through
    # connect_components_edges (the 1-NN with each row as the source)
    colors = torch.from_numpy(labels).to(dev)
    (ei, ci, cv), cc_s, cc_l = counted(
        lambda: sparse.neighbors.connect_components_edges(dataset, colors))
    rows = rng.choice(n, CC_SAMPLE, replace=False)
    x64 = dataset.cpu().numpy().astype(np.float64)
    n2 = (x64 * x64).sum(1)
    d64 = n2[rows, None] + n2[None, :] - 2.0 * x64[rows] @ x64.T
    d64 = np.maximum(d64, 0.0)
    d64[labels[rows][:, None] == labels[None, :]] = np.inf
    part = np.argpartition(d64, 1, axis=1)[:, :2]
    two = np.sort(np.take_along_axis(d64, part, 1), axis=1)
    want_i = np.argmin(d64, axis=1)
    tol = 1e-5 * float(n2.max())
    got_v, got_i = cv[rows].cpu().numpy(), ci[rows].cpu().numpy()
    fin = np.isfinite(two[:, 0])
    v_err = float(np.abs(got_v[fin] - two[fin, 0]).max()) if fin.any() else 0.0
    clear = fin & (two[:, 1] - two[:, 0] > 2 * tol)
    ids_off = int((got_i[clear] != want_i[clear]).sum())
    if v_err > tol or not np.array_equal(np.isfinite(got_v), fin) or ids_off:
        fail(f"cross_component_nn: value error {v_err} (tol {tol}), "
             f"{ids_off} ids off away from near-ties")
    joined = coo_matrix((np.ones(half + n), (
        np.concatenate([g_rows, ei.cpu().numpy()]),
        np.concatenate([g_cols, ci.cpu().numpy()]))), shape=(n, n))
    n_comp_joined, _ = connected_components(joined, directed=False)
    n_comp_graph = n - int(forest.sum())  # a spanning forest: n - c edges
    line("cross_component_nn", rows=n, colors=SL_CLUSTERS, seconds=cc_s,
         fp32_operations=2 * n * n * dataset.shape[1],
         sampled_rows=CC_SAMPLE, max_abs_err=v_err, tolerance=tol,
         ids_clear_of_ties=int(clear.sum()), ids_off=ids_off,
         graph_components=int(n_comp_graph),
         components_with_edges=int(n_comp_joined), launches=cc_l)
    if n_comp_joined != 1:
        fail(f"the kNN graph with connect_components_edges has "
             f"{n_comp_joined} components")
    del x64, d64, cv, ci, ei, joined, graph, colors
    gc.collect()

    # ---- sparse distances over a TF-IDF corpus
    y64, q64 = _corpus(rng)

    def to_csr(m):
        return sparse.csr_from_scipy_like(
            torch.from_numpy(m.indptr.astype(np.int32)).to(dev),
            torch.from_numpy(m.indices.astype(np.int32)).to(dev),
            torch.from_numpy(m.data.astype(np.float32)).to(dev), m.shape)

    ycsr, qcsr = to_csr(y64), to_csr(q64)
    # the float64 references of SP_HELD sampled queries
    held_rows = np.sort(rng.choice(SP_QUERIES, SP_HELD, replace=False))
    held_t = torch.from_numpy(held_rows).to(dev)
    qh = q64[held_rows]
    prod64 = (qh @ y64.T).toarray()
    yb, qb = y64.copy(), qh.copy()
    yb.data[:], qb.data[:] = 1.0, 1.0
    inter64 = (qb @ yb.T).toarray()
    cnt_q = np.diff(qh.indptr)[:, None].astype(np.float64)
    cnt_y = np.diff(y64.indptr)[None, :].astype(np.float64)
    refs = {"cosine": 1.0 - prod64,  # unit rows
            "sqeuclidean": np.maximum(2.0 - 2.0 * prod64, 0.0),
            "jaccard": 1.0 - inter64 / np.maximum(cnt_q + cnt_y - inter64,
                                                  1.0)}
    del prod64, inter64
    knn_runs = {}
    for metric in SP_METRICS:
        got, knn_s, knn_l = counted(lambda: sparse.distance.knn(
            qcsr, ycsr, SP_K, metric, res=res))
        want = _topk64(refs[metric], SP_K)
        held = hold(tuple(t[held_t] for t in got), want, 1e-5, 1e-5,
                    f"sparse knn {metric}")
        knn_runs[metric] = {"seconds": knn_s, "qps": SP_QUERIES / knn_s,
                            "launches": knn_l, **held}
        if knn_l["select_k"] < 1:
            fail(f"sparse knn {metric} launched no select_k")
    del refs
    bx, by = SP_BLOCK
    xd = q64[:bx].toarray()
    yblk = y64[:by]
    block = {}
    for m in sparse.distance.SUPPORTED:
        got = sparse.distance.pairwise_distance(
            to_csr(q64[:bx]), to_csr(yblk), m, SP_LP, res=res)
        want = _host_pairwise(m.name, xd, yblk)
        scale = float(np.abs(want).max())
        err = float(np.abs(got.double().cpu().numpy() - want).max())
        block[m.name] = {"max_abs_err": err, "scale": scale}
        if not err <= 1e-5 * scale:
            fail(f"sparse pairwise {m.name}: error {err} > 1e-5·{scale}")
    line("sparse", rows=SP_ROWS, cols=SP_COLS, queries=SP_QUERIES,
         nnz_per_row=ycsr.nnz / SP_ROWS, nnz=ycsr.nnz, k=SP_K,
         workspace_bytes=WORKSPACE, knn=knn_runs, held_queries=SP_HELD,
         pairwise_block=[bx, by], pairwise=block)
    del ycsr, qcsr, y64, q64, xd, yblk
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- spectral partitioning of planted clusters
    srng = np.random.default_rng(seed + 8)
    xs_np = low_rank_clusters(srng, SPEC_ROWS, DIM, n_centers=SPEC_CLUSTERS,
                              spread=SPEC_SPREAD)
    truth = low_rank_cluster_ids(np.random.default_rng(seed + 8), SPEC_ROWS,
                                 DIM, n_centers=SPEC_CLUSTERS)
    xs = torch.from_numpy(xs_np).to(dev)

    (adj, knn_components), g_s, g_l = counted(
        lambda: spectral_adjacency(xs, SPEC_K, res))
    planted_cut = sparse.spectral.analyze_partition(adj, truth)
    # the planted partition's cut figures in float64 on the host
    a64 = csr_matrix((adj.data.double().cpu().numpy(),
                      adj.indices.cpu().numpy(), adj.indptr.cpu().numpy()),
                     shape=adj.shape)
    sym = a64.maximum(a64.T).tocoo()
    crossing = truth[sym.row] != truth[sym.col]
    cut_by_row = np.bincount(sym.row[crossing], sym.data[crossing],
                             minlength=SPEC_ROWS)
    cut64 = (float(cut_by_row.sum() / 2.0), float(sum(
        cut_by_row[truth == c].sum() / (truth == c).sum()
        for c in np.unique(truth))))
    cut_err = max(abs(g - w) / w for g, w in zip(planted_cut, cut64))
    if cut_err > 1e-6:
        fail(f"analyze_partition: {planted_cut} against float64 {cut64}")
    # each run's start vector, Lanczos pairs and k-means result, kept for
    # the holds: the Lanczos against lanczos64 from the same start vector,
    # the labels against the float64 nearest of k-means' final centres
    seen = {}
    real = (linalg_mod._start_vector, linalg_mod.lanczos,
            kmeans_mod.fit_predict)

    def start_spy(generator, n_):
        seen["v0"] = real[0](generator, n_)
        return seen["v0"]

    def lanczos_spy(matvec, n_, k_, generator=None, ncv=None,
                    which="smallest", device=None):
        out = real[1](matvec, n_, k_, generator=generator, ncv=ncv,
                      which=which, device=device)
        seen["lanczos"] = (out, ncv, k_, which)
        return out

    def fit_spy(x, params=None, res=None, device=None):
        out = real[2](x, params, res=res, device=device)
        seen["kmeans"] = (x, *out)
        return out

    def spectral_hold(name, emb, seen, adj) -> dict:
        """One spectral run held: its Ritz values within SPEC_RITZ_RTOL
        times the largest |Ritz value| of lanczos64's from the same start
        vector; the span of its embedding
        within SPEC_SIN_TOL (the sine of the largest principal angle) where
        the float64 Ritz values at the embedding's edges are SPEC_GAP
        apart (reported otherwise); its labels the float64 nearest of
        k-means' final centres wherever the nearest two differ by more
        than 2·SPEC_KM_TOL."""
        (theta, vecs), ncv, k_, which = seen["lanczos"]
        t64, v64, every = lanczos64(
            spectral_operator64(adj, which == "largest"),
            seen["v0"].double().cpu().numpy(), ncv, k_, which)
        ritz_err = float(np.abs(theta.double().cpu().numpy() - t64).max())
        ritz_tol = SPEC_RITZ_RTOL * float(np.abs(every).max())
        ranked = np.sort(every)[::-1] if which == "largest" else np.sort(every)
        first = k_ - emb.shape[1]  # partition drops the trivial pair
        edges = [k_ - 1] + ([first] if first > 0 else [])
        gap = float(min(abs(ranked[i + 1] - ranked[i]) for i in edges))
        sin = subspace_sin(emb.double().cpu().numpy(), v64[:, first:])
        x, centres, labels = seen["kmeans"]
        misses, clear = nearest_centre_misses(
            x.cpu().numpy(), centres.cpu().numpy(), labels.cpu().numpy(),
            SPEC_KM_TOL)
        if ritz_err > ritz_tol or (gap >= SPEC_GAP
                                        and sin > SPEC_SIN_TOL) or misses:
            fail(f"spectral {name}: Ritz values {ritz_err} from float64, "
                 f"span sine {sin} (gap {gap}), {misses} labels not the "
                 "nearest centre")
        return {"ncv": ncv, "ritz_max_abs_err": ritz_err,
                "ritz_tolerance": ritz_tol, "edge_gap": gap,
                "span_sine": sin, "span_held": gap >= SPEC_GAP,
                "labels_clear_of_ties": clear,
                "labels_not_nearest_centre": misses}

    runs, embeddings = {}, {}
    linalg_mod._start_vector, linalg_mod.lanczos = start_spy, lanczos_spy
    kmeans_mod.fit_predict = fit_spy
    try:
        for name, call in (
                ("partition", lambda: sparse.spectral.partition(
                    adj, SPEC_CLUSTERS, res=res)),
                (f"partition_n_eig_{SPEC_N_EIG}",
                 lambda: sparse.spectral.partition(
                     adj, SPEC_CLUSTERS, n_eig_vects=SPEC_N_EIG, res=res)),
                ("modularity_maximization",
                 lambda: sparse.spectral.modularity_maximization(
                     adj, SPEC_CLUSTERS, res=res))):
            seen.clear()
            (lab, emb), s_s, s_l = counted(call)
            embeddings[emb.shape[1]] = emb
            score = _contingency(truth, lab, SPEC_CLUSTERS)
            cut = sparse.spectral.analyze_partition(adj, lab)
            hold_s = spectral_hold(name, emb, seen, adj)
            runs[name] = {"seconds": s_s, **score,
                          "diagonal_at_least_0.99": score["diagonal"] >= 0.99,
                          "edge_cut": cut[0], "ratio_cut": cut[1],
                          **hold_s, "launches": s_l}
            if not (lab.shape == (SPEC_ROWS,) and lab.min() >= 0
                    and lab.max() < SPEC_CLUSTERS
                    and bool(torch.isfinite(emb).all())):
                fail(f"spectral {name}: malformed labels or embedding")
    finally:
        linalg_mod._start_vector, linalg_mod.lanczos = real[:2]
        kmeans_mod.fit_predict = real[2]
    # the eigenpairs of the normalised Laplacian of a 100,000-row graph
    xg = dataset[:EIG_ROWS]

    def laplacian_csr():
        _, nn = brute_force.knn(xg, xg, EIG_K + 1, metric="sqeuclidean",
                                res=res)
        coo = sparse.coo_from_arrays(
            torch.arange(EIG_ROWS, device=dev).repeat_interleave(EIG_K),
            nn[:, 1:].reshape(-1), torch.ones(EIG_ROWS * EIG_K, device=dev),
            (EIG_ROWS, EIG_ROWS))
        a = sparse.convert.coo_to_csr(sparse.linalg.symmetrize(coo))
        dinv = 1.0 / torch.sqrt(sparse.linalg.row_norm(a, "l1"))
        ar = a.row_ids().to(torch.int64)
        ac = a.indices.to(torch.int64)
        eye = torch.arange(EIG_ROWS, device=dev)
        lap = sparse.convert.coo_to_csr(sparse.coo_from_arrays(
            torch.cat([eye, ar]), torch.cat([eye, ac]),
            torch.cat([torch.ones(EIG_ROWS, device=dev),
                       -dinv[ar] * a.data * dinv[ac]]),
            (EIG_ROWS, EIG_ROWS)))
        return lap, a

    (lap, a_sym), lap_s, lap_l = counted(laplacian_csr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    (ritz, _), lz_s, lz_l = counted(lambda: sparse.solver.lanczos_smallest(
        lap, 4, generator=gen, ncv=EIG_NCV))
    host = csr_matrix((a_sym.data.double().cpu().numpy(),
                       a_sym.indices.cpu().numpy(),
                       a_sym.indptr.cpu().numpy()), shape=(EIG_ROWS, EIG_ROWS))
    dh = 1.0 / np.sqrt(np.asarray(host.sum(axis=1)).ravel())
    norm_a = host.multiply(dh[:, None]).multiply(dh[None, :]).tocsr()
    top, eigsh_s = timed(lambda: float(eigsh(norm_a, k=1, which="LA",
                                             return_eigenvectors=False)[0]))
    eig_err = abs(float(ritz[0]) - (1.0 - top))
    line("spectral", rows=SPEC_ROWS, clusters=SPEC_CLUSTERS,
         spread=SPEC_SPREAD, knn_k=SPEC_K, knn_components=knn_components,
         graph_seconds=g_s, graph_launches=g_l, graph_nnz=adj.nnz,
         planted_edge_cut=planted_cut[0], planted_ratio_cut=planted_cut[1],
         planted_cut_float64=list(cut64), planted_cut_rel_err=cut_err,
         runs=runs,
         eigenpairs={"rows": EIG_ROWS, "knn_k": EIG_K, "ncv": EIG_NCV,
                     "nnz": lap.nnz, "build_seconds": lap_s,
                     "seconds": lz_s, "ritz": ritz.tolist(),
                     "eigsh_float64": 1.0 - top, "eigsh_seconds": eigsh_s,
                     "abs_err": eig_err, "launches": {"graph": lap_l,
                                                      "lanczos": lz_l}})
    if eig_err > 1e-4:
        fail(f"lanczos_smallest: {float(ritz[0])} against eigsh's "
             f"{1.0 - top}")
    del adj, lap, a_sym, host, norm_a, xs
    gc.collect()

    # ---- the assignment problem
    cost_np = np.random.default_rng(seed + 9).random((LAP_N, LAP_N)).astype(
        np.float32)
    cost = torch.from_numpy(cost_np).to(dev)
    rounds = []
    real_auction = solver.auction

    def spy(*a, **kw):
        out = real_auction(*a, **kw)
        rounds.append(out[2])
        return out

    solver.auction = spy
    try:
        (assign, total_c), lap_s, lap_l = counted(lambda: solver.solve(cost))
        second, _ = solver.solve(cost)
    finally:
        solver.auction = real_auction
    cpu_assign, _ = solver.solve(cost.cpu())
    _, opt = solver.solve_host(cost_np)
    eps = 1.0 / (LAP_N + 1)
    perm_ok = sorted(assign.tolist()) == list(range(LAP_N))
    lap_bitwise = torch.equal(assign, second)
    lap_cpu = torch.equal(assign.cpu(), cpu_assign)
    line("lap", n=LAP_N, seconds=lap_s, rounds=rounds[0],
         total=float(total_c), optimum=opt, gap=float(total_c) - opt,
         bound=LAP_N * eps, permutation=perm_ok, bitwise_two_runs=lap_bitwise,
         bitwise_cpu=lap_cpu, launches=lap_l)
    if not (perm_ok and lap_bitwise and lap_cpu
            and float(total_c) <= opt + LAP_N * eps + 1e-3):
        fail("the auction: not a permutation, not within n·eps, or not "
             "bitwise")

    # ---- labels, namespaces, debug
    lab_t = torch.from_numpy(labels).to(dev)
    mono, mono_s, mono_l = counted(lambda: label.make_monotonic(
        lab_t, SL_CLUSTERS))
    mono_ok = np.array_equal(mono.cpu().numpy(),
                             np.unique(labels, return_inverse=True)[1])
    ids96 = low_rank_cluster_ids(np.random.default_rng(seed), n + 10_000,
                                 dataset.shape[1])[:n]
    merged, merge_s, merge_l = counted(lambda: label.merge_labels(
        lab_t, torch.from_numpy(ids96).to(dev)))
    # numpy: the components of the bipartite label graph, each row at the
    # smallest row index of its component
    n_nodes = SL_CLUSTERS + int(ids96.max()) + 1
    _, comp = connected_components(coo_matrix((np.ones(n), (
        labels.astype(np.int64), SL_CLUSTERS + ids96)),
        shape=(n_nodes, n_nodes)), directed=False)
    row_comp = comp[labels]
    first_row = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(first_row, row_comp, np.arange(n))
    merge_ok = np.array_equal(merged.cpu().numpy(), first_row[row_comp])
    resources_manager.reset()
    try:
        resources_manager.set_resources_per_device(2)
        # the default device is the current CUDA device
        handed = [resources_manager.get_resources(
            None if dev.type == "cuda" else dev) for _ in range(3)]
        rr_ok = (handed[0] is handed[2] and handed[0] is not handed[1]
                 and all(r.device.type == dev.type for r in handed))
    finally:
        resources_manager.reset()
    q = dataset[:1000]
    # the wrapped calls counted; the direct calls they are held to not
    synced = common.auto_sync_resources(brute_force.knn)
    got, _, sync_l = counted(lambda: synced(q, dataset, 10, res=res))
    sync_ok = _bitwise(got, brute_force.knn(q, dataset, 10, res=res))
    sp = ivf_flat.SearchParams(n_probes=flat_probes)
    checked, _, checked_l = counted(
        lambda: debug.checked(ivf_flat.search)(flat, q, 10, sp))
    checked_ok = _bitwise(checked, ivf_flat.search(flat, q, 10, sp))
    nan_raised = mode_raised = False
    try:
        debug.checked(lambda t: t * 1.0)(torch.tensor([0.0, float("nan")],
                                                      device=dev))
    except FloatingPointError:
        nan_raised = True
    try:
        with debug.debug_mode(nans=True):
            torch.log(torch.tensor([-1.0], device=dev))
    except FloatingPointError:
        mode_raised = True
    line("labels", rows=n, make_monotonic_seconds=mono_s,
         make_monotonic_equal=mono_ok, merge_labels_seconds=merge_s,
         merge_labels_equal=merge_ok, merged_groups=int(comp.max() + 1),
         round_robin=rr_ok, auto_sync_bitwise=sync_ok,
         checked_search_bitwise=checked_ok, checked_raised_on_nan=nan_raised,
         debug_mode_raised_on_nan=mode_raised,
         launches={"make_monotonic": mono_l, "merge_labels": merge_l,
                   "auto_sync_knn": sync_l, "checked_search": checked_l})
    if not (mono_ok and merge_ok and rr_ok and sync_ok and checked_ok
            and nan_raised and mode_raised):
        fail("labels, namespaces or debug")

    # ---- the kernels at this phase's shapes against their plain versions
    rows_out = []
    peaks = obs_costs.H100_PEAKS

    def bound(work):
        return obs_costs.roofline_bound(*work, peaks)

    xq = dataset[:L2_SAMPLE]
    xn, yn = row_norms_sq(xq), row_norms_sq(dataset)
    k16 = SL_K + 1
    held = hold(gk.fused_l2_topk(xq, dataset, k16, xn, yn),
                gk.fused_l2_topk_plain(xq, dataset, k16, xn, yn),
                1e-4 * float(yn.max()), 1e-5, "fused_l2_topk (single linkage)")
    work = obs_costs.l2_topk_work(L2_SAMPLE, n, dataset.shape[1], k16)
    rows_out.append(dict(
        name="fused_l2_topk", route="cuda",
        source="raft_tpu_torch/csrc/fused_l2_topk.cu",
        replaces=replaces["fused_l2_topk"],
        shape=(f"single linkage's kNN graph: {n} x {n} x {dataset.shape[1]}"
               f", k={k16}; held and timed on {L2_SAMPLE} of the queries"),
        launches=sl_l["fused_l2_topk"], agrees_with_plain=True, **held,
        ms=_ms(lambda: gk.fused_l2_topk(xq, dataset, k16, xn, yn), dev),
        plain_ms=_ms(lambda: gk.fused_l2_topk_plain(xq, dataset, k16, xn, yn),
                     dev, 1),
        library_ms=None, **bound(work),
        **obs_costs.tf32_bound(*work, peaks),
        knn_graph_seconds=steps["_knn_connectivity"],
        knn_graph_bound_ms=bound(obs_costs.l2_topk_work(
            n, n, dataset.shape[1], k16))["bound_ms"]))
    del xq, xn
    for d_emb, launches in ((SPEC_CLUSTERS,
                             runs["partition"]["launches"]["fused_l2_argmin"]
                             + runs["modularity_maximization"]["launches"][
                                 "fused_l2_argmin"]),
                            (SPEC_N_EIG, runs[f"partition_n_eig_{SPEC_N_EIG}"][
                                "launches"]["fused_l2_argmin"])):
        # the E-step's input: the run's row-normalised embedding, and 10 of
        # its rows as the centres
        xe = embeddings[d_emb]
        xe = xe / torch.clamp_min(xe.norm(dim=1, keepdim=True), 1e-12)
        ce = xe[torch.from_numpy(rng.choice(SPEC_ROWS, SPEC_CLUSTERS,
                                            replace=False)).to(dev)]
        args = (xe, ce, row_norms_sq(xe), row_norms_sq(ce), True)
        got_a, want_a = gk.fused_l2_argmin(*args), gk.fused_l2_argmin_plain(
            *args)
        top2, _ = gk.fused_l2_topk_plain(xe, ce, 2)
        tol = 1e-4 * float(torch.maximum(args[2].max(), args[3].max()))
        clear = (top2[:, 1] - top2[:, 0]) > 2 * tol
        err = float((got_a[0] - want_a[0]).abs().max())
        if err > tol or not torch.equal(got_a[1][clear], want_a[1][clear]) \
                or not _bitwise(got_a, gk.fused_l2_argmin(*args)):
            fail(f"fused_l2_argmin at d={d_emb}: error {err}, ids or runs "
                 "differ")
        plan = gk.plan_fused_argmin(SPEC_ROWS, SPEC_CLUSTERS, d_emb)
        work = obs_costs.l2_argmin_work(SPEC_ROWS, SPEC_CLUSTERS, d_emb)
        rows_out.append(dict(
            name="fused_l2_argmin", route="cuda",
            source="raft_tpu_torch/csrc/fused_l2_argmin.cu",
            replaces=replaces["fused_l2_argmin"],
            shape=(f"spectral k-means E-step: {SPEC_ROWS} x {SPEC_CLUSTERS} "
                   f"x {d_emb}, clamp"),
            launches=launches, agrees_with_plain=True, max_abs_err=err,
            bitwise_repeatable=True, ids_clear_of_ties=int(clear.sum()),
            kernel_route=plan.route, plan=dataclasses.asdict(plan),
            ms=_ms(lambda: gk.fused_l2_argmin(*args), dev, 20),
            plain_ms=_ms(lambda: gk.fused_l2_argmin_plain(*args), dev, 5),
            library_ms=None, **bound(work),
            **obs_costs.tf32_bound(*work, peaks)))
    sk_rows, sk_k = SP_QUERIES, SP_K
    vals = torch.rand((sk_rows, SP_ROWS), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    got_s = gk.streaming_select_k(vals, sk_k)
    want_s = gk._stable_topk(vals, sk_k)
    if not _bitwise(got_s, want_s):
        fail("select_k at the sparse kNN's shape differs from its plain "
             "version")
    key = f"select_k:{SP_ROWS}:{sk_k}"
    rows_out.append(dict(
        name="select_k", route="cuda", source="raft_tpu_torch/csrc/select_k.cu",
        replaces=replaces["select_k"],
        shape=f"[{sk_rows} x {SP_ROWS}], k={sk_k} (sparse knn)",
        launches=shapes.get(key, 0), agrees_with_plain=True, bitwise=True,
        max_abs_err=0.0, kernel_route=gk.plan_select_k(SP_ROWS, sk_k).route,
        plan=dataclasses.asdict(gk.plan_select_k(SP_ROWS, sk_k)),
        ms=(graph_ms(lambda: gk.streaming_select_k(vals, sk_k), 20)
            if dev.type == "cuda" else _ms(lambda: gk.streaming_select_k(
                vals, sk_k), dev)),
        plain_ms=_ms(lambda: gk._stable_topk(vals, sk_k), dev),
        library_ms=_ms(lambda: torch.topk(vals, sk_k, largest=False), dev),
        **bound(obs_costs.select_k_work(sk_rows, SP_ROWS, sk_k, False))))
    for row in rows_out:
        emit({"phase": "kernel_check", "card": smi, **row})

    line("graph_launches", launches=dict(total), select_k_shapes=shapes,
         seconds=time.perf_counter() - t_phase)
    for name in ("fused_l2_topk", "select_k", "fused_l2_argmin"):
        if total[name] < 1:
            fail(f"no {name} launch on the main path")
    if failures:
        raise AssertionError("phase 6j: " + "; ".join(failures))
    return total, rows_out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("graph: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.bench.datagen import low_rank_clusters
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import gpu_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gk.build_all()
    # phase 3's rows: the first N_ROWS of the seed's rows and queries
    rows = low_rank_clusters(np.random.default_rng(opts.seed),
                             N_ROWS + 10_000, DIM)
    dataset = torch.from_numpy(rows[:N_ROWS]).to(dev)
    flat = ivf_flat.build(dataset, ivf_flat.IndexParams(n_lists=1024))

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def launch_counts():
        out = dict(gk.LAUNCHES)
        out["select_k_shapes"] = {f"{c}:{n}:{k}": m for (c, n, k), m
                                  in gk.SELECT_K_SHAPES.items()}
        return out

    replaces = {name: f"raft_tpu/ops/pallas_kernels.py:{line}"
                for name, line in (("fused_l2_argmin", 88), ("select_k", 428),
                                   ("fused_l2_topk", 610))}
    launches, rows_out = phase(
        smi=smi, dev=dev, seed=opts.seed, dataset=dataset, flat=flat,
        flat_probes=32, replaces=replaces, emit=emit, timed=timed,
        launch_counts=launch_counts)
    emit({"graph_launches": launches, "kernel_rows": len(rows_out)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
