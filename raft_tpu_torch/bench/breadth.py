"""Phase 6i of ``chip_smoke.py``: the breadth modules on the card.

``phase(...)`` drives, at users' sizes, with ``allow_tf32`` off:

- ``ball_cover``: cuML's ``NearestNeighbors(algorithm="rbc")`` workload.
  1,000,000 (latitude, longitude) points in radians around 1,000 seeded
  centres, searched by haversine, and 1,000,000 3-D points around 1,000
  centres, searched by euclidean distance; √n = 1,000 landmarks, 10,000
  queries from the same clusters, k = 32. ``knn`` at the default probes
  and at one probe (pass 2 then scans most lists, in query chunks), each
  against
  ``brute_force.knn`` with the same metric (haversine: rtol 1e-5, atol
  1e-7; euclidean: the squared distances rtol 1e-5 and atol 1e-6·max‖x‖²,
  the rounding of an expanded L2 in fp32), by
  ``testing.assert_topk_close`` (ids equal away from near-ties; a tie run
  that reaches the k-th distance may continue past k);
  ``eps_nn`` on 1,000 queries at an eps giving a mean degree of about 64,
  against ``epsilon_neighborhood.eps_neighbors`` at the rooted metric,
  adjacency equal away from the eps boundary (a pair whose float64
  distance lies within the tolerance of eps). The excepted cases are
  printed. Recorded: build s, knn QPS, the lists pass 2 scanned (the union
  of all chunks, a chunk's mean and largest, of L), its query chunk and
  chunks, eps_nn s.
- ``eps_neighbors``: DBSCAN's batched adjacency, 10,000 × 100,000 × 128
  rows of ``bench.datagen.low_rank_clusters`` (phase 3's queries against
  its first 100,000 rows), sqeuclidean, eps at the 0.1% quantile of 64
  sampled rows' distances; their adjacency and degrees against float64
  numpy, equal away from the boundary.
- ``gram``: the four kernels at 10,000 × 10,000 × 128 (phase 3's rows),
  each sampled row against float64, the largest error at most 1e-5 of the
  largest |K| (a TF32 product would miss that); ``linear_kernel`` of a
  10,000 × 10,000 CSR at 1% density against its own dense rows.
- ``linalg``: ``rsvd(k=16, p=10, n_iter=4)`` of the 1,000,000 × 128 rows,
  its singular values within 1e-3 of float64 (``torch.linalg.svdvals`` of
  the float64 QR's R factor, which has the rows' singular values);
  ``svd``, ``eig_dc``, ``qr_get_q`` and ``cholesky`` (with a ridge of 1e-3
  of the mean variance: the rows have rank 16) of the 128 × 128 covariance,
  each reconstructing it within 1e-4 in float64; ``lanczos(which=
  "largest", k=8, ncv=64)`` over ``spmv`` of D^-1/2 A D^-1/2, A the
  symmetrised 16-NN connectivity graph of 100,000 rows (``brute_force``,
  ``symmetrize``, ``coo_to_csr``), the top Ritz value within 1e-4 of 1,
  the eight beside ``scipy.sparse.linalg.eigsh`` in float64; two runs of
  ``spmm``, ``spmv``, ``symmetrize(op="sum")`` and ``reduce_rows_by_key``
  bitwise equal.
- ``stats``: moments, ``cov``, ``minmax`` and a 64-bin ``histogram`` of the
  1,000,000 × 128 rows against float64 (moments rtol 1e-5, cov 1e-4 of its
  largest entry, minmax equal, histogram counts equal away from bin
  edges); on 10,000 rows ``silhouette_score`` of 100 ``cluster.kmeans``
  clusters against a float64 numpy silhouette (within 1e-4) and
  ``trustworthiness_score`` of their 2-D PCA projection (``rsvd``),
  n_neighbors 5, against float64 numpy of sklearn's formula (within 1e-4);
  the contingency scores of the rows' ``kmeans.predict`` labels (phase
  5c's centres) against ``datagen``'s cluster ids, against float64 numpy
  (within 1e-4).
- ``quantize``: ``ScalarQuantizer.fit`` on 100,000 rows, ``transform`` of
  all of them; IVF-Flat over the int8 codes (1,024 lists, 32 probes) and
  brute force over them, recall@10 against phase 3's fp32 ground truth; the
  int8 IVF search bitwise its f32 twin's over the same lists.
- ``breadth_launches``: the phase's main-path launches by kernel (each
  counted call has the counts set to 0 just before it and read just
  after; the float64 references, the brute-force and plain holds run
  outside), asserted above 0 for ``fused_l2_topk``, ``fused_ivf_topk`` and
  ``fused_l2_argmin``.

Every line carries the card's name and power limit. ``phase`` returns the
launches. Standalone (its own rows, ground truth and 1,024 k-means centres
of 5 Lloyd iterations)::

    python3 -m raft_tpu_torch.bench.breadth [--seed N]
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

#: ball cover: rows, queries, k, clusters; eps_nn's queries and mean degree
BC_ROWS, BC_QUERIES, BC_K, BC_CLUSTERS = 1_000_000, 10_000, 32, 1000
EPS_QUERIES, EPS_DEGREE = 1000, 64
#: the epsilon neighbourhood: x rows, y rows, rows held against float64
EN_X, EN_Y, SAMPLE = 10_000, 100_000, 64
#: the Gram block and the CSR operand
GRAM_N, CSR_N, CSR_DENSITY = 10_000, 10_000, 0.01
#: linalg: rsvd's rank, oversampling and power iterations; the graph
RSVD_K, RSVD_P, RSVD_ITERS = 16, 10, 4
GRAPH_ROWS, GRAPH_K, LANCZOS_K, LANCZOS_NCV = 100_000, 16, 8, 64
#: stats: the silhouette's rows and clusters, trustworthiness' neighbours
SIL_ROWS, SIL_CLUSTERS, TRUST_K, HIST_BINS = 10_000, 100, 5, 64
#: quantize: training rows, lists, probes, k
SQ_TRAIN, SQ_LISTS, SQ_PROBES, SQ_K = 100_000, 1024, 32, 10
#: phase 3's generator: rows and their width, and datagen's cluster count
N_ROWS, DIM, N_CENTERS = 1_000_000, 128, 96
#: the workspace budget of the phase's calls (it sizes the chunks of the
#: ball cover's passes, of its build and of the tiled brute force): the
#: card still holds the earlier phases' indexes
WORKSPACE = 4 << 30
#: eps_nn's hold against eps_neighbors, in query chunks of
EPS_CHECK_CHUNK = 250


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev, reps: int = 3) -> float:
    """Milliseconds a call: CUDA events around ``reps`` calls after a warm
    one (the host clock on the CPU, where the phase is only rehearsed)."""
    fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _geo_points(rng, n: int, n_clusters: int) -> np.ndarray:
    """(latitude, longitude) radians around ``n_clusters`` centres spread
    evenly over the sphere's area (std 0.01 rad, about 64 km)."""
    lat_c = np.arcsin(rng.uniform(-0.95, 0.95, n_clusters))
    lon_c = rng.uniform(-np.pi, np.pi, n_clusters)
    which = rng.integers(0, n_clusters, n)
    pts = np.stack([lat_c[which], lon_c[which]], 1)
    return (pts + 0.01 * rng.standard_normal((n, 2))).astype(np.float32)


def _cube_points(rng, n: int, n_clusters: int) -> np.ndarray:
    """3-D points around ``n_clusters`` centres in [-1, 1]³ (std 0.02)."""
    centres = rng.uniform(-1.0, 1.0, (n_clusters, 3))
    which = rng.integers(0, n_clusters, n)
    return (centres[which] + 0.02 * rng.standard_normal((n, 3))).astype(
        np.float32)


def _rooted64(metric: str, q: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Rooted distances of paired rows q[i], p[i] in float64."""
    q, p = q.astype(np.float64), p.astype(np.float64)
    if metric == "haversine":
        a = (np.sin(0.5 * (p[:, 0] - q[:, 0])) ** 2 + np.cos(q[:, 0])
             * np.cos(p[:, 0]) * np.sin(0.5 * (p[:, 1] - q[:, 1])) ** 2)
        return 2.0 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))
    return np.sqrt(((q - p) ** 2).sum(-1))


def _silhouette64(x: np.ndarray, labels: np.ndarray, n_classes: int) -> float:
    """Mean silhouette under the squared L2 in float64 numpy."""
    x = x.astype(np.float64)
    n2 = (x * x).sum(1)
    d = np.maximum(n2[:, None] + n2[None, :] - 2.0 * (x @ x.T), 0.0)
    onehot = np.eye(n_classes)[labels]
    sizes = onehot.sum(0)
    sums = d @ onehot
    own = sizes[labels]
    a = np.where(own > 1, sums[np.arange(len(x)), labels]
                 / np.maximum(own - 1, 1), 0.0)
    means = sums / np.maximum(sizes[None, :], 1.0)
    means[np.arange(len(x)), labels] = np.inf
    means[:, sizes == 0] = np.inf
    b = means.min(1)
    s = np.where(own > 1, (b - a) / np.maximum(np.maximum(a, b), 1e-300),
                 0.0)
    return float(s.mean())


def _trustworthiness64(x: np.ndarray, emb: np.ndarray, k: int) -> float:
    """sklearn's trustworthiness in float64 numpy (squared L2 in both
    spaces; a row's rank of j counts the rows nearer than j, self at 0)."""
    x, emb = x.astype(np.float64), emb.astype(np.float64)
    n = len(x)
    xn, en = (x * x).sum(1), (emb * emb).sum(1)
    penalty = 0.0
    for s in range(0, n, 1000):
        rows = np.arange(s, min(s + 1000, n))
        de = en[rows, None] + en[None, :] - 2.0 * emb[rows] @ emb.T
        de[np.arange(len(rows)), rows] = np.inf  # self is not a neighbour
        part = np.argpartition(de, k, axis=1)[:, :k]
        nn = np.take_along_axis(part, np.argsort(np.take_along_axis(
            de, part, 1), axis=1, kind="stable"), 1)
        do = np.maximum(xn[rows, None] + xn[None, :] - 2.0 * x[rows] @ x.T,
                        0.0)
        do[np.arange(len(rows)), rows] = -1.0  # self ranks first
        thr = np.take_along_axis(do, nn, 1)
        ranks = (do[:, None, :] < thr[:, :, None]).sum(-1)
        penalty += float(np.maximum(ranks - k, 0).sum())
    return 1.0 - 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)) * penalty


def _label_scores64(truth: np.ndarray, pred: np.ndarray, n_t: int,
                    n_p: int) -> dict:
    """raft_tpu's contingency scores in float64 numpy."""
    c = np.bincount(truth * n_p + pred, minlength=n_t * n_p).reshape(
        n_t, n_p).astype(np.float64)
    n = c.sum()
    comb = (c * (c - 1)).sum() / 2
    ra = (c.sum(1) * (c.sum(1) - 1)).sum() / 2
    rb = (c.sum(0) * (c.sum(0) - 1)).sum() / 2
    total = n * (n - 1) / 2
    expected = ra * rb / total

    def entropy(counts):
        p = counts[counts > 0] / counts.sum()
        return float(-(p * np.log(p)).sum())

    pij = c / n
    outer = pij.sum(1, keepdims=True) * pij.sum(0, keepdims=True)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / outer[nz])).sum())
    h_t, h_p = entropy(c.sum(1)), entropy(c.sum(0))
    hom = mi / h_t if h_t > 0 else 1.0
    com = mi / h_p if h_p > 0 else 1.0
    return {"rand_index": (total + 2 * comb - ra - rb) / total,
            "adjusted_rand_index": (comb - expected)
            / (0.5 * (ra + rb) - expected),
            "mutual_info_score": mi, "homogeneity_score": hom,
            "completeness_score": com,
            "v_measure": 2 * hom * com / (hom + com), "entropy": h_t}


def phase(*, smi, dev, seed, dataset, queries, gt_i, km_centers,
          emit: Callable, timed: Callable,
          launch_counts: Callable) -> Dict[str, int]:
    """Phase 6i (module docstring). Returns the phase's main-path launches
    by kernel."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.linalg import eigsh

    from raft_tpu_torch import sparse, stats
    from raft_tpu_torch.bench.datagen import low_rank_cluster_ids
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import (ball_cover, brute_force,
                                          epsilon_neighborhood, ivf_flat,
                                          quantize)
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops import kernels as gram
    from raft_tpu_torch.ops import linalg
    from raft_tpu_torch.stats import neighborhood_recall
    from raft_tpu_torch.testing import assert_topk_close

    t_phase = time.perf_counter()
    gc.collect()  # the earlier phases' cyclic garbage may hold card memory
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    res = Resources(device=dev, seed=seed, workspace_limit_bytes=WORKSPACE)
    total = {name: 0 for name in gk.LAUNCHES}
    rng = np.random.default_rng(seed + 6)

    def counted(fn):
        """(fn(), seconds, its launches), the counts set to 0 just before
        and read just after; the launches added to the phase's."""
        gk.reset_launch_counts()
        out, secs = timed(fn)
        _sync(dev)
        got = launch_counts()
        for name in gk.LAUNCHES:
            total[name] += got[name]
        return out, secs, got

    def line(name, **kw):
        emit({"phase": "breadth", "part": name, "card": smi, **kw})

    def fail(msg):
        raise AssertionError(f"phase 6i: {msg}")

    # ---- ball cover: haversine 2-D and euclidean 3-D
    for label, metric, make in (("haversine_2d", "haversine", _geo_points),
                                ("euclidean_3d", "euclidean", _cube_points)):
        pts_np = make(rng, BC_ROWS + BC_QUERIES, BC_CLUSTERS)
        pts = torch.from_numpy(pts_np[:BC_ROWS]).to(dev)
        q = torch.from_numpy(pts_np[BC_ROWS:]).to(dev)
        index, build_s, _ = counted(lambda: ball_cover.build(pts, metric,
                                                             res=res))
        (fd, fi), bf_s, bf_l = counted(lambda: brute_force.knn(
            q, pts, BC_K, metric=metric, res=res))
        if metric == "haversine":
            atol, tol64 = 1e-7, 1e-6

            def hold(got, name):
                return assert_topk_close(got, (fd, fi), atol, 1e-5, name)
        else:
            atol = 1e-6 * float(torch.amax((pts * pts).sum(1)))
            tol64 = atol

            def hold(got, name):
                return assert_topk_close((got[0] * got[0], got[1]),
                                         (fd * fd, fi), atol, 1e-5, name)
        knn_runs = {}
        # the default probes, then one probe: pass 1 then leaves most
        # lists to pass 2, which runs in query chunks
        for probes in (None, 1):
            chunks, real = [], ball_cover._pass2

            def spy(q_, index_, sub, *a):
                chunks.append((q_.shape[0], sub))
                return real(q_, index_, sub, *a)

            ball_cover._pass2 = spy
            try:
                got, knn_s, knn_l = counted(lambda: ball_cover.knn(
                    index, q, BC_K, n_init_probes=probes, res=res))
            finally:
                ball_cover._pass2 = real
            union = (np.unique(np.concatenate([s for _, s in chunks]))
                     if chunks else np.zeros(0, np.int64))
            knn_runs["default_probes" if probes is None else "one_probe"] = {
                "seconds": knn_s, "qps": BC_QUERIES / knn_s,
                "pass2_chunks": len(chunks),
                "pass2_query_chunk": max((c for c, _ in chunks), default=0),
                "pass2_lists_union": int(len(union)),
                "pass2_lists_mean_chunk": float(np.mean(
                    [len(s) for _, s in chunks])) if chunks else 0.0,
                "pass2_lists_max_chunk": max((len(s) for _, s in chunks),
                                             default=0),
                **hold(got, f"ball_cover {label}, {probes} probes"),
                "launches": knn_l}
            del got
        # eps_nn: 1,000 queries, eps at the median 64th-neighbour distance
        qe = q[:EPS_QUERIES]
        d64_nn, _ = brute_force.knn(qe, pts, EPS_DEGREE, metric=metric,
                                    res=res)
        eps = float(torch.median(d64_nn[:, -1]))
        (adj, deg), eps_s, eps_l = counted(
            lambda: ball_cover.eps_nn(index, qe, eps, res=res))
        diff = np.concatenate([torch.nonzero(
            adj[s:s + EPS_CHECK_CHUNK] != epsilon_neighborhood.eps_neighbors(
                qe[s:s + EPS_CHECK_CHUNK], pts, eps, metric=metric,
                res=res)[0]).cpu().numpy() + [s, 0]
            for s in range(0, EPS_QUERIES, EPS_CHECK_CHUNK)])
        d_pairs = _rooted64(metric, pts_np[BC_ROWS:][diff[:, 0]],
                            pts_np[diff[:, 1]])
        off = (np.abs(d_pairs ** 2 - eps ** 2) > tol64 if metric != "haversine"
               else np.abs(d_pairs - eps) > tol64)
        if off.any():
            fail(f"ball_cover {label} eps_nn: {int(off.sum())} pairs differ "
                 "from eps_neighbors away from the eps boundary")
        line("ball_cover", data=label, metric=metric, rows=BC_ROWS,
             queries=BC_QUERIES, k=BC_K, workspace_bytes=WORKSPACE,
             landmarks=index.n_landmarks,
             list_pad=index.list_data.shape[1], build_seconds=build_s,
             knn=knn_runs, brute_force_seconds=bf_s,
             eps=eps, eps_queries=EPS_QUERIES,
             eps_mean_degree=float(deg.float().mean()),
             eps_nn_seconds=eps_s, eps_pairs_excepted=int(len(diff)),
             launches={"brute_force": bf_l, "eps_nn": eps_l})
        del index, pts, q, adj, fd, fi
        gc.collect()

    # ---- the epsilon neighbourhood at DBSCAN's batch
    x, y = queries[:EN_X], dataset[:EN_Y]
    rows = rng.choice(EN_X, SAMPLE, replace=False)
    xs64 = x[torch.from_numpy(rows).to(dev)].cpu().numpy().astype(np.float64)
    y64 = y.cpu().numpy().astype(np.float64)
    d64 = ((xs64 * xs64).sum(1)[:, None] + (y64 * y64).sum(1)[None, :]
           - 2.0 * xs64 @ y64.T)  # float64 numpy: rounding far below tol
    eps_sq = float(np.quantile(d64, 0.001))
    (adj, deg), en_s, en_l = counted(
        lambda: epsilon_neighborhood.eps_neighbors(x, y, eps_sq, res=res))
    tol = 1e-6 * float((x * x).sum(1).max() + (y * y).sum(1).max())
    got = adj[torch.from_numpy(rows).to(dev)].cpu().numpy()
    wrong = (got != (d64 <= eps_sq)) & (np.abs(d64 - eps_sq) > tol)
    if wrong.any():
        fail(f"eps_neighbors: {int(wrong.sum())} pairs differ from float64 "
             "away from the boundary")
    line("eps_neighbors", x_rows=EN_X, y_rows=EN_Y, dim=x.shape[1],
         eps=eps_sq, seconds=en_s, mean_degree=float(deg.float().mean()),
         sampled_rows=SAMPLE,
         degree_excepted=int(np.abs(got.sum(1)
                                    - (d64 <= eps_sq).sum(1)).sum()),
         ms=_ms(lambda: epsilon_neighborhood.eps_neighbors(x, y, eps_sq,
                                                           res=res), dev),
         launches=en_l)
    del adj, got, d64, wrong

    # ---- Gram matrices at a kernel SVM's cache block
    gx, gy = dataset[:GRAM_N], dataset[GRAM_N:2 * GRAM_N]
    mean_sq = float((gx * gx).sum(1).mean())
    gamma_rbf = 1.0 / float(((gx[:SAMPLE] - gy[:SAMPLE]) ** 2).sum(1).mean())
    rows = torch.from_numpy(rng.choice(GRAM_N, SAMPLE, replace=False)).to(dev)
    gx64, gy64 = gx[rows].double(), gy.double()
    ip64 = gx64 @ gy64.T
    kinds = (
        (gram.KernelParams(gram.KernelType.LINEAR), lambda k: k),
        (gram.KernelParams(gram.KernelType.POLYNOMIAL, 3, 1.0 / mean_sq, 1.0),
         lambda k: (k / mean_sq + 1.0) ** 3),
        (gram.KernelParams(gram.KernelType.TANH, 3, 0.5 / mean_sq, 0.1),
         lambda k: torch.tanh(0.5 * k / mean_sq + 0.1)),
        (gram.KernelParams(gram.KernelType.RBF, 3, gamma_rbf),
         lambda k: torch.exp(-gamma_rbf * torch.clamp_min(
             (gx64 * gx64).sum(1)[:, None] + (gy64 * gy64).sum(1)[None, :]
             - 2.0 * k, 0.0))))
    gram_out = {}
    for params, ref in kinds:
        kmat, _, g_l = counted(lambda: gram.gram_matrix(gx, gy, params))
        want = ref(ip64)
        err = float((kmat[rows].double() - want).abs().max()
                    / want.abs().max())
        if err > 1e-5:
            fail(f"gram {params.kernel.name}: relative error {err} > 1e-5")
        gram_out[params.kernel.name] = {
            "relative_error": err, "launches": g_l,
            "ms": _ms(lambda: gram.gram_matrix(gx, gy, params), dev)}
        del kmat
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dense = torch.where(torch.rand((CSR_N, CSR_N), generator=gen, device=dev)
                        < CSR_DENSITY,
                        torch.randn((CSR_N, CSR_N), generator=gen,
                                    device=dev), 0.0)
    csr = sparse.convert.dense_to_csr(dense)
    k_csr, _, c_l = counted(lambda: gram.linear_kernel(csr, dense))
    rows = torch.from_numpy(rng.choice(CSR_N, SAMPLE, replace=False)).to(dev)
    want = dense[rows].double() @ dense.double().T
    csr_err = float((k_csr[rows].double() - want).abs().max()
                    / want.abs().max())
    if csr_err > 1e-5:
        fail(f"gram CSR: relative error {csr_err} > 1e-5")
    gram_out["LINEAR_CSR"] = {
        "relative_error": csr_err, "nnz": csr.nnz, "launches": c_l,
        "ms": _ms(lambda: gram.linear_kernel(csr, dense), dev, 1),
        "dense_ms": _ms(lambda: gram.linear_kernel(dense, dense), dev)}
    line("gram", rows=GRAM_N, cols=GRAM_N, dim=gx.shape[1],
         csr_shape=[CSR_N, CSR_N], csr_density=CSR_DENSITY, **gram_out)
    del dense, csr, k_csr, want

    # ---- linalg
    gen.manual_seed(seed)
    (u, s, v), rsvd_s, r_l = counted(
        lambda: linalg.rsvd(gen, dataset, RSVD_K, RSVD_P, RSVD_ITERS))
    r64 = torch.linalg.qr(dataset.double(), mode="r").R
    s64 = torch.linalg.svdvals(r64)[:RSVD_K]
    rsvd_err = float(((s.double() - s64).abs() / s64).max())
    if rsvd_err > 1e-3:
        fail(f"rsvd: singular values off by {rsvd_err} relative")
    del u, v, r64
    cov = stats.cov(dataset)
    c64 = cov.double()

    def rel(a):
        return float(torch.linalg.matrix_norm(a - c64)
                     / torch.linalg.matrix_norm(c64))

    su, ss, sv = linalg.svd(cov)
    ew, ev = linalg.eig_dc(cov)
    qq = linalg.qr_get_q(cov).double()
    ridge = 1e-3 * float(torch.diagonal(cov).mean())
    eye = torch.eye(cov.shape[0], device=dev)
    chol = linalg.cholesky(cov + ridge * eye).double()
    recon = {
        "svd": rel(su.double() * ss.double() @ sv.double().T),
        "eig_dc": rel(ev.double() * ew.double() @ ev.double().T),
        "qr_get_q": max(rel(qq @ (qq.T @ c64)),
                        float((qq.T @ qq - eye.double()).abs().max())),
        "cholesky": float(torch.linalg.matrix_norm(
            chol @ chol.T - (c64 + ridge * eye.double()))
            / torch.linalg.matrix_norm(c64))}
    if max(recon.values()) > 1e-4:
        fail(f"decompositions: reconstruction errors {recon}")
    xg = dataset[:GRAPH_ROWS]
    (_, nn), graph_s, graph_l = counted(lambda: brute_force.knn(
        xg, xg, GRAPH_K + 1, metric="sqeuclidean", res=res))
    n_g = xg.shape[0]
    coo = sparse.coo_from_arrays(
        torch.arange(n_g, device=dev).repeat_interleave(GRAPH_K),
        nn[:, 1:].reshape(-1), torch.ones(n_g * GRAPH_K, device=dev),
        (n_g, n_g))

    def normalized_graph():
        """A symmetrised (max) and D^-1/2, D the degrees (row sums)."""
        a = sparse.convert.coo_to_csr(sparse.linalg.symmetrize(coo))
        return a, 1.0 / torch.sqrt(sparse.linalg.row_norm(a, "l1"))

    (adj_csr, dinv), build_g_s, _ = counted(normalized_graph)

    def matvec(vec):
        return dinv * sparse.linalg.spmv(adj_csr, dinv * vec)

    gen.manual_seed(seed)
    (ritz, _), lz_s, lz_l = counted(lambda: linalg.lanczos(
        matvec, n_g, LANCZOS_K, generator=gen, ncv=LANCZOS_NCV,
        which="largest"))
    host = csr_matrix((adj_csr.data.double().cpu().numpy(),
                       adj_csr.indices.cpu().numpy(),
                       adj_csr.indptr.cpu().numpy()), shape=(n_g, n_g))
    dh = 1.0 / np.sqrt(np.asarray(host.sum(axis=1)).ravel())
    norm_a = host.multiply(dh[:, None]).multiply(dh[None, :]).tocsr()
    ref_vals, eigsh_s = timed(lambda: np.sort(eigsh(
        norm_a, k=LANCZOS_K, which="LA", return_eigenvectors=False))[::-1])
    if abs(float(ritz[0]) - 1.0) > 1e-4:
        fail(f"lanczos: top Ritz value {float(ritz[0])} not within 1e-4 "
             "of 1")
    dense_b = torch.randn((n_g, 16), generator=gen, device=dev)
    vec_b = torch.randn((n_g,), generator=gen, device=dev)
    keys = torch.randint(0, 1024, (dataset.shape[0],), generator=gen,
                         device=dev)
    twice = {
        "spmm": lambda: sparse.linalg.spmm(adj_csr, dense_b),
        "spmv": lambda: sparse.linalg.spmv(adj_csr, vec_b),
        "symmetrize_sum": lambda: sparse.linalg.symmetrize(coo, "sum").data,
        "reduce_rows_by_key": lambda: linalg.reduce_rows_by_key(
            dataset, keys, 1024)}
    bitwise = {name: _bitwise(fn(), fn()) for name, fn in twice.items()}
    if not all(bitwise.values()):
        fail(f"two runs differ: {bitwise}")
    line("linalg", rsvd={"rows": dataset.shape[0], "k": RSVD_K, "p": RSVD_P,
                         "n_iter": RSVD_ITERS, "seconds": rsvd_s,
                         "max_relative_error": rsvd_err, "launches": r_l},
         reconstruction_errors=recon, cholesky_ridge=ridge,
         lanczos={"graph_rows": n_g, "graph_k": GRAPH_K,
                  "nnz": adj_csr.nnz, "graph_knn_seconds": graph_s,
                  "graph_build_seconds": build_g_s, "seconds": lz_s,
                  "ncv": LANCZOS_NCV, "ritz": ritz.tolist(),
                  "eigsh_float64": ref_vals.tolist(),
                  "eigsh_seconds": eigsh_s,
                  "launches": {"graph": graph_l, "lanczos": lz_l}},
         bitwise_two_runs=bitwise,
         ms={name: _ms(fn, dev) for name, fn in twice.items()})
    del adj_csr, coo, dense_b, host, norm_a, nn

    # ---- stats: the rows' moments against float64
    x64 = dataset.double()
    moments, m_s, m_l = counted(lambda: {
        "mean": stats.mean(dataset), "var": stats.var(dataset),
        "stddev": stats.stddev(dataset), "cov": stats.cov(dataset),
        "minmax": stats.minmax(dataset),
        "histogram": stats.histogram(dataset, HIST_BINS)})
    refs = {"mean": x64.mean(0), "var": x64.var(0, correction=0),
            "stddev": x64.std(0, correction=0),
            "cov": torch.cov(x64.T, correction=1)}
    errs = {}
    for name, want in refs.items():
        got = moments[name].double()
        errs[name] = float(((got - want).abs()
                            / (want.abs() + want.abs().max() * 1e-5)).max())
    if max(errs["mean"], errs["var"], errs["stddev"]) > 1e-5 \
            or float((moments["cov"].double() - refs["cov"]).abs().max()
                     / refs["cov"].abs().max()) > 1e-4:
        fail(f"moments against float64: {errs}")
    mn, mx = moments["minmax"]
    if not (torch.equal(mn, dataset.amin(0)) and torch.equal(
            mx, dataset.amax(0))):
        fail("minmax differs from amin/amax")
    counts, edges = moments["histogram"]
    lo, hi = x64.min(), x64.max()
    width = (hi - lo) / HIST_BINS
    frac = ((x64 - lo) / width).reshape(-1)
    bins64 = torch.clamp(frac.floor(), 0, HIST_BINS - 1).to(torch.int64)
    counts64 = torch.bincount(bins64, minlength=HIST_BINS)
    near_edge = int(((frac - frac.round()).abs() <= 1e-4).sum())
    hist_off = int((counts.to(torch.int64) - counts64).abs().sum())
    if hist_off > 2 * near_edge or int(counts.sum()) != dataset.numel():
        fail(f"histogram: {hist_off} counts off, {near_edge} values near "
             "an edge")
    del x64, frac, bins64
    xs = dataset[:SIL_ROWS]
    (_, sil_labels, _, _), km_s, km_l = counted(lambda: kmeans.fit(
        xs, kmeans.KMeansParams(n_clusters=SIL_CLUSTERS, max_iter=20),
        res=res))
    sil, sil_s, _ = counted(lambda: stats.silhouette_score(
        xs, sil_labels, SIL_CLUSTERS))
    xs_np, lab_np = xs.cpu().numpy(), sil_labels.cpu().numpy()
    sil64 = _silhouette64(xs_np, lab_np.astype(np.int64), SIL_CLUSTERS)
    gen.manual_seed(seed)
    (pu, ps, _), _, _ = counted(lambda: linalg.rsvd(
        gen, xs - xs.mean(0, keepdim=True), 2))
    emb = pu * ps
    tw, tw_s, tw_l = counted(lambda: stats.trustworthiness_score(
        xs, emb, TRUST_K, res=res))
    tw64 = _trustworthiness64(xs_np, emb.cpu().numpy(), TRUST_K)
    (pred, _), pred_s, pred_l = counted(lambda: kmeans.predict(
        km_centers, dataset, res=res))
    # phase 3's rows and queries came from one generator at this seed
    truth = low_rank_cluster_ids(
        np.random.default_rng(seed), dataset.shape[0] + queries.shape[0],
        dataset.shape[1])[:dataset.shape[0]]
    truth_t = torch.from_numpy(truth).to(dev)
    n_p = km_centers.shape[0]
    scores, sc_s, _ = counted(lambda: {
        name: float(getattr(stats, name)(truth_t, pred, N_CENTERS, n_p))
        for name in ("rand_index", "adjusted_rand_index", "mutual_info_score",
                     "homogeneity_score", "completeness_score", "v_measure")})
    scores["entropy"] = float(stats.entropy(truth_t, N_CENTERS))
    scores64 = _label_scores64(truth, pred.cpu().numpy().astype(np.int64),
                               N_CENTERS, n_p)
    score_err = max(abs(scores[k] - scores64[k]) for k in scores)
    if abs(float(sil) - sil64) > 1e-4 or abs(float(tw) - tw64) > 1e-4 \
            or score_err > 1e-4:
        fail(f"scores against float64: silhouette {float(sil)} / {sil64}, "
             f"trustworthiness {float(tw)} / {tw64}, labels {scores} / "
             f"{scores64}")
    line("stats", rows=dataset.shape[0], dim=dataset.shape[1],
         moments_seconds=m_s, moment_errors=errs,
         histogram={"bins": HIST_BINS, "counts_off": hist_off,
                    "values_near_an_edge": near_edge},
         silhouette={"rows": SIL_ROWS, "clusters": SIL_CLUSTERS,
                     "value": float(sil), "float64": sil64,
                     "kmeans_seconds": km_s, "seconds": sil_s,
                     "launches": km_l},
         trustworthiness={"rows": SIL_ROWS, "n_neighbors": TRUST_K,
                          "value": float(tw), "float64": tw64,
                          "seconds": tw_s, "launches": tw_l},
         label_scores={"rows": dataset.shape[0], "value": scores,
                       "float64": scores64, "predict_seconds": pred_s,
                       "scores_seconds": sc_s, "launches": pred_l})

    # ---- the scalar quantizer's int8 codes, searched
    sq, fit_s = timed(lambda: quantize.ScalarQuantizer.fit(
        dataset[:SQ_TRAIN].cpu().numpy()))
    (codes, qcodes), tr_s = timed(lambda: (
        sq.transform(dataset.cpu().numpy()),
        sq.transform(queries.cpu().numpy())))
    codes_t = torch.from_numpy(codes).to(dev)
    qcodes_t = torch.from_numpy(qcodes).to(dev)
    del codes, qcodes
    index, ivf_build_s, ivf_build_l = counted(lambda: ivf_flat.build(
        codes_t, ivf_flat.IndexParams(n_lists=SQ_LISTS), res=res))
    params = ivf_flat.SearchParams(n_probes=SQ_PROBES)
    (iv, ii), ivf_s, ivf_l = counted(lambda: ivf_flat.search(
        index, qcodes_t, SQ_K, params))
    twin = ivf_flat.Index(index.params, index.centers,
                          index.list_data.float(), index.list_indices,
                          index.list_sizes, index.n_rows,
                          index.overflow_data.float(),
                          index.overflow_indices)
    tv, ti = ivf_flat.search(twin, qcodes_t, SQ_K, params)
    twin_bitwise = _bitwise(iv, tv) and torch.equal(ii, ti)
    (_, bi), bf_s, bf_l = counted(lambda: brute_force.knn(
        qcodes_t, codes_t, SQ_K, metric="sqeuclidean", res=res))
    gt = gt_i[:, :SQ_K]
    ivf_recall = float(neighborhood_recall(ii, gt))
    bf_recall = float(neighborhood_recall(bi, gt))
    line("quantize", train_rows=SQ_TRAIN, rows=codes_t.shape[0],
         fit_seconds=fit_s, transform_seconds=tr_s,
         ivf_flat={"n_lists": SQ_LISTS, "n_probes": SQ_PROBES,
                   "build_seconds": ivf_build_s, "seconds": ivf_s,
                   "qps": queries.shape[0] / ivf_s,
                   "recall_at_10": ivf_recall,
                   "bitwise_f32_twin": twin_bitwise,
                   "launches": {"build": ivf_build_l, "search": ivf_l}},
         brute_force={"seconds": bf_s, "recall_at_10": bf_recall,
                      "launches": bf_l})
    if not twin_bitwise:
        fail("the int8 IVF-Flat search differs from its f32 twin's")
    if ivf_l["fused_ivf_topk"] < 1:
        fail("the int8 IVF-Flat search launched no fused_ivf_topk")
    del index, twin, codes_t

    line("breadth_launches", launches=dict(total),
         seconds=time.perf_counter() - t_phase)
    for name in ("fused_l2_topk", "fused_ivf_topk", "fused_l2_argmin"):
        if total[name] < 1:
            fail(f"no {name} launch on the main path")
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("breadth: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.bench.datagen import low_rank_clusters
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import gpu_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gk.build_all()
    rows = low_rank_clusters(np.random.default_rng(opts.seed),
                             N_ROWS + 10_000, DIM)
    dataset = torch.from_numpy(rows[:N_ROWS]).to(dev)
    queries = torch.from_numpy(rows[N_ROWS:]).to(dev)
    _, gt_i = brute_force.knn(queries, dataset, 10, metric="sqeuclidean")
    centers, *_ = kmeans.fit(dataset, kmeans.KMeansParams(n_clusters=1024,
                                                          max_iter=5))

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def launch_counts():
        return dict(gk.LAUNCHES)

    launches = phase(smi=smi, dev=dev, seed=opts.seed, dataset=dataset,
                     queries=queries, gt_i=gt_i, km_centers=centers,
                     emit=emit, timed=timed, launch_counts=launch_counts)
    emit({"breadth_launches": launches})
    return 0


if __name__ == "__main__":
    sys.exit(main())
