"""raft_tpu_torch's graph layer against raft_tpu's, on the CPU, on the same
seeded numpy inputs: ``sparse.distance``, ``sparse.neighbors``,
``sparse.mst``, ``cluster.single_linkage``, ``sparse.solver``,
``sparse.spectral`` and the top-level ``spectral`` alias.

Tolerances: sparse distances and the cross-component distances rtol 1e-5
with atol 1e-5 of the largest |value| (fp32 sums in another order); kNN
results through ``testing.assert_topk_close`` at the same tolerance; ids of
the cross-component 1-NN equal wherever the gap to the second-nearest
other-colour row exceeds twice it. The MST's (src, dst, weight), single
linkage's labels on raft_tpu's own graph, and ``mst`` run twice are
bitwise. The spectral embeddings and Lanczos pairs (both packages handed
the same start vector) agree up to a sign per column within 1e-4, the cut
figures within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from raft_tpu.cluster import single_linkage as jsl
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.sparse import distance as jdist
from raft_tpu.sparse import mst as jmst
from raft_tpu.sparse import neighbors as jnb
from raft_tpu.sparse import solver as jsolver
from raft_tpu.sparse import spectral as jspec
from raft_tpu.sparse import types as jtypes
import raft_tpu_torch
from raft_tpu_torch import interop
from raft_tpu_torch.cluster import single_linkage as tsl
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.ops import linalg as tlin
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.sparse import distance as tdist
from raft_tpu_torch.sparse import mst as tmst
from raft_tpu_torch.sparse import neighbors as tnb
from raft_tpu_torch.sparse import solver as tsolver
from raft_tpu_torch.sparse import spectral as tspec
from raft_tpu_torch.testing import assert_topk_close

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol_scale=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    scale = float(np.max(np.abs(want[finite]))) if finite.any() else 0.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol_scale * max(scale, 1e-30))


def _same_up_to_sign(a, b, atol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.sign(np.sum(a * b, axis=0))
    s[s == 0] = 1
    np.testing.assert_allclose(a * s, b, atol=atol)


def _sparse_rows(rng, n, d, density, positive=False):
    """(indptr, indices, data) of a random CSR, rows sorted by column."""
    dense = np.where(rng.random((n, d)) < density,
                     rng.random((n, d)) + 0.1 if positive
                     else rng.standard_normal((n, d)), 0.0).astype(np.float32)
    rows, cols = np.nonzero(dense)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return (indptr.astype(np.int32), cols.astype(np.int32),
            dense[rows, cols].astype(np.float32))


def _both_csr(arrs, shape):
    return (jtypes.csr_from_scipy_like(*arrs, shape),
            interop.csr_from_numpy(*arrs, shape, device="cpu"))


POSITIVE = {DistanceType.JensenShannon, DistanceType.KLDivergence}


# ------------------------------------------------------- sparse.distance


@pytest.mark.parametrize("metric", tdist.SUPPORTED, ids=lambda m: m.name)
def test_sparse_pairwise_distance_every_metric(metric):
    rng = np.random.default_rng(int(metric))
    d = 40
    pos = metric in POSITIVE
    jx, tx = _both_csr(_sparse_rows(rng, 16, d, 0.3, pos), (16, d))
    jy, ty = _both_csr(_sparse_rows(rng, 15, d, 0.3, pos), (15, d))
    # a budget of 8 x rows a tile: two tiles in both packages
    budget = d * 16 * 8
    want = jdist.pairwise_distance(jx, jy, metric.name, 3.0,
                                   res=JResources(workspace_limit_bytes=budget))
    got = tdist.pairwise_distance(
        tx, ty, metric.name, 3.0,
        res=Resources(device="cpu", workspace_limit_bytes=budget))
    _close(got, want)


def test_sparse_pairwise_distance_refuses_what_raft_tpu_refuses():
    rng = np.random.default_rng(1)
    jx, tx = _both_csr(_sparse_rows(rng, 4, 6, 0.5), (4, 6))
    with pytest.raises(NotImplementedError) as je:
        jdist.pairwise_distance(jx, jx, "correlation")
    with pytest.raises(NotImplementedError) as te:
        tdist.pairwise_distance(tx, tx, "correlation", device="cpu")
    assert str(te.value) == str(je.value)
    _, ty = _both_csr(_sparse_rows(rng, 4, 7, 0.5), (4, 7))
    with pytest.raises(ValueError, match="dim mismatch"):
        tdist.pairwise_distance(tx, ty, device="cpu")


@pytest.mark.parametrize("metric", ["cosine", "jaccard", "sqeuclidean",
                                    "inner_product"])
def test_sparse_knn(metric):
    rng = np.random.default_rng(7)
    jq, tq = _both_csr(_sparse_rows(rng, 25, 64, 0.2), (25, 64))
    jy, ty = _both_csr(_sparse_rows(rng, 90, 64, 0.2), (90, 64))
    wv, wi = jdist.knn(jq, jy, 6, metric)
    got = tdist.knn(tq, ty, 6, metric, device="cpu")
    wv = np.asarray(wv)
    assert_topk_close(got, (wv, np.asarray(wi)), 1e-5 * np.abs(wv).max(),
                      RTOL, metric)
    # brute_force_knn: the database first
    got2 = tnb.brute_force_knn(ty, tq, 6, metric, device="cpu")
    assert torch.equal(got2[0], got[0]) and torch.equal(got2[1], got[1])


# ------------------------------------------------------ sparse.neighbors


def _blob_rows(rng, n, d, n_blobs, scale=6.0):
    centres = rng.standard_normal((n_blobs, d)) * scale
    which = rng.integers(0, n_blobs, n)
    x = (centres[which] + rng.standard_normal((n, d))).astype(np.float32)
    return x, which.astype(np.int32)


@pytest.mark.parametrize("tile", [16, 1024])
def test_cross_component_nn(tile):
    rng = np.random.default_rng(3)
    x, colors = _blob_rows(rng, 70, 5, 4)
    colors[5] = -1  # a negative colour: that row gets +inf, column 0
    wv, wi = jnb.cross_component_nn(x, colors, tile=tile)
    tv, ti = tnb.cross_component_nn(torch.from_numpy(x),
                                    torch.from_numpy(colors), tile=tile)
    wv, wi = np.asarray(wv), np.asarray(wi)
    _close(tv, wv)
    assert ti.dtype == torch.int32 and not np.isfinite(tv[5].item())
    # ids equal away from near-ties: the float64 gap to the second-nearest
    # row of another colour
    x64 = x.astype(np.float64)
    d64 = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    d64[(colors[:, None] == colors[None, :]) | (colors[:, None] < 0)] = np.inf
    two = np.sort(d64, axis=1)[:, :2]
    tol = 1e-5 * np.abs(wv[np.isfinite(wv)]).max()
    clear = np.isfinite(two[:, 1])
    clear[clear] = two[clear, 1] - two[clear, 0] > 2 * tol
    assert clear.sum() > 60
    np.testing.assert_array_equal(ti.numpy()[clear], wi[clear])
    assert ti[5] == wi[5] == 0
    rows, cols, dist = tnb.connect_components_edges(torch.from_numpy(x),
                                                    torch.from_numpy(colors))
    assert torch.equal(rows, torch.arange(70, dtype=torch.int32))
    assert torch.equal(cols, ti) and torch.equal(dist, tv)


def test_cross_component_nn_one_colour_is_all_inf():
    x = np.random.default_rng(0).standard_normal((9, 3)).astype(np.float32)
    v, i = tnb.cross_component_nn(torch.from_numpy(x), torch.zeros(9))
    assert torch.isinf(v).all() and (i == 0).all()


# ------------------------------------------------------------- sparse.mst


def _random_graph(rng, n, n_edges, max_w):
    u = rng.integers(0, n, n_edges)
    v = rng.integers(0, n, n_edges)
    w = rng.integers(1, max_w + 1, n_edges).astype(np.float32)
    return (np.concatenate([u, v]).astype(np.int32),
            np.concatenate([v, u]).astype(np.int32), np.concatenate([w, w]))


def _mst_both(rows, cols, w, n):
    want = jmst.mst(jtypes.coo_from_arrays(rows, cols, w, (n, n)))
    got = tmst.mst(interop.coo_from_numpy(rows, cols, w, (n, n),
                                          device="cpu"))
    return got, want


@pytest.mark.parametrize("seed,n,n_edges,max_w", [
    (0, 60, 150, 3), (1, 60, 400, 2), (2, 60, 60, 50), (3, 60, 250, 1)])
def test_mst_bitwise_with_tied_integer_weights(seed, n, n_edges, max_w):
    rows, cols, w = _random_graph(np.random.default_rng(seed), n, n_edges,
                                  max_w)
    got, want = _mst_both(rows, cols, w, n)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    again = tmst.mst(interop.coo_from_numpy(rows, cols, w, (n, n),
                                            device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_mst_disconnected_forest_bitwise():
    # two triangles and an isolated vertex, no edge between them
    r = np.array([0, 1, 2, 0, 3, 4, 5, 3])
    c = np.array([1, 2, 0, 2, 4, 5, 3, 5])
    w = np.array([1, 1, 2, 2, 3, 1, 1, 3], np.float32)
    rows, cols = np.concatenate([r, c]), np.concatenate([c, r])
    got, want = _mst_both(rows, cols, np.concatenate([w, w]), 7)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert int(torch.isfinite(got[2]).sum()) == 4
    assert got[0][4:].tolist() == [-1, -1]


# ------------------------------------------------- cluster.single_linkage


def test_single_linkage_connectivity_equals_raft_tpu():
    rng = np.random.default_rng(5)
    x, _ = _blob_rows(rng, 120, 6, 5, scale=3.0)
    k = 8
    want = jsl._knn_connectivity(jnp.asarray(x), k,
                                 jsl.SingleLinkageParams().metric,
                                 JResources(seed=0))
    got = tsl._knn_connectivity(torch.from_numpy(x), k,
                                tsl.SingleLinkageParams().metric,
                                Resources(device="cpu"))
    n = x.shape[0]
    half = n * k
    wv = np.asarray(want.data)[:half].reshape(n, k)
    wi = np.asarray(want.cols)[:half].reshape(n, k)
    assert_topk_close((got.data[:half].reshape(n, k),
                       got.cols[:half].reshape(n, k)), (wv, wi),
                      1e-5 * wv.max(), RTOL, "connectivity")
    np.testing.assert_array_equal(got.rows[:half].numpy(),
                                  np.asarray(want.rows)[:half])
    assert torch.equal(got.rows[:half], torch.arange(n, dtype=torch.int32
                                                     ).repeat_interleave(k))
    assert torch.equal(got.rows[half:], got.cols[:half])
    assert torch.equal(got.cols[half:], got.rows[:half])
    assert torch.equal(got.data[half:], got.data[:half])


@pytest.mark.parametrize("n_clusters", [1, 3, 7])
def test_single_linkage_labels_on_raft_tpu_graph_bitwise(n_clusters):
    rng = np.random.default_rng(11)
    x, _ = _blob_rows(rng, 90, 4, 6, scale=4.0)
    params = jsl.SingleLinkageParams(n_clusters=n_clusters, connectivity_k=6)
    graph = jsl._knn_connectivity(jnp.asarray(x), 6, params.metric,
                                  JResources(seed=0))
    want = jsl.single_linkage(x, params, res=JResources(seed=0))
    src, dst, w = tmst.mst(interop.coo_from_numpy(
        graph.rows, graph.cols, graph.data, graph.shape, device="cpu"))
    got = tsl._label_dendrogram(src.numpy(), dst.numpy(), w.numpy(), 90,
                                n_clusters)
    np.testing.assert_array_equal(got, want)


def test_single_linkage_two_blobs():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((30, 2)).astype(np.float32)
    x = np.concatenate([a, rng.standard_normal((30, 2)).astype(np.float32)
                        + 20.0])
    labels = tsl.single_linkage(
        x, tsl.SingleLinkageParams(n_clusters=2, connectivity_k=10),
        device="cpu")
    assert labels.dtype == np.int32 and len(np.unique(labels)) == 2
    assert len(np.unique(labels[:30])) == 1
    assert len(np.unique(labels[30:])) == 1
    with pytest.raises(ValueError, match="out of range"):
        tsl.single_linkage(x, tsl.SingleLinkageParams(n_clusters=61),
                           device="cpu")


# ------------------------------------------------- sparse.solver, spectral


def _block_graph(rng, sizes, p_in=0.5, bridges=((0, 20),)):
    """A symmetric 0/1 adjacency of dense blocks joined by a few bridges."""
    n = sum(sizes)
    a = np.zeros((n, n), np.float32)
    s = 0
    for size in sizes:
        a[s:s + size, s:s + size] = rng.random((size, size)) < p_in
        s += size
    for i, j in bridges:
        a[i, j] = a[j, i] = 1.0
    np.fill_diagonal(a, 0)
    a = np.maximum(a, a.T)
    rows, cols = np.nonzero(a)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return (indptr.astype(np.int32), cols.astype(np.int32),
            a[rows, cols]), n


def _jax_start(key, n):
    return np.array(jax.random.normal(key, (n,), jnp.float32))


def test_fit_embedding_with_jax_start_vector(monkeypatch):
    rng = np.random.default_rng(4)
    arrs, n = _block_graph(rng, [20, 16, 12], p_in=0.6,
                           bridges=((0, 20), (19, 36), (5, 40)))
    jadj, tadj = _both_csr(arrs, (n, n))
    key = jax.random.key(3)
    v0 = _jax_start(key, n)
    monkeypatch.setattr(tlin, "_start_vector",
                        lambda g, n_: torch.from_numpy(v0))
    want = jspec.fit_embedding(jadj, 2, key=key)
    got = tspec.fit_embedding(tadj, 2, device="cpu")
    _same_up_to_sign(got.numpy(), want)


def test_spectral_partition_and_modularity_recover_the_blocks():
    rng = np.random.default_rng(0)
    arrs, n = _block_graph(rng, [20, 20])
    _, tadj = _both_csr(arrs, (n, n))
    res = Resources(device="cpu", seed=0)
    for fn in (tspec.partition, tspec.modularity_maximization):
        labels, emb = fn(tadj, 2, res=res)
        assert labels.shape == (n,) and emb.shape[0] == n
        assert (labels[:20] == labels[0]).mean() >= 0.9
        assert (labels[20:] == labels[20]).mean() >= 0.9
        assert labels[0] != labels[20]
    cut, _ = tspec.analyze_partition(tadj, labels)
    assert cut <= 4.0
    assert raft_tpu_torch.spectral.partition is tspec.partition
    assert raft_tpu_torch.spectral.analyze_partition is tspec.analyze_partition


@pytest.mark.parametrize("modularity", [False, True])
def test_phase_6j_spectral_holds(monkeypatch, modularity):
    # the float64 Lanczos that phase 6j holds each spectral run to, from
    # raft_tpu's start vector: the port's fp32 Ritz values within 1e-5 of
    # the largest and its span within a sine of 1e-4; the k-means labels
    # the nearest of the final centres, and a moved label caught
    from raft_tpu_torch.bench import graph as bgraph
    from raft_tpu_torch.cluster import kmeans

    rng = np.random.default_rng(11)
    arrs, n = _block_graph(rng, [24, 20, 16], p_in=0.5,
                           bridges=((0, 24), (23, 44), (5, 50)))
    _, tadj = _both_csr(arrs, (n, n))
    v0 = _jax_start(jax.random.key(5), n)
    monkeypatch.setattr(tlin, "_start_vector",
                        lambda g, n_: torch.from_numpy(v0))
    k, ncv, which = 3, 20, "largest" if modularity else "smallest"
    op64 = bgraph.spectral_operator64(tadj, modularity)
    dense = torch.from_numpy(np.stack([op64(e) for e in np.eye(n)]).astype(
        np.float32))
    theta, vecs = tlin.lanczos(lambda v: torch.matmul(dense, v), n, k,
                               ncv=ncv, which=which, device="cpu")
    t64, v64, every = bgraph.lanczos64(op64, v0, ncv, k, which)
    assert np.abs(theta.double().numpy() - t64).max() <= 1e-5 * np.abs(
        every).max()
    assert bgraph.subspace_sin(vecs.numpy(), v64) <= 1e-4
    x = torch.nn.functional.normalize(vecs, dim=1)
    centres, labels = kmeans.fit_predict(
        x, kmeans.KMeansParams(n_clusters=3),
        res=Resources(device="cpu", seed=0))
    misses, clear = bgraph.nearest_centre_misses(
        x.numpy(), centres.numpy(), labels.numpy(), 1e-5)
    assert misses == 0 and clear > 0
    moved = labels.numpy().copy()
    moved[0] = (moved[0] + 1) % 3
    assert bgraph.nearest_centre_misses(x.numpy(), centres.numpy(), moved,
                                        1e-5)[0] == 1


@pytest.mark.parametrize("weighted", [False, True])
def test_analyze_partition_matches_raft_tpu(weighted):
    rng = np.random.default_rng(8)
    arrs, n = _block_graph(rng, [15, 10, 12], bridges=((0, 15), (3, 30)))
    if weighted:
        arrs = (arrs[0], arrs[1],
                rng.random(len(arrs[2])).astype(np.float32) + 0.5)
    jadj, tadj = _both_csr(arrs, (n, n))
    labels = rng.integers(0, 4, n).astype(np.int32)
    want = jspec.analyze_partition(jadj, labels)
    got = tspec.analyze_partition(tadj, torch.from_numpy(labels))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("which", ["smallest", "largest"])
def test_sparse_lanczos_with_jax_start_vector(monkeypatch, which):
    rng = np.random.default_rng(9)
    arrs, n = _block_graph(rng, [18, 14, 10], p_in=0.4,
                           bridges=((0, 18), (20, 35)))
    data = arrs[2] * (1.0 + rng.random(len(arrs[2])).astype(np.float32))
    # a symmetric matrix: the weights of both directions equal
    dense = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), np.diff(arrs[0]))
    dense[rows, arrs[1]] = data
    dense = np.maximum(dense, dense.T)
    data = dense[rows, arrs[1]]
    jadj, tadj = _both_csr((arrs[0], arrs[1], data), (n, n))
    key = jax.random.key(1)
    v0 = _jax_start(key, n)
    monkeypatch.setattr(tlin, "_start_vector",
                        lambda g, n_: torch.from_numpy(v0))
    fn_j = jsolver.lanczos_smallest if which == "smallest" \
        else jsolver.lanczos_largest
    fn_t = tsolver.lanczos_smallest if which == "smallest" \
        else tsolver.lanczos_largest
    wj, vj = fn_j(jadj, 2, key=key, ncv=n)
    wt, vt = fn_t(tadj, 2, ncv=n)
    _close(wt, wj, rtol=1e-4, atol_scale=1e-4)
    _same_up_to_sign(vt.numpy(), vj)
    want = np.linalg.eigvalsh(dense.astype(np.float64))
    want = want[:2] if which == "smallest" else want[::-1][:2]
    np.testing.assert_allclose(wt.numpy(), want, atol=1e-4)
    with pytest.raises(ValueError, match="square"):
        tsolver.lanczos_eigsh(interop.csr_from_numpy(
            arrs[0], arrs[1], data, (n, n + 1), device="cpu"), 2)
