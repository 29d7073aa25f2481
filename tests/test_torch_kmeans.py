"""raft_tpu_torch's Lloyd k-means against raft_tpu's, on the CPU.

Lloyd iterations from the same starting centres (``init="array"``) are held
against the JAX package's: centres rtol 1e-4 (atol 1e-4 of the data's
largest coordinate; the scatter-add sums in another order), labels equal
away from near-ties, the same ``n_iter``. ``tol`` is below any nonzero
shift, so both packages stop exactly when the labels stop changing.
predict, cluster_cost and update_centroids are held at fixed centres:
labels equal away from near-ties, sums rtol 1e-5. k-means++ and random init
draw from ``torch.Generator`` and ``jax.random``, which give different
numbers, so those fits are held by their inertia, within 5% of JAX's on the
benchmark generator's clusters (ROADMAP "Build parity").
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from raft_tpu.core.resources import Resources as JResources
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.ops import gpu_kernels as gk

jkm = importlib.import_module("raft_tpu.cluster.kmeans")


def _cpu(seed=0):
    return Resources(device="cpu", seed=seed)


@pytest.fixture(scope="module")
def blobs():
    rows = low_rank_clusters(np.random.default_rng(41), 2000, 16,
                             n_centers=12, intrinsic=6, spread=4.0)
    return rows


def _far_from_ties(x, centers, tol):
    """Rows whose nearest centre beats the next by more than 2·tol (float64)."""
    d = ((x.astype(np.float64)[:, None, :]
          - np.asarray(centers, np.float64)[None]) ** 2).sum(-1)
    part = np.sort(d, axis=1)
    return part[:, 1] - part[:, 0] > 2 * tol


def _tol(x):
    return 1e-4 * float((x ** 2).sum(1).max())


def _start(x, k, seed):
    return x[np.random.default_rng(seed).choice(len(x), k, replace=False)]


@pytest.mark.parametrize("k,max_iter,seed", [(8, 50, 0), (12, 50, 1),
                                             (20, 5, 2), (20, 50, 3)])
def test_fit_from_array_init_matches_jax(blobs, k, max_iter, seed):
    x = blobs
    c0 = _start(x, k, seed)
    jp = jkm.KMeansParams(n_clusters=k, init="array", max_iter=max_iter,
                          tol=1e-12)
    tp = tkm.KMeansParams(n_clusters=k, init="array", max_iter=max_iter,
                          tol=1e-12)
    jc, jl, jinertia, jn = jkm.fit(x, jp, init_centers=c0)
    gk.reset_launch_counts()
    tc, tl, tinertia, tn = tkm.fit(x, tp, init_centers=c0, res=_cpu())
    assert sum(gk.LAUNCHES.values()) == 0
    assert tn == int(jn)
    assert tl.dtype == torch.int32 and tc.dtype == torch.float32
    atol = 1e-4 * float(np.abs(x).max())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=atol)
    ok = _far_from_ties(x, np.asarray(jc), _tol(x))
    assert ok.mean() > 0.95
    np.testing.assert_array_equal(tl.numpy()[ok], np.asarray(jl)[ok])
    np.testing.assert_allclose(float(tinertia), float(jinertia), rtol=1e-4)


def test_weighted_fit_matches_jax(blobs):
    x = blobs
    w = np.random.default_rng(42).uniform(0.2, 3.0, len(x)).astype(np.float32)
    c0 = _start(x, 10, 5)
    jp = jkm.KMeansParams(n_clusters=10, init="array", max_iter=30, tol=1e-12)
    tp = tkm.KMeansParams(n_clusters=10, init="array", max_iter=30, tol=1e-12)
    jc, jl, jinertia, jn = jkm.fit(x, jp, init_centers=c0, sample_weights=w)
    tc, tl, tinertia, tn = tkm.fit(x, tp, init_centers=c0, sample_weights=w,
                                   res=_cpu())
    assert tn == int(jn)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4 * float(np.abs(x).max()))
    ok = _far_from_ties(x, np.asarray(jc), _tol(x))
    np.testing.assert_array_equal(tl.numpy()[ok], np.asarray(jl)[ok])
    np.testing.assert_allclose(float(tinertia), float(jinertia), rtol=1e-4)
    # the weights matter: the unweighted fit from the same start differs
    uc = tkm.fit(x, tp, init_centers=c0, res=_cpu())[0]
    assert not torch.allclose(uc, tc)


def test_predict_and_cluster_cost_match_jax(blobs):
    x = blobs
    centers = _start(x, 16, 6) + 0.1
    jl, jinertia = jkm.predict(centers, x)
    tl, tinertia = tkm.predict(centers, x, device="cpu")
    ok = _far_from_ties(x, centers, _tol(x))
    assert ok.mean() > 0.95
    np.testing.assert_array_equal(tl.numpy()[ok], np.asarray(jl)[ok])
    np.testing.assert_allclose(float(tinertia), float(jinertia), rtol=1e-5)
    np.testing.assert_allclose(float(tkm.cluster_cost(x, centers,
                                                      device="cpu")),
                               float(jkm.cluster_cost(x, centers)), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_update_centroids_matches_jax(blobs, weighted):
    x = blobs
    # one centre far from every row: its cluster is empty and it stays put
    centers = np.concatenate([_start(x, 9, 7),
                              np.full((1, x.shape[1]), 1e3, np.float32)])
    w = (np.random.default_rng(43).uniform(0.5, 2.0, len(x)).astype(
        np.float32) if weighted else None)
    jc, jw = jkm.update_centroids(x, centers, sample_weights=w)
    tc, tw = tkm.compute_new_centroids(x, centers, sample_weights=w,
                                       device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5 * float(np.abs(x).max()))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    assert float(tw[-1]) == 0.0 and torch.equal(tc[-1], torch.from_numpy(
        centers[-1]))


@pytest.mark.parametrize("init", ["k-means++", "random"])
def test_seeded_inits_reach_jax_inertia(init):
    x = low_rank_clusters(np.random.default_rng(44), 3000, 32)
    jp = jkm.KMeansParams(n_clusters=24, init=init, max_iter=40, n_init=2)
    tp = tkm.KMeansParams(n_clusters=24, init=init, max_iter=40, n_init=2)
    j_inertia = float(jkm.fit(x, jp, res=JResources(seed=0))[2])
    t_inertia = float(tkm.fit(x, tp, res=_cpu(0))[2])
    assert abs(t_inertia - j_inertia) <= 0.05 * j_inertia
    # the same seed gives the same fit; the restarts keep the best
    again = tkm.fit(x, tp, res=_cpu(0))
    assert float(again[2]) == t_inertia
    single = tkm.fit(x, dataclasses.replace(tp, n_init=1), res=_cpu(0))
    assert t_inertia <= float(single[2])


def test_kmeans_pp_falls_back_to_uniform_on_duplicate_rows():
    # 3 distinct rows, 5 clusters: after the distinct rows are taken every
    # distance is 0 and the draw is uniform; the fit still completes
    x = np.repeat(np.eye(3, 4, dtype=np.float32), 10, axis=0)
    c, labels, inertia, _ = tkm.fit(
        x, tkm.KMeansParams(n_clusters=5, max_iter=5), res=_cpu(1))
    assert float(inertia) == 0.0
    assert torch.isfinite(c).all()
    assert {tuple(r) for r in c.tolist()} == {tuple(r) for r in
                                              np.eye(3, 4).tolist()}


def test_kmeans_pp_centres_are_data_rows_and_inertia_drops():
    x = low_rank_clusters(np.random.default_rng(45), 1500, 16)
    xt = torch.from_numpy(x)
    c0 = tkm._kmeans_pp_init(torch.Generator().manual_seed(3), xt, 16)
    assert all(bool((xt == c).all(1).any()) for c in c0)
    start = float(tkm.cluster_cost(x, c0, device="cpu"))
    c, _, inertia, _ = tkm.fit(x, tkm.KMeansParams(
        n_clusters=16, init="array"), init_centers=c0, res=_cpu())
    assert float(inertia) <= start


def test_weighted_draw_takes_more_than_2_pow_24_rows():
    # torch.multinomial refuses more than 2^24 categories; the k-means++
    # draw must not: one row of positive weight past 2^24 is the only pick
    n = 2 ** 24 + 10
    w = torch.zeros(n, dtype=torch.float32)
    w[n - 5] = 0.25
    gen = torch.Generator().manual_seed(7)
    for _ in range(3):
        assert tkm._weighted_draw(gen, w).tolist() == [n - 5]
    picks = torch.cat([tkm._weighted_draw(gen, torch.ones(n))
                       for _ in range(4)])
    assert bool(((picks >= 0) & (picks < n)).all())


def test_weighted_draw_follows_the_weights():
    # 4000 draws over weights (1, 0, 3, 0): rows 1 and 3 never, row 2 with
    # probability 3/4 (binomial sd 0.0068; 0.04 is 5.8 sd)
    w = torch.tensor([1.0, 0.0, 3.0, 0.0])
    gen = torch.Generator().manual_seed(8)
    picks = torch.cat([tkm._weighted_draw(gen, w) for _ in range(4000)])
    assert set(picks.tolist()) <= {0, 2}
    assert abs(float((picks == 2).double().mean()) - 0.75) < 0.04


def test_find_k_on_separated_blobs_matches_jax():
    rng = np.random.default_rng(46)
    means = np.array([[0, 0], [30, 0], [0, 30], [30, 30]], np.float32)
    x = (means[rng.integers(0, 4, 800)]
         + rng.standard_normal((800, 2))).astype(np.float32)
    params = dict(max_iter=50, n_init=3)
    j = jkm.find_k(x, 7, 2, jkm.KMeansParams(**params), res=JResources(seed=0))
    t = tkm.find_k(x, 7, 2, tkm.KMeansParams(**params), res=_cpu(0))
    assert t == j == 4
    assert tkm.find_k(x, 3, 2, tkm.KMeansParams(**params), res=_cpu(0)) == 3


def test_fit_predict_returns_the_fit(blobs):
    p = tkm.KMeansParams(n_clusters=6, max_iter=20)
    c, labels = tkm.fit_predict(blobs, p, res=_cpu(2))
    c2, labels2, _, _ = tkm.fit(blobs, p, res=_cpu(2))
    assert torch.equal(c, c2) and torch.equal(labels, labels2)


@pytest.mark.parametrize("case", ["metric", "array_without_centers",
                                  "centers_without_array", "too_many"])
def test_errors_match_jax(blobs, case):
    x = blobs[:20]
    kw = {"metric": dict(params=dict(metric="inner_product")),
          "array_without_centers": dict(params=dict(init="array")),
          "centers_without_array": dict(params={}, init_centers=x[:3]),
          "too_many": dict(params=dict(n_clusters=21))}[case]
    with pytest.raises(Exception) as jerr:
        jkm.fit(x, jkm.KMeansParams(**kw["params"]),
                init_centers=kw.get("init_centers"))
    with pytest.raises(jerr.type, match=str(jerr.value)[:20].replace(
            "(", r"\(")):
        tkm.fit(x, tkm.KMeansParams(**kw["params"]),
                init_centers=kw.get("init_centers"), res=_cpu())
