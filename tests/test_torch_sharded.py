"""raft_tpu_torch.parallel.sharded against raft_tpu.parallel.sharded, on the
CPU: JAX on the first S devices of its 8-device virtual CPU mesh, the port
on ``init_comms(["cpu"] * S)``.

- knn: ids equal away from near-ties and distances within rtol 1e-5, atol
  1e-4·max‖x‖² (``test_torch_brute_force.py``'s tolerance); the port's
  three merge engines bitwise equal.
- pairwise_distance: rtol 1e-5, atol 1e-5·max‖x‖² (fp32 products summed
  in another order).
- kmeans_fit from the same initial rows (and donor rows) as JAX's draw:
  labels equal away from near-ties of JAX's final centres, centres rtol
  1e-4 and atol 1e-4·max|x| (sums in another order, over the iterations).
- IVF-Flat and IVF-PQ (cache and LUT regimes) on identical state: a JAX
  sharded build carried over by ``interop``, searched by both; ids equal
  away from near-ties, distances within atol 1e-4 of the largest squared
  norm (IVF-PQ: of the largest ADC distance) and rtol 1e-5; the port's
  three engines bitwise equal.
- the port's own sharded builds: recall@10 against the port's exact
  sharded knn above a floor.
"""

import jax
import numpy as np
import pytest
import torch

from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import sharded as jsh
from raft_tpu_torch import interop
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import sharded as tsh
from raft_tpu_torch.stats import neighborhood_recall
from raft_tpu_torch.testing import assert_topk_close

ENGINES = ("allgather", "tree", "ring")


def _pair(size):
    return (jcomms.init_comms(jax.devices()[:size]),
            tcomms.init_comms(["cpu"] * size))


def _scale(db):
    return float((db ** 2).sum(1).max())


def _ladder(search, engines=ENGINES):
    """The port's engines' results, asserted bitwise equal; returns one."""
    first = search(engines[0])
    for e in engines[1:]:
        v, i = search(e)
        assert torch.equal(v.view(torch.int32), first[0].view(torch.int32)), e
        assert torch.equal(i, first[1]), e
    return first


# ------------------------------------------------------------------- knn


@pytest.mark.parametrize("size,n,k,kind", [(4, 1000, 10, "random"),
                                           (8, 1003, 7, "random"),
                                           (4, 9, 3, "random"),
                                           (8, 1024, 10, "duplicates")])
def test_knn_matches_jax(size, n, k, kind):
    jc, tc = _pair(size)
    rng = np.random.default_rng(n)
    if kind == "duplicates":  # the same 128 rows on every shard
        base = rng.standard_normal((128, 8)).astype(np.float32)
        db, q = np.tile(base, (8, 1)), base[:8] + 0.0
    else:
        db = rng.standard_normal((n, 16)).astype(np.float32)
        q = rng.standard_normal((12, 16)).astype(np.float32)
    want = jsh.knn(jc, q, db, k)
    got = _ladder(lambda e: tsh.knn(tc, q, db, k, merge_mode=e))
    assert_topk_close(got, (np.asarray(want[0]), np.asarray(want[1])),
                      1e-4 * _scale(db), 1e-5)
    assert bool((got[1] >= 0).all()) and bool((got[1] < n).all())
    if kind == "duplicates":  # ties go to the lowest global row first
        assert got[1][:, 0].tolist() == list(range(8))


@pytest.mark.parametrize("metric", ["inner_product", "euclidean"])
def test_knn_other_metrics_match_jax(metric):
    jc, tc = _pair(4)
    rng = np.random.default_rng(5)
    db = rng.standard_normal((400, 8)).astype(np.float32)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    want = jsh.knn(jc, q, db, 5, metric=metric)
    got = _ladder(lambda e: tsh.knn(tc, q, db, 5, metric=metric,
                                    merge_mode=e))
    scale = _scale(db)
    assert_topk_close(got, (np.asarray(want[0]), np.asarray(want[1])),
                      1e-4 * (np.sqrt(scale) if metric == "euclidean"
                              else scale), 1e-5)


@pytest.mark.parametrize("size,n,m", [(4, 50, 37), (8, 40, 64)])
def test_pairwise_distance_matches_jax(size, n, m):
    jc, tc = _pair(size)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    y = rng.standard_normal((m, 12)).astype(np.float32)
    want = np.asarray(jsh.pairwise_distance(jc, x, y))
    parts = tsh.pairwise_distance(tc, x, y)
    assert len(parts) == size
    got = torch.cat(parts).numpy()
    assert got.shape == want.shape == (n, m)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(_scale(x), _scale(y)))


# --------------------------------------------------------------- k-means


@pytest.fixture(scope="module")
def blobs():
    return low_rank_clusters(np.random.default_rng(17), 1200, 16,
                             n_centers=10, intrinsic=6, spread=5.0)


def _jax_draws(key, n, n_clusters, donor_pool):
    init = jax.random.choice(key, n, (n_clusters,), replace=False)
    pick = jax.random.randint(jax.random.fold_in(key, 1), (donor_pool,), 0,
                              n)
    return np.asarray(init), np.asarray(pick)


@pytest.mark.parametrize("balance", [None, 0.5])
@pytest.mark.parametrize("n_clusters,n_iters,seed", [(8, 10, 0),
                                                     (16, 6, 1)])
def test_kmeans_fit_matches_jax(blobs, monkeypatch, balance, n_clusters,
                                n_iters, seed):
    jc, tc = _pair(4)
    key = jax.random.key(seed)
    init, pick = _jax_draws(key, len(blobs), n_clusters, 64)
    monkeypatch.setattr(tsh, "_initial_rows",
                        lambda g, n, k: torch.from_numpy(init.copy()))
    monkeypatch.setattr(tsh, "_donor_rows",
                        lambda g, n, p: torch.from_numpy(pick.copy()))
    jc_, jl = jsh.kmeans_fit(jc, blobs, n_clusters, n_iters, key=key,
                             balance_threshold=balance, donor_pool=64)
    tc_, tl = tsh.kmeans_fit(tc, blobs, n_clusters, n_iters,
                             res=Resources(device="cpu"),
                             balance_threshold=balance, donor_pool=64)
    jc_ = np.asarray(jc_)
    np.testing.assert_allclose(tc_.numpy(), jc_, rtol=1e-4,
                               atol=1e-4 * float(np.abs(blobs).max()))
    d = ((blobs.astype(np.float64)[:, None] - jc_[None]) ** 2).sum(-1)
    part = np.sort(d, axis=1)
    clear = part[:, 1] - part[:, 0] > 2e-4 * _scale(blobs)
    assert clear.mean() > 0.9
    assert tl.dtype == torch.int32 and tl.shape == (len(blobs),)
    np.testing.assert_array_equal(tl.numpy()[clear], np.asarray(jl)[clear])


def test_kmeans_fit_with_an_empty_rank_and_its_own_draw():
    # 9 rows over 4 ranks: shards of 3, the last rank holds none
    tc = tcomms.init_comms(["cpu"] * 4)
    x = np.random.default_rng(0).standard_normal((9, 3)).astype(np.float32)
    centers, labels = tsh.kmeans_fit(tc, x, 3, 4, res=Resources(device="cpu"))
    assert centers.shape == (3, 3) and labels.shape == (9,)
    assert bool(torch.isfinite(centers).all())
    d = ((torch.from_numpy(x)[:, None] - centers[None]) ** 2).sum(-1)
    assert torch.equal(labels.long(), d.argmin(1))


# ------------------------------------------------------ IVF, identical state


def _skewed_rows(n, dim, seed):
    """Rows with one tight, crowded cluster, so that tight list pads spill
    rows to the overflow blocks."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3 * n // 4, dim)).astype(np.float32)
    b = (rng.standard_normal((n - len(a), dim)) * 0.05 + 2.0).astype(
        np.float32)
    rows = np.concatenate([a, b])
    return rows[rng.permutation(n)]


@pytest.fixture(scope="module")
def ivf_data():
    rows = _skewed_rows(1024 + 12, 16, 3)
    return rows[:1024], rows[1024:]


@pytest.fixture(scope="module")
def flat_pair(ivf_data):
    jc, tc = _pair(4)
    j = jsh.build_ivf_flat(jc, ivf_data[0], jflat.IndexParams(
        n_lists=4, list_pad_expansion=1.01), res=JResources(seed=0))
    assert j.overflow_data is not None
    t = interop.sharded_ivf_flat_from_numpy(
        tc, tflat.IndexParams(n_lists=4, list_pad_expansion=1.01),
        np.asarray(j.centers), np.asarray(j.list_data),
        np.asarray(j.list_indices), np.asarray(j.list_sizes), j.bounds,
        np.asarray(j.overflow_data), np.asarray(j.overflow_indices))
    return j, t


@pytest.mark.parametrize("n_probes", [1, 2, 4])
def test_sharded_ivf_flat_matches_jax_on_identical_state(flat_pair, ivf_data,
                                                         n_probes):
    j, t = flat_pair
    q = ivf_data[1]
    want = jsh.search_ivf_flat(j, q, 5, jflat.SearchParams(n_probes=n_probes))
    got = _ladder(lambda e: tsh.search_ivf_flat(
        t, q, 5, tflat.SearchParams(n_probes=n_probes), merge_mode=e))
    assert_topk_close(got, (np.asarray(want[0]), np.asarray(want[1])),
                      1e-4 * _scale(ivf_data[0]), 1e-5)


@pytest.fixture(scope="module")
def pq_pair(ivf_data):
    jc, tc = _pair(4)
    params = jpq.IndexParams(n_lists=4, pq_dim=8, kmeans_n_iters=3,
                             list_pad_expansion=1.01)
    j_lut = jsh.build_ivf_pq(jc, ivf_data[0], params, res=JResources(seed=0),
                             scan_mode="lut")
    j_cache = jsh.build_ivf_pq(jc, ivf_data[0], params,
                               res=JResources(seed=0), scan_mode="cache")
    # one build, assembled for each regime: the shared state is the same
    np.testing.assert_array_equal(np.asarray(j_lut.list_indices),
                                  np.asarray(j_cache.list_indices))
    assert j_lut.overflow_decoded is not None
    tparams = tpq.IndexParams(n_lists=4, pq_dim=8, kmeans_n_iters=3,
                              list_pad_expansion=1.01)
    common = (tc, tparams, j_lut.pq_dim, np.asarray(j_lut.centers),
              np.asarray(j_lut.rotation), np.asarray(j_lut.codebooks),
              np.asarray(j_lut.list_codes), np.asarray(j_lut.list_indices),
              np.asarray(j_lut.list_sizes), j_lut.bounds)
    over = dict(overflow_decoded=np.asarray(j_lut.overflow_decoded),
                overflow_norms=np.asarray(j_lut.overflow_norms),
                overflow_indices=np.asarray(j_lut.overflow_indices))
    t_lut = interop.sharded_ivf_pq_from_numpy(*common, scan_mode="lut",
                                              **over)
    t_cache = interop.sharded_ivf_pq_from_numpy(
        *common, scan_mode="cache",
        list_decoded=np.asarray(j_cache.list_decoded),
        decoded_norms=np.asarray(j_cache.decoded_norms), **over)
    return {"lut": (j_lut, t_lut), "cache": (j_cache, t_cache)}


@pytest.mark.parametrize("regime", ["cache", "lut"])
@pytest.mark.parametrize("n_probes", [1, 3])
def test_sharded_ivf_pq_matches_jax_on_identical_state(pq_pair, ivf_data,
                                                       regime, n_probes):
    j, t = pq_pair[regime]
    q = ivf_data[1]
    want = jsh.search_ivf_pq(j, q, 5, jpq.SearchParams(n_probes=n_probes))
    gk.reset_launch_counts()
    got = _ladder(lambda e: tsh.search_ivf_pq(
        t, q, 5, tpq.SearchParams(n_probes=n_probes), merge_mode=e))
    wv = np.asarray(want[0])
    assert_topk_close(got, (wv, np.asarray(want[1])),
                      1e-4 * float(np.abs(wv[np.isfinite(wv)]).max()), 1e-5)
    # each rank's search took the fused engine of the index's regime (the
    # plain versions run here on the CPU, and count no launch)
    plan = tpq.plan_search(t.indexes[0], 5,
                           tpq.SearchParams(n_probes=n_probes),
                           res=Resources(device="cpu"), memory_mode=regime)
    assert plan.engine == f"pallas_{regime}"
    assert sum(gk.LAUNCHES.values()) == 0


def test_decoded_only_overflow_refuses_another_dtype(pq_pair, ivf_data):
    # the carried-over overflow rows hold no codes: a search in another
    # scan_cache_dtype, or an extend, must raise, not decode placeholders
    j, t = pq_pair["lut"]
    over = [i for i in t.indexes if i.overflow_indices.shape[0] > 0]
    assert over and all(i.overflow_decoded_only for i in over)
    dtype = over[0].overflow_decoded.dtype
    other = torch.float32 if dtype != torch.float32 else torch.bfloat16
    sp = tpq.SearchParams(n_probes=2, scan_cache_dtype=other)
    with pytest.raises(ValueError, match="came decoded"):
        tsh.search_ivf_pq(t, ivf_data[1], 5, sp, merge_mode="ring")
    with pytest.raises(ValueError, match="cannot be extended"):
        tpq.extend(over[0], ivf_data[1][:4])
    assert over[0].overflow_decoded.dtype == dtype


# ------------------------------------------------------- the port's builds


@pytest.fixture(scope="module")
def clustered():
    rows = low_rank_clusters(np.random.default_rng(8), 4000 + 40, 24,
                             n_centers=16, intrinsic=8)
    return rows[:4000], rows[4000:]


@pytest.fixture(scope="module")
def exact(clustered):
    _, tc = _pair(4)
    return tsh.knn(tc, clustered[1], clustered[0], 10)


def test_own_sharded_ivf_flat_build_recall(clustered, exact):
    _, tc = _pair(4)
    res = Resources(device="cpu", seed=3)
    index = tsh.build_ivf_flat(tc, clustered[0], tflat.IndexParams(n_lists=8),
                               res=res)
    assert [i.device for i in index.indexes] == list(tc.devices)
    ids = torch.cat([i.list_indices[i.list_indices >= 0] for i in
                     index.indexes]
                    + [i.overflow_indices[i.overflow_indices >= 0]
                       for i in index.indexes])
    assert torch.equal(torch.sort(ids).values, torch.arange(4000))
    _, i = _ladder(lambda e: tsh.search_ivf_flat(
        index, clustered[1], 10, tflat.SearchParams(n_probes=4),
        merge_mode=e))
    assert float(neighborhood_recall(i, exact[1])) >= 0.9


@pytest.mark.parametrize("regime", ["cache", "lut"])
def test_own_sharded_ivf_pq_build_recall(clustered, exact, regime):
    _, tc = _pair(4)
    index = tsh.build_ivf_pq(tc, clustered[0],
                             tpq.IndexParams(n_lists=8, pq_dim=12),
                             res=Resources(device="cpu", seed=3),
                             scan_mode=regime)
    assert all((i.list_decoded is not None) == (regime == "cache")
               for i in index.indexes)
    _, i = _ladder(lambda e: tsh.search_ivf_pq(
        index, clustered[1], 10, tpq.SearchParams(n_probes=4),
        merge_mode=e))
    assert float(neighborhood_recall(i, exact[1])) >= 0.7


def test_build_is_seeded_from_the_callers_generator(clustered):
    _, tc = _pair(2)
    x = clustered[0][:600]
    a, b, c = (tsh.build_ivf_flat(tc, x, tflat.IndexParams(n_lists=4),
                                  res=Resources(device="cpu", seed=s))
               for s in (1, 1, 2))
    assert all(torch.equal(p.centers, q.centers)
               for p, q in zip(a.indexes, b.indexes))
    assert not all(torch.equal(p.centers, q.centers)
                   for p, q in zip(a.indexes, c.indexes))
    with pytest.raises(ValueError, match="n_lists"):
        tsh.build_ivf_flat(tc, x[:10], tflat.IndexParams(n_lists=8),
                           res=Resources(device="cpu"))


# --------------------------------------------------------- plan, dispatch


@pytest.mark.parametrize("mode,size", [("auto", 8), ("auto", 6),
                                       ("allgather", 6), ("tree", 4),
                                       ("ring", 3), ("ring", 8)])
def test_merge_dispatch_matches_jax(mode, size):
    want = jsh.merge_dispatch_explained(mode, size)
    got = tsh.merge_dispatch_explained(mode, size)
    assert got[:2] == want[:2]
    assert got[2] == ("plain" if mode == "ring" else "")
    # the plain shift only where every rank is on the CPU
    assert tsh.merge_dispatch_explained(mode, size, all_cpu=False)[2] == (
        "kernel" if mode == "ring" else "")


@pytest.mark.parametrize("mode,size,match", [("tree", 6, "power-of-two"),
                                             ("ring", 1, "at least 2"),
                                             ("bogus", 8, "unknown merge")])
def test_merge_dispatch_errors_match_jax(mode, size, match):
    for fn in (jsh.merge_dispatch_explained, tsh.merge_dispatch_explained):
        with pytest.raises(ValueError, match=match):
            fn(mode, size)


def test_plan_cache_round_trip():
    # the port has no probe artifact to cache: a plan is a value, solved
    # the same for the same shape
    _, tc = _pair(4)
    a = tsh.plan_sharded_search(tc, 16, 10, 10, merge_mode="ring")
    assert a == tsh.plan_sharded_search(tc, 16, 10, 10, merge_mode="ring")
    assert (a.merge_mode, a.merge_reason, a.ring_shift) == ("ring", "forced",
                                                            "plain")
    assert (a.size, a.nq, a.k, a.kk, a.k_out, a.mask_invalid) == (
        4, 16, 10, 10, 10, False)
    b = tsh.plan_sharded_search(tc, 16, 50, 10, mask_invalid=True)
    assert (b.k_out, b.merge_mode, b.merge_reason, b.mask_invalid) == (
        40, "tree", "merge_tree", True)


@pytest.mark.parametrize("name", ["build_cagra", "search_cagra",
                                  "build_ivf_pq_from_file"])
def test_deferred_parts_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(tsh, name)()
