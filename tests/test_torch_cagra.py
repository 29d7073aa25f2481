"""raft_tpu_torch's CAGRA path against raft_tpu's, on the CPU.

- ``optimize`` is deterministic: on one JAX NN-descent kNN graph the detour
  counts (also against the naive definition), the pruned graph, the
  reverse graph and the final graph are bitwise equal to raft_tpu's.
- Builds draw different random numbers, so each ``BuildAlgo`` is held by
  search recall@10: at least the JAX build's minus 0.02.
- Search is held on identical state: a JAX build carried over by
  ``interop.cagra_index_from_numpy``. The glue engine (``search_core``)
  against raft_tpu's ``search_core`` at the same seed table and plan; the
  kernel's plain version against raft_tpu's ``fused_cagra_topk`` in
  interpret mode and against the float64 numpy beam walk of
  tests/test_pallas_fused.py (ids equal); ``search`` end to end against
  raft_tpu's ``search``.

Tolerances: distances rtol 1e-5 and atol 1e-4·max‖x‖² (fp32 sums in
another order; the square root of that for L2Sqrt); ids equal away from
near-ties, near-ties as sets (``assert_topk_close``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import cagra as jc
from raft_tpu.neighbors import nn_descent as jnd
from raft_tpu.ops import pallas_kernels as pk
from raft_tpu.ops.distance import DistanceType as JDistanceType
from raft_tpu_torch import interop
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import cagra as tc
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.stats import neighborhood_recall
from raft_tpu_torch.testing import assert_topk_close

CPU = Resources(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    db = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((100, 32)).astype(np.float32)
    return db, q


@pytest.fixture(scope="module")
def scale(data):
    return float((data[0] ** 2).sum(1).max())


@pytest.fixture(scope="module")
def gt(data):
    db, q = data
    d = (q ** 2).sum(1)[:, None] + (db ** 2).sum(1)[None] - 2.0 * q @ db.T
    return torch.from_numpy(np.argsort(d, axis=1, kind="stable")[:, :10])


_BUILD = dict(intermediate_graph_degree=48, graph_degree=24,
              nn_descent_niter=12)
_SEARCH = dict(itopk_size=64, search_width=2)


@pytest.fixture(scope="module")
def knn_graph(data):
    """The kNN graph raft_tpu's ``cagra.build`` makes with ``_BUILD`` and
    ``Resources(seed=0)``: NN-descent at graph_degree 48, internal 72."""
    nd = jnd.build(data[0], jnd.IndexParams(
        graph_degree=48, intermediate_graph_degree=72, max_iterations=12),
        res=JResources(seed=0))
    return np.array(nd.graph)


@pytest.fixture(scope="module")
def jbuilt(data, knn_graph):
    # == jc.build(db, jc.IndexParams(**_BUILD), res=JResources(seed=0)),
    # without a second NN-descent run
    return jc.Index(jc.IndexParams(**_BUILD), jnp.asarray(data[0]),
                    jc.optimize(jnp.asarray(knn_graph), 24))


@pytest.fixture(scope="module")
def carried(jbuilt, data):
    return interop.cagra_index_from_numpy(tc.IndexParams(**_BUILD), data[0],
                                          np.asarray(jbuilt.graph),
                                          device="cpu")


# ------------------------------------------------------------------ optimize


def _naive_detour_counts(g, rows):
    """The detour-count definition, for the given rows of g (the oracle of
    tests/test_cagra.py)."""
    k = g.shape[1]
    out = np.zeros((len(rows), k), np.int32)
    for r, i in enumerate(rows):
        for a in range(k):
            if g[i, a] < 0:
                continue
            for b in range(a):
                if g[i, b] >= 0 and g[i, a] in g[g[i, b]]:
                    out[r, a] += 1
    return out


def test_optimize_bitwise_equal_to_jax(knn_graph):
    g = knn_graph.copy()
    g[5, 30:] = -1  # invalid edges: padded tails
    g[17, 3] = -1
    jg = jnp.asarray(g)
    tg = _t(g)
    counts = tc._detour_counts(tg, 256)
    want_counts = np.asarray(jc._detour_counts_jit(jg, 64))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    rows = [0, 5, 17, 1234, 2999]
    np.testing.assert_array_equal(counts.numpy()[rows],
                                  _naive_detour_counts(g, rows))
    pruned = tc._prune(tg, counts, 24)
    want_pruned = jc._prune_jit(jg, jnp.asarray(want_counts), 24)
    np.testing.assert_array_equal(pruned.numpy(), np.asarray(want_pruned))
    rev = tc._reverse_graph(pruned, 24)
    want_rev = jc._reverse_graph_jit(want_pruned, 24)
    np.testing.assert_array_equal(rev.numpy(), np.asarray(want_rev))
    final = tc.optimize(tg, 24, res=CPU)
    np.testing.assert_array_equal(final.numpy(),
                                  np.asarray(jc.optimize(jg, 24)))
    assert final.dtype == torch.int32


def test_detour_counts_match_naive_with_duplicate_ids():
    rng = np.random.default_rng(11)
    g = rng.integers(0, 50, (50, 10)).astype(np.int32)
    g[3, 6:] = -1
    got = tc._detour_counts(_t(g), 8)
    np.testing.assert_array_equal(got.numpy(),
                                  _naive_detour_counts(g, range(50)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc._detour_counts_jit(jnp.asarray(g), 8)))


def test_optimize_keeps_a_narrow_graph(knn_graph):
    g = _t(knn_graph[:, :24])
    assert torch.equal(tc.optimize(g, 24, res=CPU), g)


# --------------------------------------------------------------------- build


def _recall(index_search, gt):
    return float(neighborhood_recall(index_search[1], gt))


def test_nn_descent_build_recall_within_002_of_jax(data, gt, jbuilt):
    db, q = data
    index = tc.build(db, tc.IndexParams(**_BUILD),
                     res=Resources(device="cpu", seed=0))
    g = index.graph
    assert g.shape == (3000, 24) and g.dtype == torch.int32
    assert bool((g >= 0).all()) and bool((g < 3000).all())
    assert not bool((g == torch.arange(3000)[:, None]).any())
    assert set(index.build_seconds) == {"knn_graph", "optimize"}
    got = _recall(tc.search(index, q, 10, tc.SearchParams(**_SEARCH)), gt)
    want = _recall(jc.search(jbuilt, q, 10, jc.SearchParams(**_SEARCH)), gt)
    assert got >= want - 0.02, (got, want)
    assert got >= 0.9


@pytest.mark.filterwarnings("ignore")
def test_ivf_pq_build_recall_within_002_of_jax(data, gt):
    db, q = data
    params = dict(intermediate_graph_degree=32, graph_degree=16)
    index = tc.build(db, tc.IndexParams(**params,
                                        build_algo=tc.BuildAlgo.IVF_PQ),
                     res=Resources(device="cpu", seed=0))
    assert index.graph.shape == (3000, 16)
    assert not bool((index.graph == torch.arange(3000)[:, None]).any())
    jindex = jc.build(db, jc.IndexParams(**params,
                                         build_algo=jc.BuildAlgo.IVF_PQ),
                      res=JResources(seed=0))
    got = _recall(tc.search(index, q, 10, tc.SearchParams(**_SEARCH)), gt)
    want = _recall(jc.search(jindex, q, 10, jc.SearchParams(**_SEARCH)), gt)
    assert got >= want - 0.02, (got, want)


def test_drop_self_matches_jax():
    r = np.array([[5, 3, 7, 9], [1, 2, 3, 4], [6, 6, 8, 1]], np.int32)
    want = jc._drop_self_jit(jnp.asarray(r), 5, 3)
    np.testing.assert_array_equal(tc._drop_self(_t(r), 5, 3).numpy(),
                                  np.asarray(want))


# ------------------------------------------------------------ search engines


def _seeds(params, nq, size):
    _, _, _, n_seeds = tc.resolve_search_plan(params, 10, size)
    return tc.seed_table(params, nq, size, n_seeds, "cpu")


@pytest.mark.parametrize("metric,filtered", [
    ("L2Expanded", False), ("L2SqrtExpanded", False),
    ("InnerProduct", False), ("L2Expanded", True)])
def test_search_core_matches_jax(data, jbuilt, scale, metric, filtered):
    db, q = data
    params = tc.SearchParams(**_SEARCH)
    itopk, width, max_iter, _ = tc.resolve_search_plan(params, 10, len(db))
    seeds = _seeds(params, len(q), len(db))
    jwords, twords = jnp.zeros((0,), jnp.uint32), None
    if filtered:
        mask = np.random.default_rng(2).random(len(db)) < 0.7
        jwords = JBitset.from_mask(mask).words
        twords = Bitset.from_mask(torch.from_numpy(mask)).words
    graph = np.asarray(jbuilt.graph)
    want = jc.search_core(q, db, db, jnp.asarray(graph),
                          jnp.asarray(seeds.numpy()), jwords,
                          JDistanceType[metric], 10, itopk, width, max_iter,
                          filtered, False)
    got = tc.search_core(_t(q), _t(db), _t(graph), seeds, twords,
                         tc.DistanceType[metric], 10, itopk, width, max_iter,
                         q_tile=37)
    atol = 1e-4 * (np.sqrt(scale) if metric == "L2SqrtExpanded" else scale)
    assert_topk_close(got, want, atol, 1e-5)
    if filtered:
        assert bool(torch.from_numpy(mask)[got[1].long()].all())


# (seed, n, dim, degree, nq, k, itopk, width, n_seeds, ct) — the JAX fused
# kernel test's combos (tests/test_pallas_fused.py _CAGRA_COMBOS)
_CAGRA_COMBOS = [
    (0, 500, 24, 8, 4, 5, 16, 1, 20, 16),
    (2, 300, 24, 6, 3, 4, 16, 2, 20, 16),
    (1, 600, 32, 16, 2, 8, 64, 4, 64, 32),
]


def _cagra_case(seed, n, dim, degree, nq, n_seeds):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((nq, dim)).astype(np.float32)
    graph = rng.integers(0, n, (n, degree)).astype(np.int32)
    graph[5, :3] = -1  # invalid edges must be skipped, not scored
    seeds = rng.integers(0, n, (nq, n_seeds)).astype(np.int32)
    seeds[:, 1] = seeds[:, 0]  # duplicate seed ids dedup to one entry
    return data, q, graph, seeds


def _np_beam_walk(q, db, graph, seeds, k, itopk, width, max_iter):
    """The greedy beam walk of one query in float64 numpy (the reference of
    tests/test_pallas_fused.py): first-occurrence seed/target dedup,
    ``width`` cheapest unexpanded parents per hop, stable merges."""
    def d2(ids):
        diff = db[ids].astype(np.float64) - q.astype(np.float64)
        return (diff * diff).sum(-1)

    seen = []
    for s in seeds:
        s = int(s)
        if s >= 0 and s not in seen:
            seen.append(s)
    buf_ids = np.array(seen, np.int64)
    buf_d = d2(buf_ids)
    order = np.argsort(buf_d, kind="stable")[:itopk]
    buf_ids, buf_d = buf_ids[order], buf_d[order]
    flags = np.zeros(len(buf_ids), bool)
    for _ in range(max_iter):
        unexp = np.nonzero(~flags)[0]
        if unexp.size == 0:
            break
        parents = unexp[:width]
        flags[parents] = True
        targets = []
        for p in parents:
            for t in graph[buf_ids[p]]:
                t = int(t)
                if t >= 0 and t not in targets and t not in buf_ids:
                    targets.append(t)
        if not targets:
            continue
        t_ids = np.array(targets, np.int64)
        all_ids = np.concatenate([buf_ids, t_ids])
        all_d = np.concatenate([buf_d, d2(t_ids)])
        all_f = np.concatenate([flags, np.zeros(len(t_ids), bool)])
        order = np.argsort(all_d, kind="stable")[:itopk]
        buf_ids, buf_d, flags = all_ids[order], all_d[order], all_f[order]
    out_d = np.full(k, np.inf)
    out_i = np.full(k, -1, np.int64)
    m = min(k, len(buf_ids))
    out_d[:m], out_i[:m] = buf_d[:m], buf_ids[:m]
    return out_d, out_i


def _plain(data, q, graph, seeds, k, itopk, width, max_iter, **kw):
    qt = _t(q)
    return gk.fused_cagra_topk(qt, _t(data), _t(graph), _t(seeds),
                               gk.beam_norms(qt), k, itopk, width, max_iter,
                               **kw)


@pytest.mark.parametrize(
    "seed,n,dim,degree,nq,k,itopk,width,n_seeds,ct", _CAGRA_COMBOS)
def test_fused_cagra_plain_matches_numpy_walk_and_jax_kernel(
        seed, n, dim, degree, nq, k, itopk, width, n_seeds, ct):
    data, q, graph, seeds = _cagra_case(seed, n, dim, degree, nq, n_seeds)
    before = gk.LAUNCHES["fused_cagra_topk"]
    got = _plain(data, q, graph, seeds, k, itopk, width, 12)
    assert gk.LAUNCHES["fused_cagra_topk"] == before  # the CPU runs no kernel
    for r in range(nq):
        rd, ri = _np_beam_walk(q[r], data, graph, seeds[r], k, itopk, width,
                               12)
        np.testing.assert_array_equal(got[1][r].numpy(), ri)
        finite = np.isfinite(rd)
        np.testing.assert_allclose(got[0][r].numpy()[finite], rd[finite],
                                   rtol=1e-5, atol=1e-5)
        assert np.all(got[0][r].numpy()[~finite] == np.inf)
    want = pk.fused_cagra_topk(q, data, graph, seeds, k, itopk, width,
                               max_iter=12, ct=ct, interpret=True)
    assert_topk_close(got, want, 1e-4 * float((data ** 2).sum(1).max()),
                      1e-5)


def test_fused_cagra_plain_duplicate_seeds_across_chunks():
    # the first copy of a seed wins wherever its later copies sit, and
    # ids outside [0, n) or -1 never enter
    data, q, graph, seeds = _cagra_case(4, 400, 16, 8, 3, 200)
    seeds[:, 150:190] = seeds[:, 0:40]
    seeds[:, 199] = -1
    seeds[0, 198] = 400
    got = _plain(data, q, graph, seeds, 10, 32, 2, 20)
    seeds[0, 198] = -1
    for r in range(3):
        _, ri = _np_beam_walk(q[r], data, graph, seeds[r], 10, 32, 2, 20)
        np.testing.assert_array_equal(got[1][r].numpy(), ri)


def test_fused_cagra_plain_reports_hops_and_rows():
    data, q, graph, seeds = _cagra_case(5, 300, 16, 8, 4, 40)
    qt = _t(q)
    v, i, stats = gk.fused_cagra_topk_plain(
        qt, _t(data), _t(graph), _t(seeds), gk.beam_norms(qt), 5, 16, 1,
        gk.resolve_max_iter(16, 1, 0), return_stats=True)
    hops, rows = stats["hops"], stats["rows_scored"]
    assert hops.shape == rows.shape == (4,)
    # auto max_iter = itopk // width + 10, at least 16
    assert bool((hops >= 1).all()) and bool((hops <= 26).all())
    # the seeds (39 distinct) plus at most `degree` rows a hop
    assert bool((rows >= 39).all()) and bool((rows <= 39 + 8 * hops).all())
    # distinct rows over all queries: at least one query's, at most all
    # visits and all 300 rows; at most one expanded node a hop (width 1)
    assert int(rows.max()) <= stats["rows_touched"] <= min(int(rows.sum()),
                                                             300)
    assert int(hops.max()) <= stats["nodes_expanded"] <= int(hops.sum())
    assert torch.equal(i, _plain(data, q, graph, seeds, 5, 16, 1, 0)[1])


def test_lane_order_sum_is_a_sum():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (5, 300)).astype(np.float32))
    torch.testing.assert_close(gk.lane_order_sum(x), x.sum(-1), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------- end to end


def test_search_matches_jax_end_to_end(data, jbuilt, carried, gt, scale):
    db, q = data
    params = tc.SearchParams(**_SEARCH)
    assert tc.plan_search(carried, 10, params).engine == "pallas"
    got = tc.search(carried, q, 10, params)
    want = jc.search(jbuilt, q, 10, jc.SearchParams(**_SEARCH))
    assert_topk_close(got, want, 1e-4 * scale, 1e-5)
    assert _recall(got, gt) == _recall(want, gt)


def test_search_engines_agree_and_single_query(carried, data, scale):
    db, q = data
    params = tc.SearchParams(**_SEARCH)
    kernel = tc.search(carried, q, 10, params)
    glue = tc.search(carried, q, 10, tc.SearchParams(**_SEARCH,
                                                     scan_mode="xla"))
    assert_topk_close(kernel, glue, 1e-4 * scale, 1e-5)
    one = tc.search(carried, q[3], 10, params)
    assert torch.equal(one[1][0], kernel[1][3])


def test_plan_search_reasons(carried, data):
    db, _ = data
    ip = interop.cagra_index_from_numpy(
        tc.IndexParams(graph_degree=24, metric="inner_product"), db,
        carried.graph.numpy(), "cpu")

    def reason(index, **kw):
        return tc.plan_search(index, 10, tc.SearchParams(**kw)).reason

    assert reason(carried) is None
    assert reason(ip) == "non_l2"
    assert reason(carried, itopk_size=2048) == "k_gt_1024"
    assert reason(carried, scan_mode="xla") == "scan_mode_xla"
    assert tc.plan_search(carried, 10, has_filter=True).reason == "filtered"
    plan = tc.plan_search(carried, 10, tc.SearchParams(itopk_size=16)).plan
    assert plan == {"itopk": 16, "search_width": 1, "max_iter": 26,
                    "n_seeds": 32}
    assert tc.resolve_search_plan(tc.SearchParams(), 100, 3000) == \
        jc.resolve_search_plan(jc.SearchParams(), 100, 3000)


def test_deferred_parts_raise(carried, jbuilt, data):
    """What still raises: a fast scan of another type than bfloat16 (as in
    raft_tpu; the bf16 fast scan itself is held to raft_tpu's in
    tests/test_torch_fast_scan.py), an unknown scan mode, another metric."""
    _, q = data
    with pytest.raises(ValueError, match="only bfloat16"):
        tc.search(carried, q, 10, tc.SearchParams(scan_dtype="float16"))
    with pytest.raises(ValueError, match="only bfloat16"):
        jc.search(jbuilt, q, 10, jc.SearchParams(scan_dtype="float16"))
    with pytest.raises(ValueError, match="scan_mode"):
        tc.search(carried, q, 10, tc.SearchParams(scan_mode="fast"))
    with pytest.raises(ValueError, match="supports"):
        tc.IndexParams(metric="cosine")
