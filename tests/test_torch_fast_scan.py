"""The bf16 fast scan of raft_tpu_torch against raft_tpu's, on the CPU.

Each family searches the same index in both packages with
``scan_dtype="bfloat16"``: the port's result holds raft_tpu's at a recall
of at least 0.99 (the screens round their inputs alike but sum in another
order, so a candidate at the screen's edge may go either way), and where
the ids agree the distances are within rtol 1e-5 and atol 1e-4·max‖x‖²
(both are the exact fp32 re-rank's, summed in another order), as
``tests/test_brute_force.py`` holds raft_tpu's fast scan to its exact
search. Brute force with the four metrics, filtered and tiled under a
small workspace; IVF-Flat (with an overflow block); CAGRA; the served
brute-force searcher. The fast scan must also keep off the fused kernels
and IVF-Flat's scan kernel, as raft_tpu's dispatch does.
"""

import numpy as np
import pytest
import torch

from raft_tpu import serving as jserving
from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jc
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu_torch import interop, serving
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tc
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.stats import neighborhood_recall

METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine"]


@pytest.fixture(scope="module")
def data():
    rows = low_rank_clusters(np.random.default_rng(41), 3100, 48)
    return rows[:3000], rows[3000:]


def _atol(metric, db, q):
    scale = float(max((db ** 2).sum(1).max(), (q ** 2).sum(1).max()))
    return 1e-4 * {"sqeuclidean": scale, "euclidean": np.sqrt(scale),
                   "inner_product": scale, "cosine": 1.0}[metric]


def _hold(got, want, atol):
    """Recall of ``got`` against ``want`` >= 0.99; distances within rtol
    1e-5 + atol where the ids agree."""
    gv, gi = (np.asarray(t) for t in got)
    wv, wi = (np.asarray(t) for t in want)
    assert float(neighborhood_recall(gi, wi)) >= 0.99
    same = gi == wi
    assert same.mean() >= 0.95
    np.testing.assert_allclose(gv[same], wv[same], rtol=1e-5, atol=atol)


def _reason(metric):
    """The explain reason of a fast scan: the first clause that keeps it off
    the fused kernel (the metric's before the fast scan's)."""
    return "fast_scan" if metric in ("sqeuclidean", "euclidean") \
        else "non_l2"


# ------------------------------------------------------------- brute force


@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_fast_scan_matches_jax(data, metric):
    db, q = data
    want = jbf.search(jbf.build(db, metric=metric), q, 10,
                      scan_dtype="bfloat16")
    index = tbf.build(db, metric=metric, device="cpu")
    *got, rec = tbf.search(index, q, 10, scan_dtype="bfloat16", explain=True)
    assert rec.engine == "xla" and rec.reason == _reason(metric)
    _hold(got, want, _atol(metric, db, q))
    # and the fast scan against the exact search, as raft_tpu's own test
    exact = tbf.search(index, q, 10)
    _hold(got, exact, _atol(metric, db, q))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("refine_ratio", [1.0, 4.0])
def test_brute_force_fast_scan_filtered_and_tiled_matches_jax(
        data, metric, refine_ratio):
    db, q = data
    mask = np.random.default_rng(42).random(len(db)) < 0.6
    # a small workspace: several database tiles through the merge
    jres = JResources(workspace_limit_bytes=2 << 20)
    want = jbf.search(jbf.build(db, metric=metric, res=jres), q, 8,
                      filter=JBitset.from_mask(mask), res=jres,
                      scan_dtype="bfloat16", refine_ratio=refine_ratio)
    res = Resources(device="cpu", workspace_limit_bytes=2 << 20)
    index = tbf.build(db, metric=metric, res=res)
    *got, rec = tbf.search(
        index, q, 8, filter=Bitset.from_mask(torch.from_numpy(mask)),
        res=res, scan_dtype="bfloat16", refine_ratio=refine_ratio,
        explain=True)
    assert rec.plan["db_tile"] < len(db)
    assert mask[got[1].numpy()].all()
    _hold(got, want, _atol(metric, db, q))


def test_knn_takes_refine_ratio(data):
    db, q = data
    got = tbf.knn(q, db, 10, metric="sqeuclidean", scan_dtype="bfloat16",
                  refine_ratio=2.0, device="cpu")
    want = jbf.knn(q, db, 10, metric="sqeuclidean", scan_dtype="bfloat16",
                   refine_ratio=2.0)
    _hold(got, want, _atol("sqeuclidean", db, q))


# --------------------------------------------------------------- IVF-Flat


@pytest.fixture(scope="module")
def flat_pair(data):
    """raft_tpu's build with an overflow block, in both packages."""
    db, _ = data
    j = jivf.build(db, jivf.IndexParams(n_lists=12, list_pad_expansion=1.05),
                   res=JResources(seed=0))
    return j


def _carry(j, metric):
    jparams = jivf.IndexParams(n_lists=j.n_lists, metric=metric,
                               list_pad_expansion=j.params.list_pad_expansion)
    jj = jivf.Index(jparams, j.centers, j.list_data, j.list_indices,
                    j.list_sizes, j.n_rows, j.overflow_data,
                    j.overflow_indices)
    t = interop.ivf_flat_index_from_numpy(
        tivf.IndexParams(n_lists=j.n_lists, metric=metric),
        *(np.asarray(a) for a in (j.centers, j.list_data, j.list_indices,
                                  j.list_sizes)), j.n_rows,
        np.asarray(j.overflow_data), np.asarray(j.overflow_indices),
        device="cpu")
    return jj, t


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_flat_fast_scan_matches_jax(data, flat_pair, metric,
                                       monkeypatch):
    db, q = data
    j, t = _carry(flat_pair, metric)
    assert t.overflow_data.shape[0] > 0
    want = jivf.search(j, q, 10, jivf.SearchParams(
        n_probes=4, scan_dtype="bfloat16", refine_ratio=2.0))
    calls = []
    real = gk.ivf_scan
    monkeypatch.setattr(gk, "ivf_scan",
                        lambda *a: calls.append(1) or real(*a))
    *got, rec = tivf.search(t, q, 10, tivf.SearchParams(
        n_probes=4, scan_dtype="bfloat16", refine_ratio=2.0), explain=True)
    assert rec.reason == _reason(metric) and not rec.plan["unfused_ivf_scan"]
    assert not calls  # kept off the scan kernel, as raft_tpu keeps it
    _hold(got, want, _atol(metric, db, q))


def test_ivf_flat_fast_scan_filtered_matches_jax(data, flat_pair):
    db, q = data
    j, t = _carry(flat_pair, "sqeuclidean")
    mask = np.random.default_rng(43).random(len(db)) < 0.5
    want = jivf.search(j, q, 10, jivf.SearchParams(
        n_probes=5, scan_dtype="bfloat16"), filter=JBitset.from_mask(mask))
    got = tivf.search(t, q, 10, tivf.SearchParams(
        n_probes=5, scan_dtype="bfloat16"),
        filter=Bitset.from_mask(torch.from_numpy(mask)))
    ids = got[1].numpy()
    assert mask[ids[ids >= 0]].all()
    _hold(got, want, _atol("sqeuclidean", db, q))


# ------------------------------------------------------------------ CAGRA


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_cagra_fast_scan_matches_jax(data, metric):
    db, q = data
    graph = np.random.default_rng(44).integers(0, len(db), (len(db), 16),
                                               dtype=np.int32)
    jparams = jc.IndexParams(graph_degree=16, intermediate_graph_degree=32,
                             metric=metric)
    j = jc.Index(jparams, db, graph)
    t = interop.cagra_index_from_numpy(
        tc.IndexParams(graph_degree=16, intermediate_graph_degree=32,
                       metric=metric), db, graph, device="cpu")
    want = jc.search(j, q, 10, jc.SearchParams(itopk_size=64,
                                               scan_dtype="bfloat16"))
    sp = tc.SearchParams(itopk_size=64, scan_dtype="bfloat16")
    plan = tc.plan_search(t, 10, sp)
    assert plan.engine == "xla" and plan.reason == _reason(metric)
    got = tc.search(t, q, 10, sp)
    assert t.ensure_scan_dataset().dtype == torch.bfloat16
    assert t.ensure_scan_dataset() is t.ensure_scan_dataset()  # cached
    _hold(got, want, _atol(metric, db, q))


# ---------------------------------------------------------------- serving


def test_served_brute_force_fast_scan_matches_jax(data):
    db, q = data
    q = q[:24]
    index = tbf.build(db, device="cpu")
    s = serving.brute_force_searcher(index, scan_dtype="bfloat16")
    js = jserving.brute_force_searcher(jbf.build(db), scan_dtype="bfloat16")
    got = s.search(s.to_device(q), 10)
    jd, ji = js.search(q, 10)
    _hold(got, (np.asarray(jd), np.asarray(ji)),
          _atol("euclidean", db, q))
    cfg = serving.EngineConfig(max_batch=8, max_wait_us=500, warm_ks=(10,),
                               warm_buckets=(8,))
    eng = serving.Engine(s, cfg).start()
    try:
        futs = [eng.submit(row, 10) for row in q]
        rows = [f.result(timeout=60) for f in futs]
    finally:
        eng.stop()
    served = (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))
    _hold(served, (np.asarray(jd), np.asarray(ji)),
          _atol("euclidean", db, q))
