"""raft_tpu_torch.serving against raft_tpu.serving, on the CPU.

The flush policy, stats and percentiles are held against the JAX
package's under one fake clock. The engine serves one IVF-Flat index that
raft_tpu builds and ``interop`` carries over (``device="cpu"``): its rows
are bitwise equal to ``solo_reference`` and to a direct batch search of
the same bucket, and within ``test_torch_ivf_flat.py``'s tolerance of the
JAX engine's rows on the same queries (distances atol 1e-4·max‖x‖², rtol
1e-5; ids equal away from near-ties). The other families' searchers
serve too; CAGRA's reuses a seed table per bucket and its rows are
bitwise those of a search that draws the seeds per call. Lifecycle:
deadline shedding, ``QueueFull``, drain and stop, ``BatchFailed``
containment, no kernel build after ``start()``, the fleet's names
exported, and the pieces not ported yet raise ``NotImplementedError``.
Every engine is stopped by its test; every future is read with a timeout.
"""

import threading
import time
from concurrent.futures import CancelledError, Future

import numpy as np
import pytest
import torch

from raft_tpu import serving as jserving
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.serving import batcher as jbatcher
from raft_tpu.serving import stats as jstats
from raft_tpu_torch import interop, serving
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import metrics as tmetrics
from raft_tpu_torch.serving import batcher as tbatcher
from raft_tpu_torch.serving import stats as tstats
from raft_tpu_torch.testing import assert_topk_close
from raft_tpu_torch.utils.shape import pad_rows, query_bucket

DIM, K, T = 16, 5, 60  # T: every future's result timeout, seconds


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ------------------------------------------------------------ shape helpers
def test_query_bucket_and_pad_rows_match_jax():
    from raft_tpu.utils import shape as jshape

    for n in (1, 7, 8, 9, 33, 64, 200, 256, 257, 1000):
        assert query_bucket(n) == jshape.query_bucket(n)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(pad_rows(x, 8, fill=-1),
                                  jshape.pad_rows(x, 8, fill=-1))
    t = pad_rows(torch.from_numpy(x), 8, fill=-1)
    np.testing.assert_array_equal(t.numpy(), jshape.pad_rows(x, 8, fill=-1))
    assert pad_rows(x, 3) is x


# ----------------------------------------------------------------- batcher
def _script(mod, max_batch, max_wait_us, events):
    """Run a fake-clock admission script through one package's Batcher:
    events are (t, op, arg); returns every select() decision as the
    requests' tags, plus the pruned (expired) tags."""
    clock = FakeClock()
    b = mod.Batcher(max_batch=max_batch, max_wait_us=max_wait_us,
                    queue_limit=6, clock=clock)
    out = []
    for t, op, arg in events:
        clock.t = t
        if op == "put":
            k, tag, deadline = arg
            r = mod.Request(np.zeros(DIM, np.float32), k, Future(), t,
                            None if deadline is None else t + deadline)
            r.trace_id = tag
            try:
                b.put(r, block=False)
                out.append(("put", tag))
            except mod.QueueFull:
                out.append(("full", tag))
        else:
            with b.locked():
                got = b.select(clock())
            out.append(("select", None if got is None
                        else [r.trace_id for r in got]))
            out.append(("expired", [r.trace_id for r in b.pop_expired()]))
    return out


_EVENTS = [
    (0.0, "put", (10, "a", None)), (0.0, "put", (5, "b", None)),
    (0.0001, "put", (10, "c", 0.0005)), (0.0002, "select", None),
    (0.0003, "put", (10, "d", None)), (0.0007, "select", None),
    (0.0011, "select", None), (0.0012, "put", (5, "e", None)),
    (0.0012, "put", (5, "f", None)), (0.0012, "put", (5, "g", None)),
    (0.0013, "put", (10, "h", None)), (0.0013, "put", (10, "i", None)),
    (0.0013, "put", (10, "j", None)), (0.0013, "put", (10, "k", None)),
    (0.0014, "select", None), (0.0030, "select", None),
    (0.0040, "select", None), (0.0050, "select", None),
]


@pytest.mark.parametrize("max_batch,max_wait_us", [(2, 1000), (3, 500),
                                                   (8, 2000)])
def test_flush_decisions_match_jax(max_batch, max_wait_us):
    assert _script(tbatcher, max_batch, max_wait_us, _EVENTS) == \
        _script(jbatcher, max_batch, max_wait_us, _EVENTS)


def test_stop_without_drain_returns_queued_and_refuses_new():
    b = tbatcher.Batcher(max_batch=4, clock=FakeClock())
    reqs = [tbatcher.Request(np.zeros(DIM, np.float32), K, Future(), 0.0)
            for _ in range(3)]
    for r in reqs:
        b.put(r)
    assert b.stop(drain=False) == reqs
    with pytest.raises(tbatcher.EngineStopped):
        b.put(reqs[0])
    assert b.take() is None


# ------------------------------------------------------------------- stats
def test_percentiles_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100, 1001):
        s = list(rng.exponential(5.0, n))
        pcts = (50.0, 95.0, 99.0, 99.9)
        got, want = tstats.percentiles(s, pcts), jstats.percentiles(s, pcts)
        assert got.keys() == want.keys()
        assert all((np.isnan(got[p]) and np.isnan(want[p]))
                   or got[p] == want[p] for p in got)


def test_serving_stats_snapshot_matches_jax():
    def run(stats_mod, m):
        st = stats_mod.ServingStats(registry=m.Registry(),
                                    engine_label="e0")
        st.record_submit(6)
        st.record_batch(4, 8, [0.1, 0.2, 0.4, 0.8], 0.5,
                        [1.3, 1.0, 0.6, 0.25])
        st.record_batch(2, 8, [0.001, 0.002], 0.004, [0.01, 0.02])
        st.record_shed_deadline()
        st.record_rejected("breaker")
        st.record_batch_failed(3, hang=True)
        st.record_shadow("sampled", 2)
        snap = st.snapshot()
        st.reset_samples()
        return snap, st.snapshot(), st.queue_wait_p99_s()

    assert run(tstats, tmetrics) == run(jstats, __import__(
        "raft_tpu.obs.metrics", fromlist=["Registry"]))


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def flat_pair():
    rng = np.random.default_rng(3)
    db = rng.standard_normal((3000, DIM)).astype(np.float32)
    j = jivf.build(db, jivf.IndexParams(n_lists=16))
    t = interop.ivf_flat_index_from_numpy(
        tivf.IndexParams(n_lists=16), np.asarray(j.centers),
        np.asarray(j.list_data), np.asarray(j.list_indices),
        np.asarray(j.list_sizes), j.n_rows, np.asarray(j.overflow_data),
        np.asarray(j.overflow_indices), device="cpu")
    return db, j, t


def _engine(searcher, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_us", 5000)
    kw.setdefault("warm_ks", (K,))
    return serving.Engine(searcher, serving.EngineConfig(**kw))


def _queries(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, DIM)).astype(np.float32)


def _serve_concurrently(eng, queries, n_threads=4):
    out, placements = [None] * len(queries), [None] * len(queries)

    def worker(t):
        for j in range(t, len(queries), n_threads):
            f = eng.submit(queries[j], K)
            out[j] = f.result(timeout=T)
            placements[j] = f.placement

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(T)
    assert not any(th.is_alive() for th in threads)
    return out, placements


def test_served_rows_bitwise_solo_and_close_to_jax_engine(flat_pair):
    db, j, t = flat_pair
    q = _queries(40, 1)
    params = dict(n_probes=8)
    ts = serving.ivf_flat_searcher(t, tivf.SearchParams(**params))
    with _engine(ts, max_wait_us=2000) as eng:
        got, placements = _serve_concurrently(eng, q)
        snap = eng.stats.snapshot()
    assert snap["n_completed"] == len(q)
    assert serving.verify_bit_identity(ts, list(q), got, K, placements) == 0
    js = jserving.ivf_flat_searcher(j, jivf.SearchParams(**params))
    with jserving.Engine(js, jserving.EngineConfig(
            max_batch=8, max_wait_us=2000, warm_ks=(K,))) as jeng:
        want = [f.result(timeout=T) for f in
                [jeng.submit(row, K) for row in q]]
    atol = 1e-4 * float((db ** 2).sum(1).max())
    assert_topk_close((np.stack([d for d, _ in got]),
                       np.stack([i for _, i in got])),
                      (np.stack([d for d, _ in want]),
                       np.stack([i for _, i in want])), atol, 1e-5,
                      "engine rows vs the JAX engine's")


def test_served_rows_bitwise_equal_direct_batch_search(flat_pair):
    _, _, t = flat_pair
    q = _queries(8, 2)
    ts = serving.ivf_flat_searcher(t, tivf.SearchParams(n_probes=8))
    with _engine(ts, max_wait_us=10_000_000) as eng:
        futs = [eng.submit(row, K) for row in q]
        rows = [f.result(timeout=T) for f in futs]
    assert {f.placement[1] for f in futs} == {8}  # one full bucket
    batch = np.zeros((8, DIM), np.float32)
    for f, row in zip(futs, q):
        batch[f.placement[0]] = row
    d, i = tivf.search(t, batch, K, tivf.SearchParams(n_probes=8))
    for f, (dr, ir) in zip(futs, rows):
        assert np.array_equal(dr, d[f.placement[0]].numpy())
        assert np.array_equal(ir, i[f.placement[0]].numpy())


@pytest.mark.parametrize("row_type", [np.uint8, np.float16])
def test_narrow_ivf_flat_serves_float32_queries_unchanged(row_type):
    """A narrow IVF-Flat index is served float32 batches, as raft_tpu's
    searcher sends them: a fractional query is neither truncated to the
    uint8 rows' type nor rounded to fp16, so the served rows are bitwise
    ``ivf_flat.search`` on the float32 queries of the same bucket."""
    rng = np.random.default_rng(12)
    rows = rng.uniform(0, 255, (1200, DIM))
    index = tivf.build(rows.astype(row_type), tivf.IndexParams(n_lists=8),
                       device="cpu")
    assert index.list_data.dtype == {np.uint8: torch.uint8,
                                     np.float16: torch.float16}[row_type]
    q = (rows[:8] + rng.uniform(-0.5, 0.5, (8, DIM))).astype(np.float32)
    ts = serving.ivf_flat_searcher(index, tivf.SearchParams(n_probes=3))
    assert ts.query_dtype == np.float32
    with _engine(ts, max_wait_us=10_000_000) as eng:
        futs = [eng.submit(row, K) for row in q]
        rows_out = [f.result(timeout=T) for f in futs]
    assert {f.placement[1] for f in futs} == {8}  # one full bucket
    batch = np.zeros((8, DIM), np.float32)
    for f, row in zip(futs, q):
        batch[f.placement[0]] = row
    d, i = tivf.search(index, batch, K, tivf.SearchParams(n_probes=3))
    for f, (dr, ir) in zip(futs, rows_out):
        assert np.array_equal(dr, d[f.placement[0]].numpy())
        assert np.array_equal(ir, i[f.placement[0]].numpy())
    assert serving.verify_bit_identity(
        ts, list(q), rows_out, K, [f.placement for f in futs]) == 0


def test_spans_carry_explain_briefs_and_builds_stay_zero(flat_pair):
    _, _, t = flat_pair
    from raft_tpu_torch import obs

    sink = obs.ListSink()
    ts = serving.ivf_flat_searcher(t, tivf.SearchParams(n_probes=8))
    with _engine(ts, span_sink=sink) as eng:
        assert eng.warmup_info["device"] == "cpu"
        assert eng.warmup_info["buckets"] == [8]
        c0 = serving.compile_count()
        for f in [eng.submit(row, K) for row in _queries(12, 3)]:
            f.result(timeout=T)
        assert serving.compile_count() - c0 == 0
        assert eng.warmup_info["compiles"] == 0
        bundle = eng.dump_diagnostics()
    batches = sink.by_kind("batch")
    assert batches and all(b["outcome"] == "ok" for b in batches)
    briefs = [e for b in batches for e in b["explain"]]
    assert {(e["family"], e["engine"], e["reason"], e["route"])
            for e in briefs} == {("ivf_flat", "pallas", "auto_fused",
                                  "plain")}
    assert all("host_return_ms" in b and "device_ms" in b
               and "device_event_ms" not in b for b in batches)
    reqs = sink.by_kind("request")
    assert len(reqs) == 12 and {r["outcome"] for r in reqs} == {"ok"}
    assert bundle["schema"] == "raft_tpu.diagnostics/v1" and bundle["spans"]


@pytest.mark.parametrize("family", ["brute_force", "ivf_pq", "cagra"])
def test_other_families_serve_bitwise_solo(family, flat_pair):
    db, _, _ = flat_pair
    if family == "brute_force":
        s = serving.brute_force_searcher(tbf.build(db, device="cpu"))
    elif family == "ivf_pq":
        index = tpq.build(db, tpq.IndexParams(n_lists=16, pq_dim=8,
                                              kmeans_n_iters=4),
                          device="cpu")
        s = serving.make_searcher("ivf_pq", index,
                                  params=tpq.SearchParams(n_probes=8))
    else:
        graph = np.random.default_rng(4).integers(
            0, db.shape[0], (db.shape[0], 8), np.int32)
        s = serving.cagra_searcher(interop.cagra_index_from_numpy(
            tcagra.IndexParams(graph_degree=8, intermediate_graph_degree=16),
            db, graph, device="cpu"), tcagra.SearchParams(itopk_size=16))
    q = _queries(20, 5)
    with _engine(s, max_batch=16) as eng:
        got, placements = _serve_concurrently(eng, q)
    assert serving.verify_bit_identity(s, list(q), got, K, placements) == 0


def test_brute_force_searcher_takes_the_jax_keywords(flat_pair):
    """``brute_force_searcher`` takes raft_tpu's keywords: ``select_recall``
    flows to the search (answered exactly, as raft_tpu's CPU path answers
    it), and ``scan_dtype`` with ``refine_ratio`` serve the bf16 fast scan:
    its rows are the search's, and raft_tpu's fast-scan searcher's within
    the fast-scan tests' bounds (ids at least 99% equal)."""
    from raft_tpu.neighbors import brute_force as jbf

    db, _, _ = flat_pair
    q = _queries(8, 6)
    index = tbf.build(db, device="cpu")
    s = serving.brute_force_searcher(index, select_recall=0.9,
                                     refine_ratio=2.0)
    got = s.search(s.to_device(q), K)
    want = tbf.search(index, q, K, select_recall=0.9)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    js = jserving.brute_force_searcher(jbf.build(db), select_recall=0.9,
                                       refine_ratio=2.0)
    jd, ji = js.search(q, K)
    assert_topk_close(got, (np.asarray(jd), np.asarray(ji)),
                      1e-4 * float((db ** 2).sum(1).max()), 1e-5)
    fast = serving.brute_force_searcher(index, scan_dtype="bfloat16",
                                        refine_ratio=2.0)
    got = fast.search(fast.to_device(q), K)
    want = tbf.search(index, q, K, scan_dtype="bfloat16", refine_ratio=2.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jfast = jserving.brute_force_searcher(jbf.build(db), scan_dtype="bfloat16",
                                          refine_ratio=2.0)
    jd, ji = jfast.search(q, K)
    same = got[1].numpy() == np.asarray(ji)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(jd)[same],
                               rtol=1e-5,
                               atol=1e-4 * float((db ** 2).sum(1).max()))
    with pytest.raises(ValueError, match="only bfloat16"):
        bad = serving.brute_force_searcher(index, scan_dtype="float16")
        bad.search(bad.to_device(q), K)


def test_cagra_seed_table_reused_and_bitwise_per_call_draw(flat_pair):
    db, _, _ = flat_pair
    graph = np.random.default_rng(6).integers(0, db.shape[0],
                                              (db.shape[0], 8), np.int32)
    index = interop.cagra_index_from_numpy(
        tcagra.IndexParams(graph_degree=8, intermediate_graph_degree=16),
        db, graph, device="cpu")
    sp = tcagra.SearchParams(itopk_size=16)
    s = serving.cagra_searcher(index, sp)
    draws = []
    real = tcagra.seed_table

    def counting(*a, **k):
        draws.append(a[1])
        return real(*a, **k)

    tcagra.seed_table = counting
    try:
        q = _queries(12, 7)
        with _engine(s, max_batch=16, max_wait_us=10_000_000) as eng:
            futs = [eng.submit(row, K) for row in q]
            rows = [f.result(timeout=T) for f in futs]
        assert sorted(draws) == [8, 16]  # once per bucket, when warming
        for f, row, (dr, ir) in zip(futs, q, rows):
            b = np.zeros((f.placement[1], DIM), np.float32)
            b[f.placement[0]] = row
            d, i = tcagra.search(index, b, K, sp)  # draws its seeds
            assert np.array_equal(dr, d[f.placement[0]].numpy())
            assert np.array_equal(ir, i[f.placement[0]].numpy())
    finally:
        tcagra.seed_table = real


# --------------------------------------------------------------- lifecycle
def test_deadline_shed_is_typed_and_counted(flat_pair):
    _, _, t = flat_pair
    ts = serving.ivf_flat_searcher(t)
    with _engine(ts, max_wait_us=10_000_000, max_batch=64) as eng:
        fut = eng.submit(_queries(1, 8)[0], K, deadline_ms=1.0)
        with pytest.raises(serving.DeadlineExceeded):
            fut.result(timeout=T)
        assert eng.stats.n_shed_deadline == 1


def test_queue_full_and_drain_and_stop(flat_pair):
    _, _, t = flat_pair
    ts = serving.ivf_flat_searcher(t)
    q = _queries(6, 9)
    eng = _engine(ts, max_wait_us=10_000_000, max_batch=64, queue_limit=4,
                  queue_high_watermark=100)
    eng.start()
    try:
        futs = [eng.submit(row, K) for row in q[:4]]
        with pytest.raises(serving.QueueFull):
            eng.submit(q[4], K, block=False)
        assert not any(f.done() for f in futs)
    finally:
        eng.stop(drain=True)
    for f in futs:
        d, i = f.result(timeout=T)
        assert d.shape == (K,)
    assert eng.drain(timeout=T)
    with pytest.raises(serving.EngineStopped):
        eng.submit(q[5], K)
    eng2 = _engine(ts, max_wait_us=10_000_000, max_batch=64)
    eng2.start()
    fut = eng2.submit(q[5], K)
    eng2.stop(drain=False)
    with pytest.raises(CancelledError):  # queued: cancelled, never launched
        fut.result(timeout=T)
    assert eng2.health()["status"] == "unhealthy"


def test_batch_failure_is_contained(flat_pair):
    _, _, t = flat_pair
    good = serving.ivf_flat_searcher(t)
    fail = {"on": False}

    def search(queries, k):
        if fail["on"]:
            raise RuntimeError("device fell over")
        return good.search(queries, k)

    s = serving.Searcher("ivf_flat", DIM, t, search)
    q = _queries(3, 10)
    with _engine(s, max_wait_us=1000) as eng:
        fail["on"] = True
        fut = eng.submit(q[0], K)
        with pytest.raises(serving.BatchFailed) as err:
            fut.result(timeout=T)
        assert isinstance(err.value.cause, RuntimeError)
        fail["on"] = False
        d, i = eng.submit(q[1], K).result(timeout=T)
        assert d.shape == (K,)
        assert eng.stats.n_batch_errors == 1
        assert eng.health()["status"] == "ok"


def test_metrics_scrape_serves_the_serving_families(flat_pair):
    import urllib.request

    _, _, t = flat_pair
    with _engine(serving.ivf_flat_searcher(t)) as eng:
        eng.submit(_queries(1, 11)[0], K).result(timeout=T)
        port = eng.serve_metrics(0).port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=T) as r:
            text = r.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=T) as r:
            assert r.status == 200
    for family in ("raft_tpu_serving_requests_total",
                   "raft_tpu_serving_batches_total",
                   "raft_tpu_serving_total_seconds",
                   "raft_tpu_serving_queue_depth",
                   "raft_tpu_dispatch_total"):
        assert family in text


def test_unported_pieces_raise(flat_pair, tmp_path):
    """What is still unported, and what no longer is. The fleet (ROADMAP
    Queue A item 12: router, fleet, remote replicas, autoscaler) is ported:
    the port exports the five names raft_tpu does. Still raft_tpu's alone:
    sharded CAGRA (item 13) and the dense metrics beyond L2, cosine and
    inner product (item 14), which raise ``NotImplementedError``. The
    planner (item 10) is ported: an ``EngineConfig.planner`` no longer
    raises (``tests/test_torch_planner.py`` serves one). The write path and
    the tiers (item 11) are ported: ``Engine.writer()`` of a read-only
    searcher is raft_tpu's ``TypeError`` word for word, and the mutable and
    tiered searchers build and search."""
    db, j, t = flat_pair
    s = serving.ivf_flat_searcher(t)
    for name in ("Router", "Fleet", "Autoscaler", "RemoteReplica",
                 "RetryPolicy"):
        assert hasattr(jserving, name) and hasattr(serving, name), name
        assert name in serving.__all__
    from raft_tpu_torch.ops import distance as tdistance
    from raft_tpu_torch.parallel import comms as tcomms
    from raft_tpu_torch.parallel import sharded as tsharded
    for name in ("build_cagra", "search_cagra"):
        with pytest.raises(NotImplementedError, match="item 13"):
            getattr(tsharded, name)(tcomms.init_comms(["cpu"]), db)
    with pytest.raises(NotImplementedError, match="item 14"):
        tdistance.pairwise_core(torch.from_numpy(db[:4]),
                                torch.from_numpy(db[:4]),
                                tdistance.DistanceType.L1)
    eng = serving.Engine(s, serving.EngineConfig(planner=object()))
    assert eng.planner is not None and s.search_with is not None
    with pytest.raises(TypeError) as got:
        serving.Engine(s).writer()
    with pytest.raises(TypeError) as want:
        jserving.Engine(jserving.ivf_flat_searcher(j)).writer()
    assert str(got.value) == str(want.value)
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import mutable, tiered
    from raft_tpu_torch.obs import metrics as om
    cpu = Resources(device="cpu", seed=0)
    q = _queries(3, 5)
    w = mutable.MutableIvf(str(tmp_path / "m"), base=t, res=cpu,
                           registry=om.Registry(), group_window_s=0.0)
    m = serving.mutable_ivf_searcher(w)
    assert (m.family, m.dim, m.device) == ("mutable_ivf", DIM,
                                           torch.device("cpu"))
    assert _bitwise(m.search(m.to_device(q), K),
                    tivf.search(t, q, K, tivf.SearchParams()))
    w.close()
    pq = tpq.build(db, tpq.IndexParams(n_lists=16, pq_dim=8), res=cpu)
    ti = serving.tiered_ivf_pq_searcher(
        tiered.TieredIvfPq.from_index(pq, res=cpu), res=cpu)
    assert _bitwise(ti.search(ti.to_device(q), K),
                    tpq.search(pq, q, K, res=cpu, memory_mode="cache"))
    for name in ("tiered_ivf_pq_searcher", "mutable_ivf_searcher"):
        with pytest.raises(TypeError, match="wants"):
            getattr(serving, name)(t)
    with pytest.raises(ValueError, match="unknown family"):
        serving.make_searcher("hnsw", t)


def _bitwise(a, b) -> bool:
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def test_searcher_places_on_the_index_device(flat_pair):
    _, _, t = flat_pair
    s = serving.ivf_flat_searcher(t)
    assert s.device == torch.device("cpu")
    assert s.place() == sum(isinstance(v, torch.Tensor)
                            for v in vars(t).values())
    staged = s.to_device(np.zeros((8, DIM), np.float32))
    assert staged.device == torch.device("cpu") and staged.shape == (8, DIM)


def test_submit_rejects_wrong_shape_and_stopped(flat_pair):
    _, _, t = flat_pair
    eng = _engine(serving.ivf_flat_searcher(t))
    with pytest.raises(serving.EngineStopped):
        eng.submit(np.zeros(DIM, np.float32), K)
    with eng:
        with pytest.raises(ValueError, match="query shape"):
            eng.submit(np.zeros(DIM + 1, np.float32), K)
        t0 = time.perf_counter()
        d, i = eng.search(_queries(1, 12)[0], K, deadline_ms=30_000)
        assert d.shape == (K,) and time.perf_counter() - t0 < T
