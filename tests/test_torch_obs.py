"""raft_tpu_torch.obs against raft_tpu.obs, on the CPU.

The port keeps its own copy of every obs module; these tests run the same
scripted operations through both packages and require the same results:
exposition text (family names letter for letter), burn rates under one
fake clock, recall estimates, diagnostics bundle keys, and the explain
records of the four families' searches on identical index state (the JAX
package builds or holds the index; ``interop`` carries it over). Under a
forced unfused ``scan_mode`` the records match in family, requested,
engine, reason and params; under ``auto`` the family, requested and params
match and the engine and reason are the port's (``plan_search``: the
fused kernel, reason ``auto_fused``). Also: the kernel-build counter and
profiler session of ``obs.device``, the metrics server, and the sharded
span sink (results bitwise equal with and without it).
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs import diagnostics as jdiag
from raft_tpu.obs import explain as jexplain
from raft_tpu.obs import metrics as jmetrics
from raft_tpu.obs import quality as jquality
from raft_tpu.obs import slo as jslo
from raft_tpu.serving.stats import ServingStats as JStats
from raft_tpu_torch import interop
from raft_tpu_torch import obs
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import device as tdevice
from raft_tpu_torch.obs import diagnostics as tdiag
from raft_tpu_torch.obs import explain as texplain
from raft_tpu_torch.obs import metrics as tmetrics
from raft_tpu_torch.obs import quality as tquality
from raft_tpu_torch.obs import slo as tslo
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import sharded as tsh
from raft_tpu_torch.serving.stats import ServingStats as TStats


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ----------------------------------------------------------------- metrics
def _script_counters(m):
    reg = m.Registry()
    c = reg.counter("raft_tpu_demo_total", "A counter.", ("engine", "event"))
    c.labels("e0", "ok").inc()
    c.labels("e0", "ok").inc(2.5)
    c.labels("e1", 'we"ird\n').inc()
    reg.counter("raft_tpu_plain_total").inc(7)
    return reg


def _script_gauges(m):
    reg = m.Registry()
    g = reg.gauge("raft_tpu_depth", "A gauge.", ("engine",))
    g.labels("a").set(3)
    g.labels("a").dec(0.5)
    g.labels("b").set_function(lambda: 42.0)
    g.labels("c").set_function(lambda: 1 / 0)  # NaN on read
    return reg


def _script_histograms(m):
    reg = m.Registry()
    h = reg.histogram("raft_tpu_lat_seconds", "Latency.", ("engine",))
    rng = np.random.default_rng(5)
    for v in rng.exponential(0.01, 300):
        h.labels("e0").observe(float(v))
    h.labels("e0").observe(100.0)  # the overflow bucket
    reg.histogram("raft_tpu_small_seconds",
                  buckets=m.exponential_buckets(1e-3, 4.0, 5)).observe(0.02)
    return reg


@pytest.mark.parametrize("script", [_script_counters, _script_gauges,
                                    _script_histograms])
def test_exposition_text_and_json_match_jax(script):
    j, t = script(jmetrics), script(tmetrics)
    assert t.to_prometheus_text() == j.to_prometheus_text()
    jj, tj = j.to_json(), t.to_json()
    assert json.dumps(tj, sort_keys=True, default=str) == \
        json.dumps(jj, sort_keys=True, default=str)


def test_histogram_quantiles_and_windows_match_jax():
    rng = np.random.default_rng(9)
    vals = rng.lognormal(-5, 1.5, 500)
    hs = [m.Registry().histogram("h") for m in (jmetrics, tmetrics)]
    base = [h.snapshot() for h in hs]
    for v in vals:
        for h in hs:
            h.observe(float(v))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        got = [(h.snapshot() - b).quantile(q) for h, b in zip(hs, base)]
        assert got[0] == got[1]
    with pytest.raises(ValueError):
        hs[1].snapshot().quantile(1.5)
    reg = tmetrics.Registry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")


# ------------------------------------------------------------------- spans
def test_spans_sinks_and_timed_span(tmp_path):
    path = tmp_path / "spans.jsonl"
    with obs.JsonlSink(str(path)) as sink:
        with obs.timed_span(sink, "tool", trace_id="t1", n=3) as rec:
            rec["extra"] = True
        with pytest.raises(RuntimeError):
            with obs.timed_span(sink, "tool", trace_id="t2"):
                raise RuntimeError("boom")
    with open(path, "a") as f:
        f.write('{"torn": ')  # a crashed writer's last line
    recs = obs.read_jsonl(str(path), kind="tool")
    assert [r["trace_id"] for r in recs] == ["t1", "t2"]
    assert recs[0]["extra"] and recs[0]["n"] == 3 and "duration_ms" in recs[0]
    assert recs[1]["error"] == "RuntimeError: boom"
    inner = obs.ListSink()
    ring = obs.RingSink(3, inner=inner)
    for i in range(5):
        obs.safe_emit(ring, {"kind": "x", "i": i})
    assert [r["i"] for r in ring.records] == [2, 3, 4]
    assert (ring.emitted, ring.dropped, len(inner)) == (5, 2, 5)

    class Raising:
        def emit(self, record):
            raise OSError("disk full")

    errors = tmetrics.REGISTRY.get("raft_tpu_obs_sink_errors_total")
    before = errors.value
    obs.safe_emit(Raising(), {"kind": "x"})
    assert errors.value == before + 1
    assert len(obs.new_trace_id()) == 16


# ----------------------------------------------------------------- explain
def test_reasons_are_jax_vocabulary_plus_the_ports_codes():
    assert texplain.REASONS - jexplain.REASONS == {"auto_fused", "smem"}
    assert jexplain.REASONS <= texplain.REASONS
    with pytest.raises(ValueError, match="vocabulary"):
        texplain.record_dispatch("brute_force", "auto", "pallas", "magic")


def test_capture_nesting_and_select_k_notes():
    with obs.capture() as outer:
        texplain.record_dispatch("brute_force", "auto", "xla", "forced")
        with obs.capture() as inner:
            texplain.record_dispatch("ivf_flat", "xla", "xla", "forced",
                                     plan={"kernel": "ivf_scan",
                                           "route": "plain"})
            texplain.note_select_k(64, 8, "DIRECT")
    assert [r.family for r in outer.records] == ["brute_force", "ivf_flat"]
    assert [r.family for r in inner.records] == ["ivf_flat"]
    # one note per open capture on the shared record, as in the JAX package
    assert inner.last.notes == [{"op": "select_k", "n": 64, "k": 8,
                                 "algo": "DIRECT", "k_pad": 0}] * 2
    assert inner.last.brief() == {"family": "ivf_flat", "requested": "xla",
                                  "engine": "xla", "reason": "forced",
                                  "kernel": "ivf_scan", "route": "plain"}
    with obs.capture() as alone:
        texplain.note_select_k(100, 5, "PALLAS")
    assert alone.last.family == "select_k"
    counts = obs.dispatch_counts()
    assert counts[("ivf_flat", "xla", "forced")] >= 1


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    db = rng.standard_normal((2000, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    return db, q


@pytest.fixture(scope="module")
def flat_pair(data):
    j = jivf.build(data[0], jivf.IndexParams(n_lists=16))
    t = interop.ivf_flat_index_from_numpy(
        tivf.IndexParams(n_lists=16), np.asarray(j.centers),
        np.asarray(j.list_data), np.asarray(j.list_indices),
        np.asarray(j.list_sizes), j.n_rows, np.asarray(j.overflow_data),
        np.asarray(j.overflow_indices), device="cpu")
    return j, t


@pytest.fixture(scope="module")
def pq_pair(data):
    j = jpq.build(data[0], jpq.IndexParams(n_lists=16, pq_dim=8,
                                           kmeans_n_iters=4))
    jp = j.params
    t = interop.ivf_pq_index_from_numpy(
        tpq.IndexParams(n_lists=jp.n_lists, pq_bits=jp.pq_bits,
                        pq_dim=j.pq_dim, list_pad_expansion=jp.
                        list_pad_expansion), j.pq_dim,
        *(np.asarray(a) for a in (j.centers, j.rotation, j.codebooks,
                                  j.list_codes, j.list_indices,
                                  j.list_sizes)), j.n_rows,
        *(np.asarray(a) for a in (j.overflow_codes, j.overflow_labels,
                                  j.overflow_indices)), device="cpu")
    return j, t


@pytest.fixture(scope="module")
def cagra_pair(data):
    db = data[0]
    graph = np.random.default_rng(2).integers(0, db.shape[0], (db.shape[0],
                                                               8), np.int32)
    params = dict(graph_degree=8, intermediate_graph_degree=16)
    j = jcagra.Index(jcagra.IndexParams(**params), jnp.asarray(db),
                     jnp.asarray(graph))
    t = interop.cagra_index_from_numpy(tcagra.IndexParams(**params), db,
                                       graph, device="cpu")
    return j, t


def _records(family, data, pairs, forced):
    """(JAX record, port record, port's expected (engine, reason))."""
    _, q = data
    if family == "brute_force":
        j = jbf.build(data[0])
        t = tbf.build(data[0], device="cpu")
        mode = "xla" if forced else "auto"
        jr = jbf.search(j, q, 4, scan_mode=mode, explain=True)[2]
        tr = tbf.search(t, q, 4, scan_mode=mode, explain=True)[2]
        return jr, tr, ("xla", "forced") if forced else ("pallas",
                                                         "auto_fused")
    j, t = pairs[family]
    if family == "ivf_flat":
        mode = "xla" if forced else "auto"
        jr = jivf.search(j, q, 4, jivf.SearchParams(n_probes=4,
                                                    scan_mode=mode),
                         explain=True)[2]
        tr = tivf.search(t, q, 4, tivf.SearchParams(n_probes=4,
                                                    scan_mode=mode),
                         explain=True)[2]
        return jr, tr, ("xla", "forced") if forced else ("pallas",
                                                         "auto_fused")
    if family == "ivf_pq":
        mode = "lut" if forced else "auto"
        jr = jpq.search(j, q, 4, jpq.SearchParams(n_probes=4,
                                                  scan_mode=mode),
                        explain=True)[2]
        sp = tpq.SearchParams(n_probes=4, scan_mode=mode)
        tr = tpq.search(t, q, 4, sp, explain=True)[2]
        plan = tpq.plan_search(t, 4, sp)
        return jr, tr, (plan.engine, plan.reason)
    mode = "xla" if forced else "auto"
    jr = jcagra.search(j, q, 4, jcagra.SearchParams(itopk_size=16,
                                                    scan_mode=mode),
                       explain=True)[2]
    tr = tcagra.search(t, q, 4, tcagra.SearchParams(itopk_size=16,
                                                    scan_mode=mode),
                       explain=True)[2]
    return jr, tr, ("xla", "forced") if forced else ("pallas", "auto_fused")


@pytest.mark.parametrize("forced", [True, False], ids=["forced", "auto"])
@pytest.mark.parametrize("family", ["brute_force", "ivf_flat", "ivf_pq",
                                    "cagra"])
def test_explain_records_match_jax(family, forced, data, flat_pair, pq_pair,
                                   cagra_pair):
    pairs = {"ivf_flat": flat_pair, "ivf_pq": pq_pair, "cagra": cagra_pair}
    jr, tr, (engine, reason) = _records(family, data, pairs, forced)
    assert (tr.family, tr.requested, tr.params) == \
        (jr.family, jr.requested, jr.params)
    assert (tr.engine, tr.reason) == (engine, reason)
    if forced:
        assert (tr.engine, tr.reason) == (jr.engine, jr.reason)
    else:
        assert tr.plan["route"] == "plain" and "kernel" in tr.plan
    assert tr.reason in texplain.REASONS


def test_explain_leaves_results_unchanged(data, flat_pair):
    _, t = flat_pair
    _, q = data
    sp = tivf.SearchParams(n_probes=4)
    v0, i0 = tivf.search(t, q, 4, sp)
    v1, i1, rec = tivf.search(t, q, 4, sp, explain=True)
    assert torch.equal(v0, v1) and torch.equal(i0, i1)
    assert {n["op"] for n in rec.notes} == {"select_k"}


# ------------------------------------------------------------ SLO, quality
def _slo_script(stats_cls, slo_mod, m):
    reg = m.Registry()
    clock = FakeClock()
    stats = stats_cls(registry=reg, engine_label="e0")
    mon = slo_mod.SLOMonitor(
        [slo_mod.SLO("avail", "availability", 0.99),
         slo_mod.SLO("lat", "latency_p99", 0.99, threshold_ms=20.0),
         slo_mod.SLO("recall", "recall_floor", 0.9)],
        "e0", registry=reg, window_s=60.0, clock=clock)
    out = []
    for step in range(6):
        clock.t += 15.0
        stats.record_submit(10)
        stats.record_batch(8, 8, [0.001] * 8, 0.004,
                           [0.005 + 0.01 * step] * 8)
        if step % 2:
            stats.record_shed_deadline(2)
            stats.record_rejected("overload")
        out.append(mon.report())
    reg.gauge("raft_tpu_online_recall", "", ("family", "k", "bucket")) \
        .labels("ivf_flat", 10, 8).set(0.85)
    out.append(mon.report())
    for r in out:
        r.pop("engine")
    return out


def test_slo_burn_rates_match_jax():
    assert _slo_script(TStats, tslo, tmetrics) == \
        _slo_script(JStats, jslo, jmetrics)


def test_recall_estimates_and_shadow_sampling_match_jax():
    rng = np.random.default_rng(4)
    served = rng.integers(-1, 50, (30, 10))
    oracle = rng.integers(0, 50, (30, 10))
    assert [tquality.overlap_at_k(s, o) for s, o in zip(served, oracle)] == \
        [jquality.overlap_at_k(s, o) for s, o in zip(served, oracle)]

    def run(quality_mod, m):
        reg = m.Registry()
        events = []

        def oracle_fn(queries, k):
            ids = np.argsort(queries, axis=1)[:, :k]
            return None, ids

        s = quality_mod.ShadowSampler(
            oracle_fn, 0.5, seed=3, registry=reg,
            record_event=lambda ev, n: events.append((ev, n)),
            clock=FakeClock())
        for b in range(12):
            q = np.random.default_rng(b).standard_normal((4, 10))
            s.offer(q, [np.argsort(row)[:5] if j % 2 else np.arange(5)
                        for j, row in enumerate(q)],
                    [f"t{b}{j}" for j in range(4)], [5] * 4, "ivf_flat", 8)
        s.close()
        return sorted(events), s.estimator.snapshot()

    assert run(tquality, tmetrics) == run(jquality, jmetrics)


# ------------------------------------------------------------- diagnostics
def test_diagnostics_bundle_loads_with_jaxs_keys(tmp_path):
    reg = _script_counters(tmetrics)
    spans = [{"kind": "batch", "trace_ids": ["a"]}]
    doc = tdiag.build_bundle("manual", spans=spans, registry=reg,
                             health={"status": "ok"}, config={"x": 1},
                             extra={"ring_capacity": 4})
    path = tdiag.write_bundle(str(tmp_path), doc)
    again = tdiag.write_bundle(str(tmp_path), doc)
    assert path != again  # same stamp: a counter suffix
    back = tdiag.load_bundle(path)
    jdoc = jdiag.build_bundle("manual", spans=spans,
                              registry=_script_counters(jmetrics),
                              health={"status": "ok"}, config={"x": 1},
                              extra={"ring_capacity": 4})
    assert set(back) == set(jdoc)
    assert back["schema"] == jdiag.BUNDLE_SCHEMA
    assert back["metrics"] == json.loads(json.dumps(jdoc["metrics"]))
    assert jdiag.load_bundle(path)["spans"] == spans  # JAX reads it too
    (tmp_path / "bad.json").write_text('{"schema": "other"}')
    with pytest.raises(ValueError, match="not a diagnostics bundle"):
        tdiag.load_bundle(str(tmp_path / "bad.json"))


# ----------------------------------------------------------------- device
def test_kernel_build_counter_and_profile_session(tmp_path):
    c0, s0 = obs.compile_count(), obs.compile_seconds()
    assert tdevice._listener in gk.BUILD_LISTENERS
    for listener in gk.BUILD_LISTENERS:
        listener(3, 0.25)
    assert obs.compile_count() - c0 == 3
    assert obs.compile_seconds() - s0 == pytest.approx(0.25)
    text = tmetrics.REGISTRY.to_prometheus_text()
    assert "raft_tpu_kernel_build_total" in text
    active = tmetrics.REGISTRY.get("raft_tpu_profile_active")
    with obs.profile_session(str(tmp_path / "trace")) as d:
        assert active.value == 1
        torch.ones(4).sum()
    assert active.value == 0
    assert (tmp_path / "trace" / "trace.json").exists() and \
        d == str(tmp_path / "trace")


# ---------------------------------------------------------------- httpd
def test_metrics_server_routes():
    reg = _script_counters(tmetrics)
    srv = obs.MetricsServer(
        0, registry=reg, health_fn=lambda: {"status": "unhealthy"},
        bundle_fn=lambda: {"schema": "x"},
        text_route_fn=lambda p: "extra 1\n" if p == "/x" else None).start()
    try:
        def get(path):
            try:
                with urllib.request.urlopen(srv.url + path, timeout=30) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        code, text = get("/metrics")
        assert code == 200 and text == reg.to_prometheus_text()
        assert get("/healthz")[0] == 503
        assert get("/slo")[0] == 404
        assert json.loads(get("/debug/bundle")[1]) == {"schema": "x"}
        assert get("/x") == (200, "extra 1\n")
        assert get("/nope")[0] == 404
        assert json.loads(get("/metrics.json")[1]) == json.loads(
            json.dumps(reg.to_json()))
    finally:
        srv.stop()


# ------------------------------------------------------------ sharded spans
@pytest.mark.parametrize("search", ["knn", "ivf_flat"])
def test_sharded_span_sink_is_bitwise_neutral(search, data):
    db, _ = data
    q = db[:24] + 0.01
    c = tcomms.init_comms(["cpu"] * 4)
    if search == "knn":
        def run():
            return tsh.knn(c, q, db, 6, merge_mode="ring")
    else:
        index = tsh.build_ivf_flat(c, db, tivf.IndexParams(n_lists=4))

        def run():
            return tsh.search_ivf_flat(index, q, 6,
                                       tivf.SearchParams(n_probes=2))
    plain = run()
    sink = obs.ListSink()
    prev = tsh.set_span_sink(sink)
    try:
        with obs.capture() as cap:
            traced = run()
    finally:
        tsh.set_span_sink(prev)
    for a, b in zip(plain, traced):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    shards = sink.by_kind("shard_search")
    assert [s["rank"] for s in shards] == [0, 1, 2, 3]
    assert all(s["device_ms"] >= 0 and s["device"] == "cpu" for s in shards)
    (parent,) = sink.by_kind("sharded_search")
    assert {s["trace_id"] for s in shards} == {parent["trace_id"]}
    family = "brute_force" if search == "knn" else "ivf_flat"
    merge = cap.last
    assert merge.family == f"sharded_{family}"
    assert merge.params["engine"] == "pallas"
    assert merge.reason in texplain.REASONS


def test_jax_obs_exports_are_ported():
    missing = set(jobs.__all__) - set(obs.__all__)
    assert missing == set()
