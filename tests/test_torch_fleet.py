"""raft_tpu_torch.serving's fleet (router, Fleet, the fleet injectors)
against raft_tpu.serving's, on the CPU.

Decisions are held against the JAX package's: ``Router.choose`` gives the
same replica sequence for the same seed over the same stub replicas
(health, queue depth, queue-wait window, breaker probes on one fake
clock), ``RetryPolicy.backoff_ms`` the same draws, ``failure_kind`` and
``is_retryable`` the same labels for the same typed failures. A port
fleet and a raft_tpu fleet over one IVF-Flat index that raft_tpu builds
and ``interop`` carries (``device="cpu"``) give rows within
``test_torch_ivf_flat.py``'s tolerance (distances atol 1e-4·max‖x‖², rtol
1e-5; ids equal away from near-ties), and every port row is bitwise
``solo_reference`` on the handle that served it.

The chaos cases of ``tests/test_fleet_chaos.py`` run over the port: a
replica killed mid-batch, an injected batch failure, a breaker-open
replica routed around and re-admitted, a rolling swap under load and
below quorum, tight-deadline sheds, a backoff that cannot fit the
remaining budget, all replicas dead, a stop racing live submissions,
``/healthz``, and the router's races under
``raft_tpu_torch.testing.interleave``. Every case resolves each request to
exactly one typed outcome, and the outcome counters reconcile with
``submitted`` (and with the ``kind="fleet"`` spans where a sink is on).

The breaker case is written so that it cannot race. The reference's
version reads the replica's ``health()`` right after ``fleet.search``
returns, but the engine settles a probe's future before its completion
thread closes the breaker, and it expects a re-admitted replica to win
power-of-two choices against a sibling whose load score comes from a
real-clock queue-wait window; either can make it fail under load. Here
every search is followed by ``Engine.drain`` on the probed replica (which
returns only after the completion thread has closed the breaker and
recorded the batch), and the fleet routes with ``pressure_weight=0`` so
the pair's scores tie and the seeded draw decides.
"""

import json
import random
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu import serving as jserving
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.serving import router as jrouter
from raft_tpu_torch import interop, serving
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.obs.spans import ListSink
from raft_tpu_torch.serving import router as trouter
from raft_tpu_torch.serving.engine import solo_reference
from raft_tpu_torch.testing import assert_topk_close, faults

DIM, K, T = 16, 5, 60  # T: every future's and drain's bound, seconds


@pytest.fixture(scope="module")
def flat_pair():
    rng = np.random.default_rng(3)
    db = rng.standard_normal((1500, DIM)).astype(np.float32)
    j = jivf.build(db, jivf.IndexParams(n_lists=16), res=JResources(seed=0))
    t = interop.ivf_flat_index_from_numpy(
        tivf.IndexParams(n_lists=16), np.asarray(j.centers),
        np.asarray(j.list_data), np.asarray(j.list_indices),
        np.asarray(j.list_sizes), j.n_rows, np.asarray(j.overflow_data),
        np.asarray(j.overflow_indices), device="cpu")
    return db, j, t


@pytest.fixture(scope="module")
def flat_index(flat_pair):
    return flat_pair[2]


def _searcher(index, n_probes=8):
    # a fresh handle per replica: the injectors rebind .search per handle
    return serving.ivf_flat_searcher(index, tivf.SearchParams(
        n_probes=n_probes))


def _fleet(index, n=2, sink=None, engine_kw=None, **fleet_kw):
    ekw = {"max_batch": 8, "max_wait_us": 5000, "warm_ks": (K,)}
    ekw.update(engine_kw or {})
    fleet_kw.setdefault("quorum", 1)
    fleet_kw.setdefault("seed", 7)
    fleet_kw.setdefault("probe_interval_s", 0.05)
    cfg = serving.FleetConfig(span_sink=sink, **fleet_kw)
    return serving.Fleet.from_searchers(
        [_searcher(index) for _ in range(n)],
        engine_config=serving.EngineConfig(**ekw), config=cfg)


def _q(rng):
    return rng.standard_normal(DIM).astype(np.float32)


def _reconcile(fleet, sink=None):
    """Every submitted request resolved to exactly one typed outcome."""
    oc = fleet.stats.outcome_counts()
    resolved = sum(v for k, v in oc.items() if k != "submitted")
    assert oc["submitted"] == resolved, f"silent loss: {oc}"
    if sink is not None:
        assert len(sink.by_kind("fleet")) == oc["submitted"]
    return oc


def _assert_bitwise_solo(fut, query):
    d, i = fut.result(timeout=0)
    ref_d, ref_i = solo_reference(fut.searcher, query, K, *fut.placement)
    assert np.array_equal(d.view(np.int32), ref_d.view(np.int32))
    assert np.array_equal(i, ref_i)


# ------------------------------------------------------ router decisions


class _StubStats:
    def __init__(self, p99):
        self.p99 = p99

    def queue_wait_p99_s(self):
        return self.p99

    def queue_wait_p99_window_s(self):
        return self.p99


class _StubEngine:
    def __init__(self, status, depth, p99, breaker="closed", running=True):
        self.h = {"status": status, "running": running, "breaker": breaker,
                  "shedding": False, "queue_depth": depth, "coverage": 1.0,
                  "n_batch_errors": 0, "n_hangs": 0}
        self.batcher = [None] * depth
        self.stats = _StubStats(p99)
        self.autoscale_budget_ms = 50.0

    def health(self):
        return dict(self.h)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _choices(router_mod, seed):
    """200 choices over a scripted replica set: its health, depths,
    windows, admin states and the excluded names change as it goes."""
    rng = random.Random(1234)
    clock = _Clock()
    router = router_mod.Router(seed=seed, probe_interval_s=1.0,
                               clock=clock)
    reps = [types.SimpleNamespace(name=f"r{j}", admin="in_service",
                                  engine=_StubEngine("ok", 0, 0.0))
            for j in range(5)]
    out = []
    for step in range(200):
        clock.t += 0.25
        for r in reps:
            status = rng.choice(["ok", "ok", "ok", "degraded", "unhealthy"])
            breaker = "open" if status == "unhealthy" and \
                rng.random() < 0.7 else "closed"
            r.engine = _StubEngine(status, rng.randrange(0, 40),
                                   rng.random() * 0.08, breaker,
                                   running=rng.random() < 0.9)
            r.admin = "in_service" if rng.random() < 0.85 else "draining"
        exclude = {f"r{j}" for j in range(5) if rng.random() < 0.2}
        got = router.choose(reps, exclude=exclude)
        out.append(None if got is None else got.name)
        if step % 7 == 0:
            out.append(round(router.backoff_ms(
                router_mod.RetryPolicy(retry_limit=3, backoff_base_ms=2.0,
                                       backoff_cap_ms=40.0),
                1 + step % 5), 12))
    return out


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_router_choices_equal_raft_tpus(seed):
    mine, theirs = _choices(trouter, seed), _choices(jrouter, seed)
    assert mine == theirs
    assert len({c for c in mine if isinstance(c, str)}) >= 3


def test_retry_policy_backoff_equal_raft_tpus():
    for limit, base, cap in ((3, 1.0, 50.0), (0, 4.0, 4.0), (6, 0.2, 2.0)):
        a = trouter.RetryPolicy(limit, base, cap)
        b = jrouter.RetryPolicy(limit, base, cap)
        ra, rb = random.Random(limit), random.Random(limit)
        for retry in range(1, 12):
            assert a.backoff_ms(retry, ra) == b.backoff_ms(retry, rb)
    with pytest.raises(ValueError):
        trouter.RetryPolicy(retry_limit=-1)


_KINDS = ["BatchFailed", "Overloaded", "CircuitOpen", "QueueFull",
          "EngineStopped", "DeadlineExceeded", "IntegrityError",
          "NoReplicaAvailable", "RetriesExhausted", "ReplicaStarting",
          "FleetBelowQuorum"]


@pytest.mark.parametrize("name", _KINDS)
def test_failure_kind_and_retryability_equal_raft_tpus(name):
    assert name in serving.__all__ and hasattr(serving, name)
    mine, theirs = getattr(serving, name)("x"), getattr(jserving, name)("x")
    assert serving.failure_kind(mine) == jserving.failure_kind(theirs)
    assert serving.is_retryable(mine) == jserving.is_retryable(theirs)


def test_untyped_and_cancelled_failures_equal_raft_tpus():
    from concurrent.futures import CancelledError

    for exc in (ValueError("x"), RuntimeError("x"), CancelledError()):
        assert serving.failure_kind(exc) == jserving.failure_kind(exc)
        assert serving.is_retryable(exc) == jserving.is_retryable(exc)
    assert trouter.FAILURE_KINDS == jrouter.FAILURE_KINDS
    for sub in ("CircuitOpen", "NoReplicaAvailable", "RetriesExhausted",
                "ReplicaStarting"):
        assert issubclass(getattr(serving, sub), serving.Overloaded)
    assert serving.failure_kind(
        serving.CircuitOpen("overloaded-looking text")) == "circuit_open"


def test_fleet_exports_equal_raft_tpus():
    names = ("Fleet", "FleetConfig", "Replica", "Router", "RetryPolicy",
             "FleetBelowQuorum", "NoReplicaAvailable", "RetriesExhausted",
             "ReplicaStarting", "failure_kind", "is_retryable",
             "RemoteReplica", "Autoscaler", "AutoscalerConfig",
             "AUTOSCALE_REASONS")
    for name in names:
        assert name in serving.__all__ and name in jserving.__all__, name
    assert serving.AUTOSCALE_REASONS == jserving.AUTOSCALE_REASONS
    from raft_tpu.serving import fleet as jfleet
    from raft_tpu_torch.serving import fleet as tfleet
    assert tfleet._FLEET_EVENTS == jfleet._FLEET_EVENTS
    assert tfleet._LIFECYCLE_EVENTS == jfleet._LIFECYCLE_EVENTS
    assert [f.name for f in __import__("dataclasses").fields(
        serving.FleetConfig)] == [f.name for f in __import__(
            "dataclasses").fields(jserving.FleetConfig)]


# ------------------------------------------------- rows against raft_tpu


def test_fleet_rows_close_to_raft_tpus_and_bitwise_solo(flat_pair):
    db, j, t = flat_pair
    q = np.random.default_rng(11).standard_normal((40, DIM)).astype(
        np.float32)
    fleet = _fleet(t, n=2)
    with fleet:
        futs = [fleet.submit(row, K) for row in q]
        got = [f.result(timeout=T) for f in futs]
        for f, row in zip(futs, q):
            _assert_bitwise_solo(f, row)
            assert f.replica in ("replica0", "replica1")
    jfleet = jserving.Fleet.from_searchers(
        [jserving.ivf_flat_searcher(j, jivf.SearchParams(n_probes=8))
         for _ in range(2)],
        engine_config=jserving.EngineConfig(max_batch=8, max_wait_us=5000,
                                            warm_ks=(K,)),
        config=jserving.FleetConfig(quorum=1, seed=7))
    with jfleet:
        want = [jfleet.submit(row, K).result(timeout=T) for row in q]
    scale = float((db ** 2).sum(1).max())
    assert_topk_close(
        (torch.from_numpy(np.stack([d for d, _ in got])),
         torch.from_numpy(np.stack([i for _, i in got]))),
        (torch.from_numpy(np.stack([np.asarray(d) for d, _ in want])),
         torch.from_numpy(np.stack([np.asarray(i) for _, i in want]))),
        1e-4 * scale, 1e-5, "fleet rows")


# ------------------------------------------------------------ chaos cases


def test_replica_kill_mid_batch_retries_on_sibling(flat_index):
    sink = ListSink()
    fleet = _fleet(flat_index, n=2, sink=sink)
    rng = np.random.default_rng(0)
    with fleet:
        r0 = fleet.replicas[0]
        # slow r0 so a backlog builds there: the kill must catch riders
        restore = faults._wrap_search(
            r0.engine.searcher,
            lambda orig, q, k: (time.sleep(0.05), orig(q, k))[1])
        queries = [_q(rng) for _ in range(60)]
        futs = [fleet.submit(q, K) for q in queries]
        deadline = time.monotonic() + T
        while len(r0.engine.batcher) == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert len(r0.engine.batcher) > 0, "no backlog built on r0"
        faults.kill_replica(fleet, "replica0")
        restore()
        for q, f in zip(queries, futs):
            f.result(timeout=T)
            _assert_bitwise_solo(f, q)
        oc = _reconcile(fleet, sink)
        assert oc["ok"] == len(queries)
        retried = sum(int(c.value) for (rep, _), c in
                      fleet.stats._retried.items() if rep == "replica0")
        assert retried > 0, "the kill produced no sibling retries"
    spans = sink.by_kind("fleet")
    assert len({s["trace_id"] for s in spans}) == len(queries)
    for s in spans:
        assert s["outcome"] == "ok"
        assert all(("trace" in a) or ("error" in a) for a in s["attempts"])


def test_injected_batch_failure_retries_bitwise(flat_index):
    fleet = _fleet(flat_index, n=2)
    rng = np.random.default_rng(1)
    with fleet:
        disarm = faults.fail_next_dispatch(
            fleet.replicas[0].engine.searcher, times=5)
        queries = [_q(rng) for _ in range(30)]
        futs = [fleet.submit(q, K) for q in queries]
        for q, f in zip(queries, futs):
            f.result(timeout=T)
            _assert_bitwise_solo(f, q)
        disarm()
        assert _reconcile(fleet)["ok"] == len(queries)


class _FakeClock:
    def __init__(self, t=0.0):
        self._t = t
        self._lock = threading.Lock()

    def advance(self, dt):
        with self._lock:
            self._t += dt

    def __call__(self):
        with self._lock:
            return self._t


def test_breaker_open_routed_around_then_readmitted(flat_index):
    """Race-free (module docstring): the cooldown and the probe interval
    run on a fake clock, every search is followed by ``drain`` on the
    probed replica, and routing ignores the real-clock pressure."""
    fleet = _fleet(flat_index, n=2, probe_interval_s=10.0,
                   pressure_weight=0.0,
                   engine_kw={"breaker_cooldown_s": 60.0})
    rng = np.random.default_rng(2)
    with fleet:
        clk = _FakeClock()
        r0 = fleet.replicas[0].engine
        r0.breaker.clock = clk
        fleet.router.clock = clk

        def search():
            fleet.search(_q(rng), K, timeout=T)
            assert r0.drain(T)  # the probe's batch fully settled

        faults.trip_breaker(fleet, "replica0")
        assert r0.health()["status"] == "unhealthy"
        assert fleet.health()["status"] == "degraded"
        assert fleet.healthy_count() == 1
        for _ in range(10):
            search()
        assert r0.breaker.state == "open", "closed with no cooldown"
        clk.advance(61.0)
        for _ in range(30):
            search()
            if r0.breaker.state == "closed":
                break
            clk.advance(10.5)  # the next probe window
        assert r0.health()["status"] == "ok", "no probe closed the breaker"
        assert fleet.health()["status"] == "ok"
        before = int(fleet.stats._routed["replica0"].value)
        for _ in range(40):
            search()
        assert int(fleet.stats._routed["replica0"].value) > before, \
            "the re-admitted replica got no traffic"
        _reconcile(fleet)


def test_hang_replica_watchdog_routes_around(flat_index):
    fleet = _fleet(flat_index, n=2, engine_kw={"hang_timeout_s": 0.3,
                                               "breaker_cooldown_s": 60.0})
    rng = np.random.default_rng(9)
    with fleet:
        disarm = faults.hang_replica(fleet, "replica0", hang_s=2.0)
        # drive requests until one lands on the hung replica and the
        # watchdog opens its breaker; every request still resolves ok
        deadline = time.monotonic() + T
        futs = []
        while (fleet.replicas[0].engine.breaker.state != "open"
               and time.monotonic() < deadline):
            futs.append(fleet.submit(_q(rng), K))
            time.sleep(0.01)
        assert fleet.replicas[0].engine.breaker.state == "open"
        for f in futs:
            f.result(timeout=T)
        disarm()
        assert fleet.replicas[0].engine.health()["n_hangs"] >= 1
        oc = _reconcile(fleet)
        assert oc["ok"] == len(futs)


def test_rolling_swap_under_load_zero_drops_never_below_quorum(flat_index):
    fleet = _fleet(flat_index, n=3, quorum=2)
    results, lock = [], threading.Lock()
    stop_sampling = threading.Event()
    samples = []

    def sampler():
        while not stop_sampling.is_set():
            samples.append(fleet.healthy_count())
            time.sleep(0.002)

    def submitter(ti):
        trng = np.random.default_rng(100 + ti)
        for _ in range(40):
            q = _q(trng)
            f = fleet.submit(q, K)
            with lock:
                results.append((q, f))

    with fleet:
        threads = [threading.Thread(target=submitter, args=(ti,))
                   for ti in range(3)]
        sam = threading.Thread(target=sampler)
        sam.start()
        for t in threads:
            t.start()
        old = fleet.rolling_swap([_searcher(flat_index, 4)
                                  for _ in range(3)])
        for t in threads:
            t.join()
        assert fleet.drain(timeout=T)
        stop_sampling.set()
        sam.join()
        assert all(o is not None for o in old)
        assert samples and min(samples) >= 2, f"quorum dipped: {min(samples)}"
        for q, f in results:
            assert f.done()
            _assert_bitwise_solo(f, q)
        assert _reconcile(fleet)["ok"] == len(results)
        assert fleet.stats._swaps.value == 3
        assert all(r.engine.searcher_generation == 1
                   for r in fleet.replicas)


def test_rolling_swap_refuses_below_quorum(flat_index):
    fleet = _fleet(flat_index, n=2, quorum=2)
    with fleet:
        gens = [r.engine.searcher_generation for r in fleet.replicas]
        with pytest.raises(serving.FleetBelowQuorum):
            fleet.rolling_swap([_searcher(flat_index) for _ in range(2)])
        assert [r.engine.searcher_generation
                for r in fleet.replicas] == gens
        assert all(r.admin == "in_service" for r in fleet.replicas)


def test_tight_deadline_sheds_typed_instead_of_retrying(flat_index):
    fleet = _fleet(flat_index, n=2, engine_kw={"max_wait_us": 2_000_000})
    rng = np.random.default_rng(5)
    with fleet:
        fut = fleet.submit(_q(rng), K, deadline_ms=30.0)
        with pytest.raises(serving.DeadlineExceeded):
            fut.result(timeout=T)
        assert _reconcile(fleet)["shed_deadline"] == 1
        assert sum(int(c.value) for c in
                   fleet.stats._retried.values()) == 0


def test_retry_backoff_honors_remaining_ms(flat_index):
    fleet = _fleet(flat_index, n=1, seed=0, retry_limit=4,
                   backoff_base_ms=4000.0, backoff_cap_ms=4000.0)
    rng = np.random.default_rng(6)
    with fleet:
        disarm = faults.fail_next_dispatch(
            fleet.replicas[0].engine.searcher, times=10)
        t0 = time.perf_counter()
        fut = fleet.submit(_q(rng), K, deadline_ms=2000.0)
        with pytest.raises(serving.DeadlineExceeded) as got:
            fut.result(timeout=T)
        elapsed = time.perf_counter() - t0
        disarm()
        assert elapsed < 1.5, f"slept into the backoff: {elapsed:.2f}s"
        assert isinstance(got.value.__cause__, serving.BatchFailed)
        assert _reconcile(fleet)["shed_deadline"] == 1


def test_all_replicas_dead_sheds_typed(flat_index):
    fleet = _fleet(flat_index, n=2)
    rng = np.random.default_rng(7)
    with fleet:
        faults.kill_replica(fleet, 0)
        faults.kill_replica(fleet, 1)
        fut = fleet.submit(_q(rng), K)
        with pytest.raises(serving.NoReplicaAvailable):
            fut.result(timeout=T)
        assert isinstance(fut.exception(), serving.Overloaded)
        assert _reconcile(fleet)["shed_no_replica"] == 1


def test_fleet_stop_strands_no_future(flat_index):
    sink = ListSink()
    fleet = _fleet(flat_index, n=2, sink=sink)
    rng = np.random.default_rng(8)
    with fleet:
        futs = [fleet.submit(_q(rng), K) for _ in range(40)]
        fleet.stop(drain=False)
        for f in futs:
            assert f.done(), "stranded future after stop"
            if f.exception() is not None:
                assert isinstance(f.exception(), serving.EngineStopped)
        _reconcile(fleet, sink)
    with pytest.raises(serving.EngineStopped):
        fleet.submit(_q(rng), K)


def test_healthz_aggregates_fleet_state(flat_index):
    fleet = _fleet(flat_index, n=3, quorum=2)
    with fleet:
        srv = fleet.serve_metrics(port=0)
        url = f"http://127.0.0.1:{srv.port}/healthz"

        def get():
            try:
                with urllib.request.urlopen(url, timeout=T) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, doc = get()
        assert code == 200 and doc["status"] == "ok"
        assert doc["quorum"] == {"required": 2, "healthy": 3, "ok": True}
        faults.kill_replica(fleet, "replica2")
        code, doc = get()
        assert code == 200 and doc["status"] == "degraded"
        assert doc["quorum"]["healthy"] == 2
        assert doc["replicas"]["replica2"]["status"] == "unhealthy"
        faults.kill_replica(fleet, "replica1")
        code, doc = get()
        assert code == 503 and doc["status"] == "unhealthy"
        assert doc["quorum"]["ok"] is False
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=T).read()
        for family in ("raft_tpu_fleet_requests_total",
                       "raft_tpu_fleet_quorum_healthy",
                       "raft_tpu_fleet_quorum_threshold",
                       "raft_tpu_fleet_replica_health"):
            assert family.encode() in body


# ------------------------------------------------- interleaved router races


def _stub_searcher(dim=8):
    """Pure-numpy handle on the CPU: deterministic rows, microseconds a
    batch."""
    def search(queries, k):
        q = np.asarray(queries, np.float32)
        base = q.sum(axis=1, keepdims=True)
        d = base + np.arange(k, dtype=np.float32)[None, :]
        i = (np.abs(q).sum(axis=1, keepdims=True).astype(np.int64)
             + np.arange(k, dtype=np.int64)[None, :])
        return torch.from_numpy(d.astype(np.float32)), torch.from_numpy(i)

    index = types.SimpleNamespace(device=torch.device("cpu"))
    return serving.Searcher(family="stub", dim=dim, index=index,
                            search=search)


@pytest.mark.interleave
@pytest.mark.parametrize("seed", range(8))
def test_router_races_amplified(seed):
    from raft_tpu_torch.testing.interleave import InterleaveAmplifier

    dim = 8
    cfg = serving.FleetConfig(quorum=1, seed=seed, retry_limit=4,
                              backoff_base_ms=0.2, backoff_cap_ms=2.0,
                              probe_interval_s=0.01)
    ecfg = serving.EngineConfig(max_batch=4, max_wait_us=200, warm_ks=(K,),
                                hang_timeout_s=None, flight_recorder=False)
    fleet = serving.Fleet.from_searchers(
        [_stub_searcher(dim) for _ in range(3)], engine_config=ecfg,
        config=cfg)
    futs, lock = [], threading.Lock()

    def submitter(ti):
        trng = np.random.default_rng(1000 + ti)
        for _ in range(15):
            q = trng.standard_normal(dim).astype(np.float32)
            try:
                f = fleet.submit(q, K)
            except serving.EngineStopped:
                return
            with lock:
                futs.append(f)

    def chaos():
        faults.fail_next_dispatch(fleet.replicas[0].engine.searcher, times=3)
        try:
            fleet.rolling_swap([_stub_searcher(dim) for _ in range(3)],
                               warm=False)
        except serving.FleetBelowQuorum:
            pass
        faults.kill_replica(fleet, "replica2")

    with InterleaveAmplifier(seed=seed, yield_probability=0.05,
                             path_filters=("raft_tpu_torch/serving",)):
        fleet.start()
        threads = [threading.Thread(target=submitter, args=(ti,))
                   for ti in range(3)]
        threads.append(threading.Thread(target=chaos))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert fleet.drain(timeout=T), f"seed {seed}: drain hung"
        fleet.stop(drain=False)
    for f in futs:
        assert f.done(), f"seed {seed}: stranded future"
        exc = f.exception()
        if exc is not None:
            assert isinstance(exc, (serving.Overloaded, serving.BatchFailed,
                                    serving.EngineStopped,
                                    serving.DeadlineExceeded)), (seed, exc)
    oc = fleet.stats.outcome_counts()
    assert oc["submitted"] == sum(v for k, v in oc.items()
                                  if k != "submitted") == len(futs)


# ----------------------------------------- the Compactor's rolling target


def test_compactor_publishes_through_a_fleet(tmp_path):
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import mutable
    from raft_tpu_torch.obs import metrics as obs_metrics

    w = mutable.MutableIvf(str(tmp_path / "m"), dim=8,
                           res=Resources(device="cpu", seed=0),
                           registry=obs_metrics.Registry(),
                           span_sink=ListSink(), group_window_s=0.0,
                           index_params=tivf.IndexParams(n_lists=4))
    rng = np.random.default_rng(12)
    w.add(rng.standard_normal((24, 8)).astype(np.float32))
    searchers = [serving.mutable_ivf_searcher(w) for _ in range(2)]
    cfg = serving.EngineConfig(max_batch=4, max_wait_us=2000,
                               warm_ks=(3,), warm_buckets=(1, 4))
    with serving.Fleet.from_searchers(
            searchers, engine_config=cfg,
            config=serving.FleetConfig(quorum=1)) as fleet:
        comp = mutable.Compactor(w, publish=fleet)
        assert comp.run_once("manual") == "ok"
        span = [s for s in w.span_sink.records
                if s["kind"] == "compaction"][-1]
        assert span["searcher_gen"] == [1, 1]  # every replica swapped
        d, i = fleet.search(rng.standard_normal(8).astype(np.float32), 3,
                            timeout=T)
        assert np.asarray(i).shape == (3,)
    w.close()
