"""raft_tpu_torch.serving's remote replicas, replica_main and autoscaler
against raft_tpu.serving's, on the CPU.

- The wire: ``encode_message`` writes raft_tpu's bytes for the same header
  and arrays, and each package's ``decode_message`` reads the other's;
  the error table rebuilds the same typed classes, and
  ``classify_transport`` / ``map_transport_error`` give raft_tpu's kinds.
  ``build_searcher`` draws raft_tpu's rows from the same seed.
- Loopback (a port ``_ReplicaServer`` and ``RemoteReplica`` in one
  process): searches bitwise the engine behind the proxy (and bitwise
  ``solo_reference`` at the placement the reply carries), the deadline
  enforced on the far side, health piggybacked on every reply, the
  ``scrape`` op, a graceful stop mapped to ``EngineStopped``, the fleet's
  one scrape target.
- Across the packages, through real child processes: a port
  ``RemoteReplica`` against a raft_tpu ``replica_main`` child
  (``JAX_PLATFORMS=cpu``) and a raft_tpu ``RemoteReplica`` against a port
  child (``--device cpu``), on the brute-force spec; the rows are within
  ``assert_topk_close`` (distances atol 1e-4·max‖x‖², rtol 1e-5) of both
  packages' brute force.
- The autoscaler: its hysteresis, fast burn, ``spawn_failed`` and quorum
  block decide exactly as raft_tpu's on one fake clock (the same spans,
  the same lifecycle counts).
- A port child SIGKILLed mid-load: every future resolves, ok or typed,
  ``submitted`` equals the sum of the outcomes and of the fleet spans.
- Without a card and without ``--device cpu``, a replica exits non-zero
  and says why.

Every port is taken by binding to port 0 and handed to the children with
``--peers``; a child that cannot bind exits non-zero and is started once
more with fresh ports.
"""

import errno
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu import serving as jserving
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.parallel import host_p2p as jp2p
from raft_tpu.serving import remote as jremote
from raft_tpu.serving import replica_main as jmain
from raft_tpu.serving.autoscaler import Autoscaler as JAutoscaler
from raft_tpu.serving.autoscaler import AutoscalerConfig as JAutoscalerConfig
from raft_tpu_torch import serving
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.obs.spans import ListSink
from raft_tpu_torch.parallel import host_p2p as tp2p
from raft_tpu_torch.serving import remote
from raft_tpu_torch.serving import replica_main as tmain
from raft_tpu_torch.serving.autoscaler import Autoscaler, AutoscalerConfig
from raft_tpu_torch.serving.engine import Engine, EngineConfig, \
    solo_reference
from raft_tpu_torch.testing import assert_topk_close, faults

DIM, K, T = 8, 5, 60  # T: every wait's bound, seconds
REPO = Path(__file__).resolve().parents[1]


def _ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _spec(seed=1, rows=256, family="brute_force"):
    return {"family": family, "dim": DIM, "rows": rows, "seed": seed}


def _reconcile(fleet, sink=None):
    oc = fleet.stats.outcome_counts()
    assert oc["submitted"] == sum(v for k, v in oc.items()
                                  if k != "submitted"), f"silent loss: {oc}"
    if sink is not None:
        assert len(sink.by_kind("fleet")) == oc["submitted"]
    return oc


# ---------------------------------------------------------------- the wire


_HEADERS = [{"op": "search", "k": 5, "cid": 1 << 21, "trace_id": "ab12",
             "deadline_ms": 12.5, "nested": {"a": [1, 2]}},
            {"op": "health", "cid": (1 << 21) + 3},
            {"ok": False, "error_kind": "queue_full", "message": "é"}]
_ARRAYS = [(np.arange(10, dtype=np.float32).reshape(2, 5),
            np.arange(10, dtype=np.int64).reshape(2, 5) * 7),
           (), (np.empty((0, 4), np.float32),)]


@pytest.mark.parametrize("case", range(3))
def test_encode_message_bytes_equal_and_both_decoders_read_both(case):
    header, arrays = _HEADERS[case], _ARRAYS[case]
    mine = remote.encode_message(header, *arrays)
    theirs = jremote.encode_message(header, *arrays)
    assert mine == theirs
    for decode in (remote.decode_message, jremote.decode_message):
        for payload in (mine, theirs):
            got_h, got_a = decode(payload)
            assert {k: v for k, v in got_h.items() if k != "npy_lens"} \
                == header
            assert len(got_a) == len(arrays)
            for g, w in zip(got_a, arrays):
                assert isinstance(g, np.ndarray) and g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    assert remote.RPC_TAG == jremote.RPC_TAG
    assert remote.TRANSPORT_FAILURE_KINDS == jremote.TRANSPORT_FAILURE_KINDS


_ERRORS = ["DeadlineExceeded", "QueueFull", "Overloaded", "CircuitOpen",
           "EngineStopped", "BatchFailed", "ReplicaStarting",
           "NoReplicaAvailable"]


@pytest.mark.parametrize("name", _ERRORS)
def test_error_table_equal_raft_tpus(name):
    mine = remote.encode_error(getattr(serving, name)("m"))
    theirs = jremote.encode_error(getattr(jserving, name)("m"))
    assert mine == theirs
    # each side rebuilds the other's wire fields as its own typed class
    assert type(remote.decode_error(theirs)).__name__ == \
        type(jremote.decode_error(mine)).__name__
    out = remote.decode_error({"error_kind": "???", "error_type": "Weird",
                               "message": "m"})
    assert isinstance(out, serving.BatchFailed) and serving.is_retryable(out)


def _transport_cases(peer_drained):
    refused = ConnectionRefusedError(111, "refused")
    poisoned = ConnectionError("send stream poisoned")
    poisoned.__cause__ = refused
    a, b = ConnectionError("a"), ConnectionError("b")
    a.__cause__, b.__cause__ = b, a  # a cycle must not hang the walker
    return [peer_drained("bye"), refused, poisoned,
            OSError(errno.EHOSTUNREACH, "unreachable"),
            TimeoutError("no reply"), ConnectionResetError("rst"),
            OSError("generic"), RuntimeError("?"), a]


def test_classify_and_map_transport_equal_raft_tpus():
    mine = _transport_cases(tp2p.PeerDrained)
    theirs = _transport_cases(jp2p.PeerDrained)
    kinds = [remote.classify_transport(e) for e in mine]
    assert kinds == [jremote.classify_transport(e) for e in theirs]
    assert kinds == ["drained", "refused", "refused", "refused",
                     "reply_timeout", "eof", "eof", "other", "eof"]
    for m, t in zip(mine, theirs):
        out = remote.map_transport_error(m, "r1")
        want = jremote.map_transport_error(t, "r1")
        assert type(out).__name__ == type(want).__name__
        assert out.__cause__ is m and serving.is_retryable(out)


@pytest.mark.parametrize("family", ["brute_force", "ivf_flat"])
def test_build_searcher_draws_raft_tpus_rows(family):
    spec = _spec(seed=4, rows=300, family=family)
    s = tmain.build_searcher(spec, "cpu")
    assert (s.family, s.dim, s.device) == (family, DIM, torch.device("cpu"))
    rows = np.random.default_rng(4).standard_normal((300, DIM)).astype(
        np.float32)
    if family == "brute_force":
        j = jmain.build_searcher(spec)
        np.testing.assert_array_equal(s.index.dataset.numpy(),
                                      np.asarray(j.index.dataset))
        np.testing.assert_array_equal(s.index.dataset.numpy(), rows)
    else:
        assert s.index.n_rows == 300 and s.index.n_lists == 16
    with pytest.raises(ValueError, match="unknown searcher family"):
        tmain.build_searcher(_spec(family="hnsw"), "cpu")


# ------------------------------------------------------- loopback RPC path


@pytest.fixture()
def loopback():
    p0, p1 = _ports(2)
    peers = [("127.0.0.1", p0), ("127.0.0.1", p1)]
    eng = Engine(tmain.build_searcher(_spec(), "cpu"),
                 EngineConfig(max_batch=4, max_wait_us=1000)).start()
    ep1 = tp2p.HostP2P(rank=1, size=2, peers=peers, timeout=T,
                       peer_grace=0.5)
    server = tmain._ReplicaServer(eng, ep1, frontend=0)
    threading.Thread(target=server.run, daemon=True).start()
    ep0 = tp2p.HostP2P(rank=0, size=2, peers=peers, timeout=T,
                       peer_grace=0.5)
    proxy = remote.RemoteReplica(ep0, peer=1, dim=DIM, name="r1",
                                 rpc_timeout_s=10.0, rpc_slack_s=1.0).start()
    yield eng, server, proxy, ep0, ep1
    proxy.stop(drain=False)
    server._stop.set()
    eng.stop(drain=False)
    ep0.close()
    ep1.close()


def test_loopback_search_bitwise(loopback):
    eng, _, proxy, *_ = loopback
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.standard_normal(DIM).astype(np.float32)
        fut = proxy.submit(q, K, deadline_ms=5000)
        d, i = fut.result(timeout=T)
        assert isinstance(d, np.ndarray) and isinstance(i, np.ndarray)
        d2, i2 = eng.submit(q, K).result(timeout=T)
        assert np.array_equal(d.view(np.int32), d2.view(np.int32))
        assert np.array_equal(i, i2)
        ref_d, ref_i = solo_reference(eng.searcher, q, K, *fut.placement)
        assert np.array_equal(d, ref_d) and np.array_equal(i, ref_i)


def test_loopback_deadline_rides_the_wire(loopback):
    _, _, proxy, *_ = loopback
    with pytest.raises(serving.DeadlineExceeded):
        proxy.submit(np.zeros(DIM, np.float32), K,
                     deadline_ms=0.01).result(timeout=T)


def test_loopback_health_piggyback_scrape_and_reset(loopback):
    _, _, proxy, *_ = loopback
    rng = np.random.default_rng(3)
    for _ in range(8):
        proxy.submit(rng.standard_normal(DIM).astype(np.float32), K,
                     deadline_ms=5000).result(timeout=T)
    h = proxy.health()
    assert h["link"] == "up" and h["replica"] == "r1"
    assert h["status"] in ("ok", "degraded")
    assert proxy.stats.queue_wait_p99_window_s() > 0.0
    text = proxy.scrape(timeout=T)
    assert "raft_tpu_serving_requests_total" in text
    assert "raft_tpu_kernel_build_total" in text
    assert proxy.reset_samples(timeout=T) is True
    proxy.scrape(timeout=T)  # any reply refreshes the piggyback
    assert proxy.stats.queue_wait_p99_window_s() == 0.0
    assert proxy.stats.queue_wait_p99_s() > 0.0


def test_loopback_graceful_stop_maps_to_engine_stopped(loopback):
    _, _, proxy, *_ = loopback
    q = np.zeros(DIM, np.float32)
    proxy.submit(q, K, deadline_ms=5000).result(timeout=T)
    proxy.stop(drain=True)
    with pytest.raises(serving.EngineStopped):
        proxy.submit(q, K)


def test_fleet_scrape_target_appends_p2p_and_routes_replicas(loopback):
    _, _, proxy, *_ = loopback
    local = Engine(tmain.build_searcher(_spec(), "cpu"),
                   EngineConfig(max_batch=4, max_wait_us=1000))
    fleet = serving.Fleet([local, proxy], names=["local0", "r1"],
                          config=serving.FleetConfig(
                              quorum=1, registry=obs_metrics.Registry()))
    try:
        fleet.start()
        fleet.submit(np.zeros(DIM, np.float32), K).result(timeout=T)
        url = f"http://127.0.0.1:{fleet.serve_metrics(port=0).port}"
        body = urllib.request.urlopen(f"{url}/metrics",
                                      timeout=T).read().decode()
        assert "raft_tpu_fleet_requests_total" in body
        assert "raft_tpu_p2p_messages_sent_total" in body
        assert body.count("# TYPE raft_tpu_fleet_requests_total") == 1
        body = urllib.request.urlopen(f"{url}/metrics/replica/r1",
                                      timeout=T).read().decode()
        assert "raft_tpu_serving_requests_total" in body
        for bad in ("/metrics/replica/ghost", "/metrics/replica/local0"):
            with pytest.raises(urllib.error.HTTPError) as got:
                urllib.request.urlopen(f"{url}{bad}", timeout=T)
            assert got.value.code == 404
    finally:
        fleet.stop(drain=False)


def test_partition_split_brain_and_heal_readmission():
    p0, p1 = _ports(2)
    peers = [("127.0.0.1", p0), ("127.0.0.1", p1)]
    eng_r = Engine(tmain.build_searcher(_spec(), "cpu"),
                   EngineConfig(max_batch=4, max_wait_us=1000)).start()
    ep1 = tp2p.HostP2P(rank=1, size=2, peers=peers, timeout=T,
                       peer_grace=0.5)
    server = tmain._ReplicaServer(eng_r, ep1, frontend=0)
    threading.Thread(target=server.run, daemon=True).start()
    ep0 = tp2p.HostP2P(rank=0, size=2, peers=peers, timeout=T,
                       peer_grace=0.5)
    proxy = remote.RemoteReplica(ep0, peer=1, dim=DIM, name="remote1",
                                 rpc_timeout_s=3.0, rpc_slack_s=0.5)
    eng_l = Engine(tmain.build_searcher(_spec(), "cpu"),
                   EngineConfig(max_batch=4, max_wait_us=1000))
    sink = ListSink()
    fleet = serving.Fleet([eng_l, proxy], names=["local0", "remote1"],
                          config=serving.FleetConfig(
                              quorum=1, span_sink=sink,
                              probe_interval_s=0.2))
    rng = np.random.default_rng(0)
    qs = [rng.standard_normal(DIM).astype(np.float32) for _ in range(20)]
    try:
        fleet.start()
        for q in qs[:5]:
            fleet.submit(q, K).result(timeout=T)
        heal = faults.partition_hosts(ep0, 1)  # one-sided: split brain
        for f in [fleet.submit(q, K) for q in qs]:
            assert f.exception(timeout=T) is None, f.exception()
        deadline = time.monotonic() + T
        while proxy.health()["link"] == "up" and time.monotonic() < deadline:
            fleet.submit(qs[0], K).result(timeout=T)
            time.sleep(0.05)
        h = proxy.health()
        assert (h["status"], h["breaker"], h["link"], h["running"]) == \
            ("unhealthy", "open", "down", True)
        assert eng_r.health()["status"] == "ok"  # its own word, overruled
        assert fleet.healthy_count() == 1
        _reconcile(fleet, sink)
        heal()
        deadline = time.monotonic() + T
        while proxy.health()["link"] != "up" and time.monotonic() < deadline:
            for q in qs[:4]:
                fleet.submit(q, K).result(timeout=T)
            time.sleep(0.1)
        assert proxy.health()["link"] == "up", "the heal never re-admitted"
        assert fleet.healthy_count() == 2
        _reconcile(fleet, sink)
    finally:
        fleet.stop(drain=False)
        server._stop.set()
        eng_r.stop(drain=False)
        ep0.close()
        ep1.close()


# ----------------------------------------------------------- the children


def _start_child(package, rank, size, peers, spec, extra=(), env=None):
    """A ``replica_main`` child of ``package``; returns (Popen, lines) once
    it printed REPLICA_READY, or (Popen, lines) with the process ended."""
    cmd = [sys.executable, "-m", f"{package}.serving.replica_main",
           "--rank", str(rank), "--size", str(size),
           "--peers", ",".join(f"{h}:{p}" for h, p in peers),
           "--family", spec["family"], "--dim", str(spec["dim"]),
           "--rows", str(spec["rows"]), "--seed", str(spec["seed"]),
           "--max-batch", "4", "--max-wait-us", "1000",
           "--peer-grace", "0.5", *extra]
    child = subprocess.Popen(cmd, cwd=str(REPO), env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True)
    lines: "queue.Queue[str]" = queue.Queue()

    def pump():
        for line in child.stdout:
            lines.put(line)
        lines.put("")

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            continue
        if line.startswith("REPLICA_READY"):
            return child, True
        if line == "":
            break
    return child, False


def _child(package, spec, extra=(), env=None):
    """(child, peers): a ready child at rank 1 of 2; one retry with fresh
    ports if the first could not bind."""
    for _ in range(2):
        peers = [("127.0.0.1", p) for p in _ports(2)]
        child, ready = _start_child(package, 1, 2, peers, spec, extra, env)
        if ready:
            return child, peers
        child.kill()
        child.wait(T)
    raise AssertionError(f"{package} replica never printed REPLICA_READY")


def _reap(child):
    try:
        child.kill()
    except OSError:
        pass
    child.wait(T)


def _queries(n, seed):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)


def _both_brute_forces(spec, q):
    rows = np.random.default_rng(spec["seed"]).standard_normal(
        (spec["rows"], DIM)).astype(np.float32)
    t = tbf.search(tbf.build(rows, device="cpu"), q, K)
    jd, ji = jbf.search(jbf.build(rows), q, K)
    scale = float((rows ** 2).sum(1).max())
    return t, (torch.from_numpy(np.array(jd)),
               torch.from_numpy(np.array(ji))), scale


@pytest.mark.parametrize("direction", ["port_proxy_raft_tpu_child",
                                       "raft_tpu_proxy_port_child"])
def test_replicas_across_packages(direction):
    spec = _spec(seed=2, rows=512)
    q = _queries(12, 5)
    if direction == "port_proxy_raft_tpu_child":
        child, peers = _child("raft_tpu", spec,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"))
        p2p, rem, pkg = tp2p, remote, serving
    else:
        child, peers = _child("raft_tpu_torch", spec, ("--device", "cpu"))
        p2p, rem, pkg = jp2p, jremote, jserving
    ep = p2p.HostP2P(rank=0, size=2, peers=peers, timeout=T, peer_grace=0.5)
    proxy = rem.RemoteReplica(ep, peer=1, dim=DIM, name="x1",
                              rpc_timeout_s=T).start()
    try:
        got = [proxy.submit(row, K, deadline_ms=30_000).result(timeout=T)
               for row in q]
        for d, i in got:  # numpy in, numpy out
            assert isinstance(d, np.ndarray) and d.dtype == np.float32
            assert isinstance(i, np.ndarray) and i.shape == (K,)
        assert proxy.health()["link"] == "up"
        assert "raft_tpu_serving_requests_total" in proxy.scrape(timeout=T)
        with pytest.raises(pkg.DeadlineExceeded):
            proxy.submit(q[0], K, deadline_ms=0.01).result(timeout=T)
        proxy.stop(drain=True)  # the stop op's drain handshake
        assert child.wait(T) == 0
    finally:
        ep.close()
        _reap(child)
    mine, theirs, scale = _both_brute_forces(spec, q)
    served = (torch.from_numpy(np.stack([d for d, _ in got])),
              torch.from_numpy(np.stack([i for _, i in got]).astype(
                  np.int64)))
    for want, name in ((mine, "port"), (theirs, "raft_tpu")):
        assert_topk_close(served, (want[0], want[1].to(torch.int64)),
                          1e-4 * scale, 1e-5, f"{direction} vs {name}")


def test_kill9_port_child_exact_typed_accounting():
    spec = _spec(seed=1, rows=256)
    child, peers = _child("raft_tpu_torch", spec, ("--device", "cpu"))
    fleet = ep0 = None
    try:
        ep0 = tp2p.HostP2P(rank=0, size=2, peers=peers, timeout=T,
                           peer_grace=0.5)
        proxy = remote.RemoteReplica(ep0, peer=1, dim=DIM, name="remote1",
                                     rpc_timeout_s=5.0, rpc_slack_s=0.5)
        local = Engine(tmain.build_searcher(spec, "cpu"),
                       EngineConfig(max_batch=4, max_wait_us=1000))
        sink = ListSink()
        fleet = serving.Fleet([local, proxy], names=["local0", "remote1"],
                              config=serving.FleetConfig(
                                  quorum=1, span_sink=sink,
                                  probe_interval_s=0.5))
        fleet.start()
        qs = _queries(40, 0)
        for q in qs[:5]:  # real cross-process searches, bitwise local
            fut = proxy.submit(q, K)
            d, i = fut.result(timeout=T)
            ref_d, ref_i = solo_reference(local.searcher, q, K,
                                          *fut.placement)
            assert np.array_equal(d, ref_d) and np.array_equal(i, ref_i)
        for q in qs[:5]:
            fleet.submit(q, K).result(timeout=T)
        futs = []
        for n, q in enumerate(qs):
            futs.append(fleet.submit(q, K))
            if n == 10:
                os.kill(child.pid, signal.SIGKILL)
        for f in futs:
            exc = f.exception(timeout=T)
            if exc is not None:
                assert isinstance(exc, (serving.BatchFailed,
                                        serving.Overloaded,
                                        serving.EngineStopped,
                                        serving.DeadlineExceeded)), exc
        oc = _reconcile(fleet, sink)
        assert oc["submitted"] == 45
        assert child.wait(T) == -signal.SIGKILL
    finally:
        if fleet is not None:
            fleet.stop(drain=False)
        if ep0 is not None:
            ep0.close()
        _reap(child)


def test_replica_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    peers = [("127.0.0.1", p) for p in _ports(2)]
    out = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.serving.replica_main",
         "--rank", "1", "--size", "2",
         "--peers", ",".join(f"{h}:{p}" for h, p in peers)],
        cwd=str(REPO), capture_output=True, text=True, timeout=T)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert "REPLICA_READY" not in out.stdout


# ------------------------------------------------------------ autoscaler


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


class _StubStats:
    def __init__(self):
        self.p99 = 0.0

    def queue_wait_p99_s(self):
        return self.p99


class _StubEngine:
    """Engine-shaped stub with a settable queue-wait p99."""

    def __init__(self, dim=DIM):
        self.searcher = types.SimpleNamespace(dim=dim, coverage=1.0)
        self.batcher = []
        self.stats = _StubStats()
        self.autoscale_budget_ms = 50.0
        self._started = True

    def start(self):
        self._started = True
        return self

    def stop(self, drain=True, timeout=None):
        self._started = False

    def drain(self, timeout=None):
        return True

    def health(self):
        return {"status": "ok" if self._started else "unhealthy",
                "running": self._started, "breaker": "closed",
                "shedding": False, "queue_depth": 0, "coverage": 1.0,
                "n_batch_errors": 0, "n_hangs": 0}


def _script(pkg, asc_cls, cfg_cls, sink_cls):
    """The autoscaler decision script of the reference's tests, on one
    fake clock: returns every span and the lifecycle counts."""
    out = []

    def pressure(fleet, p99):
        for r in fleet.replicas:
            r.engine.stats.p99 = p99

    def lifecycle(fleet):
        return {ev: int(c.value) for ev, c in fleet.stats._lifecycle.items()}

    def clean(spans):
        return [{k: v for k, v in s.items() if k != "fleet"} for s in spans]

    # hysteresis: sustained window, re-arm, max, the full cooldown
    clk, sink = _FakeClock(), sink_cls()
    fleet = pkg.Fleet([_StubEngine()], names=["seed0"],
                      config=pkg.FleetConfig(quorum=1), clock=clk)
    fleet._started = True
    asc = asc_cls(fleet, spawn=_StubEngine,
                  config=cfg_cls(min_replicas=1, max_replicas=3,
                                 high_watermark=0.8, low_watermark=0.2,
                                 up_window_s=5.0, down_window_s=30.0,
                                 span_sink=sink), clock=clk)
    for p99, dt in ((0.060, 0.0), (0.060, 2.0), (0.060, 3.5), (0.060, 0.0),
                    (0.060, 5.5), (0.060, 0.0), (0.060, 6.0), (0.001, 0.0),
                    (0.001, 10.0), (0.001, 25.0), (0.012, 1.0),
                    (0.001, 31.0), (0.001, 31.0)):
        pressure(fleet, p99)
        clk.advance(dt)
        asc.tick()
        out.append([r.name for r in fleet.replicas])
    out.append((clean(sink.by_kind("autoscale")), lifecycle(fleet)))
    # fast burn: no window
    clk, sink = _FakeClock(), sink_cls()
    fleet = pkg.Fleet([_StubEngine()], names=["seed0"],
                      config=pkg.FleetConfig(quorum=1), clock=clk)
    fleet._started = True
    asc = asc_cls(fleet, spawn=_StubEngine,
                  config=cfg_cls(span_sink=sink), clock=clk)
    pressure(fleet, 0.060)
    asc.on_fast_burn("availability", 20.0)
    asc.tick()

    def bad_spawn():
        raise RuntimeError("container pull failed")

    asc.spawn = bad_spawn
    asc.on_fast_burn("availability", 30.0)
    asc.tick()
    out.append((clean(sink.by_kind("autoscale")), lifecycle(fleet)))
    # a retire the quorum refuses
    clk, sink = _FakeClock(), sink_cls()
    fleet = pkg.Fleet([_StubEngine(), _StubEngine()],
                      names=["seed0", "scale1"],
                      config=pkg.FleetConfig(quorum=2), clock=clk)
    fleet._started = True
    asc = asc_cls(fleet, spawn=_StubEngine,
                  config=cfg_cls(min_replicas=1, max_replicas=3,
                                 down_window_s=30.0, span_sink=sink),
                  clock=clk)
    pressure(fleet, 0.001)
    asc.tick()
    clk.advance(31.0)
    asc.tick()
    out.append((clean(sink.by_kind("autoscale")), lifecycle(fleet),
                [r.name for r in fleet.replicas]))
    return out


def test_autoscaler_decisions_equal_raft_tpus():
    from raft_tpu.obs.spans import ListSink as JListSink

    mine = _script(serving, Autoscaler, AutoscalerConfig, ListSink)
    theirs = _script(jserving, JAutoscaler, JAutoscalerConfig, JListSink)
    assert mine == theirs
    spans, counts = mine[13]
    reasons = [s["reason"] for s in spans]
    assert reasons == ["scale_up_pressure", "scale_up_pressure",
                       "blocked_max_replicas", "scale_down_idle",
                       "scale_down_idle"]
    assert counts["spawned"] == counts["added"] == 2
    assert counts["retired"] == counts["removed"] == 2
    assert [s["reason"] for s in mine[14][0]] == ["scale_up_fast_burn",
                                                  "spawn_failed"]
    assert mine[14][1]["spawn_failed"] == 1
    assert mine[15][0][-1]["reason"] == "blocked_quorum"


def test_fleet_add_remove_replica_lifecycle():
    fleet = serving.Fleet([_StubEngine()], names=["seed0"],
                          config=serving.FleetConfig(quorum=1))
    fleet._started = True
    rep = fleet.add_replica(_StubEngine(), name="scale1")
    assert rep.name == "scale1" and len(fleet.replicas) == 2
    with pytest.raises(ValueError):
        fleet.add_replica(_StubEngine(), name="scale1")
    with pytest.raises(ValueError, match="dim"):
        fleet.add_replica(_StubEngine(dim=DIM + 1), name="scale2")
    eng = fleet.remove_replica("scale1", drain=True)
    assert len(fleet.replicas) == 1 and not eng._started
    with pytest.raises(serving.FleetBelowQuorum):
        fleet.remove_replica("seed0")
    with pytest.raises(KeyError):
        fleet.remove_replica("ghost")
    lc = fleet.stats._lifecycle
    assert lc["added"].value == 1 and lc["removed"].value == 1
