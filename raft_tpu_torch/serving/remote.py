"""Remote replica proxy: the Engine surface over the host_p2p fabric.

A copy of ``raft_tpu.serving.remote`` over the port's engine and typed failures.

The fleet (docs/serving.md "Fleet") proved routing, typed-failure
sibling retries, and quorum math over *in-process* replicas. This
module promotes one replica slot to a separate PROCESS (usually a
separate host): :class:`RemoteReplica` satisfies the narrow Engine
surface the router and fleet actually touch — ``submit`` / ``health`` /
``stats`` / ``drain`` / ``stop`` / ``swap_index`` plus the ``searcher``
/ ``batcher`` score inputs — by speaking a length-prefixed
request/response protocol to a :mod:`raft_tpu_torch.serving.replica_main`
child over :class:`~raft_tpu_torch.parallel.host_p2p.HostP2P`.

Wire protocol (one frame per message, riding host_p2p's framing):

- Every request carries a **correlation id** allocated from the
  endpoint's reserved tag range (``HostP2P.correlation_id``); the
  client posts ``irecv(source=peer, tag=cid)`` *before* sending, so the
  reply can match nothing else and host_p2p's at-least-once delivery is
  dedup'd for free (a duplicated reply lands in an inbox the client
  ``discard()``s).
- A message is ``json-header \\x00 npy-blocks``: the header is a flat
  JSON dict (op, cid, k, deadline_ms, trace_id, error fields); binary
  arrays (the query; distances + indices) ride as concatenated ``.npy``
  blocks after the NUL, never through JSON (bit-identity is part of the
  fleet contract).
- A port replica's search reply also carries ``placement`` (the row and
  bucket of the batch that served it), which the proxy sets on the
  future as a local engine does; a raft_tpu peer ignores the key, and
  without it the future has no placement.
- The per-request deadline rides the wire as the REMAINING budget at
  send time; the replica's engine enforces it from its own clock
  (``Engine.submit(deadline_ms=...)``), so queueing on the far side
  sheds typed ``DeadlineExceeded`` exactly like a local replica.

Every transport failure maps into the existing closed retryability
table (serving/router.py) — never a new untyped failure mode:

=============================  ==========================================
transport evidence             typed mapping
=============================  ==========================================
connect refused (spawn/crash   :class:`~raft_tpu_torch.serving.router.
window — nothing listening)    ReplicaStarting` (retryable; subclass of
                               ``Overloaded``)
peer-death verdict / EOF or    :class:`~raft_tpu_torch.serving.engine.
reset mid-request / reply      BatchFailed` with the transport error
deadline missed                chained on ``__cause__`` (retryable)
graceful drain announcement    :class:`~raft_tpu_torch.serving.batcher.
(``PeerDrained``)              EngineStopped` (retryable — the replica
                               retired on purpose)
request deadline already       :class:`~raft_tpu_torch.serving.batcher.
spent client-side              DeadlineExceeded` (NOT retryable — the
                               rider's budget is gone)
=============================  ==========================================

**Split-brain authority rule** (docs/serving.md "Remote fleet"): the
router's health verdict — computed HERE, from link state — is
authoritative for rotation and quorum, never the replica's self-report.
A partitioned replica may be alive and telling itself ``"ok"``; this
proxy reports it ``"unhealthy"`` with ``breaker="open"`` the moment its
RPCs start failing, which (a) removes it from ``healthy_count`` so
quorum is never double-counted across a partition, and (b) drops it
into the router's existing breaker-probe path: one live request per
``probe_interval_s`` crosses the link, and the first one that succeeds
after the partition heals re-admits the replica — no new re-admission
machinery.

Thread discipline: the proxy's single lock
guards only the pending-RPC table and the cached health/stats dicts —
a leaf lock, never held across an endpoint call or a future
settlement. One pump thread per proxy settles replies/timeouts; futures
settle outside the lock.
"""

from __future__ import annotations

import io
import json
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from raft_tpu_torch.core import logger
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.parallel.host_p2p import HostP2P, PeerDrained
from raft_tpu_torch.serving.batcher import (DeadlineExceeded, EngineStopped,
                                      QueueFull)
from raft_tpu_torch.serving.engine import BatchFailed, CircuitOpen, Overloaded
from raft_tpu_torch.serving.router import ReplicaStarting

__all__ = ["RemoteReplica", "encode_message", "decode_message",
           "RPC_TAG", "TRANSPORT_FAILURE_KINDS"]

#: the one user-range tag requests ride (replies ride their correlation
#: id, which lives in the reserved range and cannot collide)
RPC_TAG = 17

#: closed vocabulary for the transport-failure counter
TRANSPORT_FAILURE_KINDS = ("refused", "drained", "peer_death", "eof",
                           "reply_timeout", "endpoint_closed", "other")

_LINK_STATE = obs_metrics.REGISTRY.gauge(
    "raft_tpu_fleet_link_state",
    "Proxy link verdict per remote replica: 1 up, 0 down — the "
    "authoritative health input for rotation (split-brain rule).",
    ("replica",))
_TRANSPORT_FAILURES = obs_metrics.REGISTRY.counter(
    "raft_tpu_fleet_transport_failures_total",
    "Remote-replica RPC transport failures by typed kind.",
    ("replica", "kind"))


# ------------------------------------------------------------ wire format
def encode_message(header: dict, *arrays: np.ndarray) -> bytes:
    """``json \\x00 npy*`` — the header gains ``npy_lens`` so the
    receiver can split the concatenated blocks without parsing npy."""
    blocks = []
    for a in arrays:
        buf = io.BytesIO()
        np.save(buf, np.asarray(a), allow_pickle=False)
        blocks.append(buf.getvalue())
    header = dict(header)
    header["npy_lens"] = [len(b) for b in blocks]
    return (json.dumps(header, sort_keys=True).encode()
            + b"\x00" + b"".join(blocks))


def decode_message(payload: bytes):
    """→ (header dict, [ndarray, ...])."""
    head, _, rest = payload.partition(b"\x00")
    header = json.loads(head.decode())
    arrays = []
    off = 0
    for n in header.get("npy_lens", ()):
        arrays.append(np.load(io.BytesIO(rest[off:off + n]),
                              allow_pickle=False))
        off += n
    return header, arrays


#: closed error-kind vocabulary the replica side encodes failures with;
#: the proxy reconstructs the SAME typed class so the fleet's
#: retryability table sees no difference from a local replica
_KIND_TO_EXC = {
    "deadline": DeadlineExceeded,
    "queue_full": QueueFull,
    "overloaded": Overloaded,
    "circuit_open": CircuitOpen,
    "engine_stopped": EngineStopped,
    "batch_failed": BatchFailed,
}


def encode_error(exc: BaseException) -> dict:
    """Server side: one typed engine failure → wire fields."""
    from raft_tpu_torch.serving.router import failure_kind
    return {"ok": False, "error_kind": failure_kind(exc),
            "error_type": type(exc).__name__, "message": str(exc)}


def decode_error(header: dict) -> BaseException:
    """Proxy side: wire fields → the same typed class (closed table;
    unknown kinds become ``BatchFailed`` — still typed, still
    retryable, never silently dropped)."""
    kind = header.get("error_kind", "other")
    cls = _KIND_TO_EXC.get(kind, BatchFailed)
    return cls(f"remote replica: [{header.get('error_type', '?')}] "
               f"{header.get('message', '')}")


def classify_transport(exc: BaseException) -> str:
    """Transport failure → closed kind, by isinstance over the exception
    CHAIN (a poisoned-stream ConnectionError carries the original
    refused/reset error on ``__cause__``) — never by message
    matching."""
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, PeerDrained):
            return "drained"
        if isinstance(e, ConnectionRefusedError):
            return "refused"
        if isinstance(e, OSError) and getattr(e, "errno", None) in (
                111, 113):  # ECONNREFUSED, EHOSTUNREACH
            return "refused"
        e = e.__cause__
    if isinstance(exc, TimeoutError):
        return "reply_timeout"
    if isinstance(exc, ConnectionError):
        return "eof"
    if isinstance(exc, OSError):
        return "eof"
    return "other"


def map_transport_error(exc: BaseException, peer: str) -> BaseException:
    """Transport failure → the fleet's typed hierarchy (module
    docstring table). The original error always rides ``__cause__``."""
    kind = classify_transport(exc)
    if kind == "refused":
        out: BaseException = ReplicaStarting(
            f"remote replica {peer}: connection refused — process "
            f"spawning or restarting")
    elif kind == "drained":
        out = EngineStopped(
            f"remote replica {peer} drained gracefully")
    else:
        out = BatchFailed(
            f"remote replica {peer}: transport failure ({kind})",
            cause=exc)
    out.__cause__ = exc
    return out


# --------------------------------------------------------------- the proxy
class _RemoteSearcher:
    """Static searcher facts the fleet reads at construction (``dim``)
    and scoring time; refreshed from the replica's hello/health
    piggyback."""

    __slots__ = ("family", "dim", "query_dtype", "coverage")

    def __init__(self, dim: int, query_dtype=np.float32,
                 coverage: float = 1.0, family: str = "remote"):
        self.family = family
        self.dim = int(dim)
        self.query_dtype = np.dtype(query_dtype)
        self.coverage = float(coverage)


class _RemoteQueueView:
    """``len(engine.batcher)`` for the router's score: the last
    queue_depth the replica piggybacked on a reply."""

    def __init__(self, proxy: "RemoteReplica"):
        self._proxy = proxy

    def __len__(self) -> int:
        return int(self._proxy._cached.get("queue_depth", 0))


class _RemoteStatsView:
    """``engine.stats.queue_wait_p99_s()`` for the router's pressure
    term, from the same piggyback. ``queue_wait_p99_window_s`` mirrors
    the local windowed signal (the autoscale numerator): the replica
    piggybacks its own windowed value, and ``reset_samples()`` forwards
    the re-baseline over the wire so a load generator can scope windows
    uniformly across local and remote replicas."""

    def __init__(self, proxy: "RemoteReplica"):
        self._proxy = proxy

    def queue_wait_p99_s(self) -> float:
        return float(self._proxy._cached.get("queue_wait_p99_s", 0.0))

    def queue_wait_p99_window_s(self) -> float:
        cached = self._proxy._cached
        return float(cached.get("queue_wait_p99_window_s",
                                cached.get("queue_wait_p99_s", 0.0)))

    def reset_samples(self) -> None:
        self._proxy.reset_samples()


class _PendingRpc:
    """One in-flight request/response pair (no lock of its own — owned
    by the proxy's pending table, settled exactly once by the pump)."""

    __slots__ = ("cid", "op", "send_req", "recv_req", "future",
                 "t_fail", "t_deadline")

    def __init__(self, cid, op, send_req, recv_req, future, t_fail,
                 t_deadline=None):
        self.cid = cid
        self.op = op
        self.send_req = send_req
        self.recv_req = recv_req
        self.future = future
        self.t_fail = t_fail          # clock time to give up waiting
        self.t_deadline = t_deadline  # rider deadline (search ops)


class RemoteReplica:
    """Engine-shaped proxy for one replica process reachable over
    ``endpoint`` at rank ``peer`` (module docstring for the protocol
    and failure mapping). Drop it into ``Fleet([...])`` exactly like a
    local Engine.

    ``dim`` (and optionally ``query_dtype``) must be supplied up front
    — the fleet validates replica dims at construction, before the
    child may even be listening; the hello reply cross-checks it.

    ``rpc_slack_s`` bounds how long past the rider's deadline the proxy
    waits for a reply before writing the request off as a transport
    casualty (typed ``BatchFailed``); ``health_ttl_s`` bounds health
    staleness: ``health()`` never blocks (the router calls it on the
    hot path) — it serves the cache and triggers an async refresh.
    """

    def __init__(self, endpoint: HostP2P, peer: int, dim: int,
                 name: Optional[str] = None, query_dtype=np.float32,
                 rpc_timeout_s: float = 30.0, rpc_slack_s: float = 2.0,
                 health_ttl_s: float = 0.25,
                 autoscale_budget_ms: float = 50.0,
                 clock=time.monotonic):
        self._ep = endpoint
        self._peer = int(peer)
        self.name = name or f"remote{peer}"
        self.searcher = _RemoteSearcher(dim, query_dtype)
        self.batcher = _RemoteQueueView(self)
        self.stats = _RemoteStatsView(self)
        self.autoscale_budget_ms = float(autoscale_budget_ms)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.rpc_slack_s = float(rpc_slack_s)
        self.health_ttl_s = float(health_ttl_s)
        self.clock = clock
        self._lock = threading.Lock()  # LEAF: pending table + caches
        self._pending: dict = {}       # cid -> _PendingRpc, guarded_by: _lock
        self._cached: dict = {}        # last piggyback, guarded_by: _lock (reads tolerate staleness)
        self._link_ok = False          # guarded_by: _lock (monitor reads race-free enough)
        self._drained = False          # peer announced drain, guarded_by: _lock
        self._health_at = -1e9         # last health refresh, guarded_by: _lock
        self._health_inflight = False  # guarded_by: _lock
        self._started = False
        self._stopped = False
        self._pump_thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        _LINK_STATE.labels(self.name).set_function(
            lambda: 1.0 if self._link_ok else 0.0)
        self._fail_counters = {
            k: _TRANSPORT_FAILURES.labels(self.name, k)
            for k in TRANSPORT_FAILURE_KINDS}

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "RemoteReplica":
        """Idempotent; spins up the pump thread and fires the hello
        RPC (non-blocking — the child may still be spawning, which is
        exactly the :class:`ReplicaStarting` regime)."""
        if self._started:
            return self
        self._started = True  # guarded_by: atomic — rebind-only flag
        self._pump_thread = threading.Thread(  # guarded_by: atomic
            target=self._pump, daemon=True,
            name=f"raft-tpu-remote-pump-{self.name}")
        self._pump_thread.start()
        self._refresh_health()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Ask the replica process to stop its engine (and exit), then
        stop the proxy. Best-effort over a possibly-dead link — a child
        that is already gone is simply written off."""
        if self._stopped:
            return
        try:
            fut = self._rpc({"op": "stop", "drain": bool(drain)},
                            timeout_s=min(timeout or 5.0, 5.0))
            fut.result(timeout=min(timeout or 5.0, 5.0))
        except BaseException as e:
            # already dead / partitioned: nothing to stop, but say so
            logger.debug("remote replica %s: stop RPC not delivered "
                         "(%r) — writing the child off", self.name, e)
        self._stopped = True  # guarded_by: atomic — rebind-only flag
        self._wake.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=2.0)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Remote ``Engine.drain``: True once the replica's queue is
        empty (False on timeout or a dead link — the caller treats
        both as "not drained")."""
        budget = timeout if timeout is not None else self.rpc_timeout_s
        try:
            fut = self._rpc({"op": "drain", "timeout_s": budget},
                            timeout_s=budget + self.rpc_slack_s)
            return bool(fut.result(timeout=budget + self.rpc_slack_s))
        except BaseException:
            return False

    def swap_index(self, searcher_spec, warm: bool = True):
        """Remote hot swap: ships a *spec* (the dict
        ``replica_main.build_searcher`` understands — family/rows/seed
        ...), not a searcher object; the child rebuilds and swaps
        in-process. Returns a namespace carrying the displaced
        searcher's ``coverage`` (the object itself stays remote)."""
        spec = dict(searcher_spec)
        fut = self._rpc({"op": "swap", "spec": spec, "warm": bool(warm)},
                        timeout_s=self.rpc_timeout_s)
        out = fut.result(timeout=self.rpc_timeout_s)
        return _RemoteSearcher(self.searcher.dim,
                               self.searcher.query_dtype,
                               coverage=float(out.get("old_coverage", 1.0)))

    # -------------------------------------------------------------- submit
    def submit(self, query, k: int, block: bool = True,
               timeout: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Engine-shaped submit over the wire. The Future resolves to
        ``(distances [k], indices [k])`` or to one of the typed
        failures in the module-docstring table; it never resolves
        untyped. ``deadline_ms`` (the REMAINING budget — the fleet
        already subtracted elapsed time) rides the wire and is enforced
        by the remote engine; the proxy additionally writes the request
        off as a transport casualty ``rpc_slack_s`` past it."""
        if self._stopped or not self._started:
            raise EngineStopped(
                f"remote replica {self.name} proxy not running")
        q = np.asarray(query, self.searcher.query_dtype)
        if q.ndim == 2 and q.shape[0] == 1:
            q = q[0]
        if q.shape != (self.searcher.dim,):
            raise ValueError(
                f"query shape {q.shape} != ({self.searcher.dim},)")
        trace_id = obs_spans.new_trace_id()
        header = {"op": "search", "k": int(k), "trace_id": trace_id}
        if deadline_ms is not None:
            header["deadline_ms"] = float(deadline_ms)
        wait_s = (self.rpc_timeout_s if deadline_ms is None
                  else float(deadline_ms) * 1e-3 + self.rpc_slack_s)
        now = self.clock()
        fut = self._rpc(header, arrays=(q,), timeout_s=wait_s,
                        t_deadline=(None if deadline_ms is None
                                    else now + float(deadline_ms) * 1e-3))
        fut.trace_id = trace_id
        return fut

    # -------------------------------------------------------------- health
    def health(self) -> dict:
        """NEVER blocks (router hot path). Serves the cached verdict and
        triggers an async refresh when stale. The link verdict is
        authoritative (split-brain rule, module docstring): a down link
        reports ``unhealthy`` + ``breaker="open"`` regardless of the
        replica's own last words, which parks the replica in the
        router's probe path until a probe crosses the healed link."""
        with self._lock:
            link_ok = self._link_ok
            drained = self._drained
            cached = dict(self._cached)
            stale = (self.clock() - self._health_at) > self.health_ttl_s
        if stale and not self._stopped and self._started:
            self._refresh_health()
        if self._stopped or drained:
            return {"status": "unhealthy", "running": False,
                    "breaker": "closed", "shedding": False,
                    "queue_depth": 0, "coverage": 0.0,
                    "n_batch_errors": 0, "n_hangs": 0,
                    "link": "down" if not link_ok else "up",
                    "replica": self.name}
        if not link_ok:
            # the proxy's verdict, not the replica's self-report:
            # unreachable == out of rotation, probeable for re-admission
            return {"status": "unhealthy", "running": True,
                    "breaker": "open", "shedding": False,
                    "queue_depth": int(cached.get("queue_depth", 0)),
                    "coverage": float(cached.get("coverage", 0.0)),
                    "n_batch_errors": int(
                        cached.get("n_batch_errors", 0)),
                    "n_hangs": int(cached.get("n_hangs", 0)),
                    "link": "down", "replica": self.name}
        h = {"status": cached.get("status", "degraded"),
             "running": bool(cached.get("running", True)),
             "breaker": cached.get("breaker", "closed"),
             "shedding": bool(cached.get("shedding", False)),
             "queue_depth": int(cached.get("queue_depth", 0)),
             "coverage": float(cached.get("coverage", 1.0)),
             "n_batch_errors": int(cached.get("n_batch_errors", 0)),
             "n_hangs": int(cached.get("n_hangs", 0)),
             "link": "up", "replica": self.name}
        return h

    def _refresh_health(self) -> None:
        """Fire one async health RPC unless one is already in flight."""
        with self._lock:
            if self._health_inflight:
                return
            self._health_inflight = True
        try:
            self._rpc({"op": "health"}, timeout_s=self.rpc_timeout_s)
        except BaseException:
            with self._lock:
                self._health_inflight = False

    def scrape(self, timeout: Optional[float] = None) -> str:
        """The replica process's own Prometheus text (its engine
        families) — the fleet's one-target aggregation appends this to
        ``/metrics`` (docs/observability.md "Scrape endpoint")."""
        budget = timeout if timeout is not None else self.rpc_timeout_s
        fut = self._rpc({"op": "scrape"}, timeout_s=budget)
        return str(fut.result(timeout=budget))

    def reset_samples(self, timeout: Optional[float] = None) -> bool:
        """Forward ``ServingStats.reset_samples()`` over the wire so a
        load generator can re-baseline the remote latency window in the
        same sweep that re-baselines local replicas (the windowed p99
        it piggybacks back is the autoscale pressure numerator). Best
        effort: False on a dead link — a stale window on an unreachable
        replica is moot, its pressure is not read while out of
        rotation."""
        budget = timeout if timeout is not None else self.rpc_timeout_s
        try:
            fut = self._rpc({"op": "reset_samples"},
                            timeout_s=budget + self.rpc_slack_s)
            return bool(fut.result(timeout=budget + self.rpc_slack_s))
        except BaseException:
            return False

    # ------------------------------------------------------------ rpc core
    def _rpc(self, header: dict, arrays=(), timeout_s: float = 30.0,
             t_deadline: Optional[float] = None) -> Future:
        """Post one request/response pair; the pump settles the future.
        Raises nothing for transport conditions — they resolve the
        future typed."""
        cid = self._ep.correlation_id()
        header = dict(header, cid=cid)
        fut: Future = Future()
        now = self.clock()
        try:
            recv_req = self._ep.irecv(source=self._peer, tag=cid)
            # a poisoned stream (partition, earlier crash) would fail
            # every send without ever touching the network: reset it so
            # each fresh RPC genuinely re-attempts the link — this IS
            # the re-admission probe's transport half
            self._ep.reset_stream(self._peer)
            send_req = self._ep.isend(
                encode_message(header, *arrays), self._peer, tag=RPC_TAG)
        except BaseException as e:  # endpoint closed
            self._note_transport_failure(e)
            fut.set_exception(map_transport_error(e, self.name))
            return fut
        pend = _PendingRpc(cid, header["op"], send_req, recv_req, fut,
                           t_fail=now + timeout_s, t_deadline=t_deadline)
        with self._lock:
            self._pending[cid] = pend  # guarded_by: _lock
        self._wake.set()
        return fut

    def _pump(self) -> None:
        """One thread settles every reply/timeout for this proxy. Poll
        slices are short real sleeps; deadlines are computed on the
        injected clock (fake-clock chaos tests drive them)."""
        while not self._stopped:
            self._wake.wait(0.002)
            self._wake.clear()
            now = self.clock()
            with self._lock:
                pending = list(self._pending.values())
            for p in pending:
                self._poll_one(p, now)
        # proxy stopped: fail whatever is left, typed
        with self._lock:
            left, self._pending = list(self._pending.values()), {}
        for p in left:
            self._settle(p, error=EngineStopped(
                f"remote replica {self.name} proxy stopped"))

    def _poll_one(self, p: _PendingRpc, now: float) -> None:
        if p.recv_req.done():
            try:
                payload = p.recv_req.wait(0.0)
            except BaseException as e:
                self._note_transport_failure(e)
                self._settle(p, error=map_transport_error(e, self.name))
                return
            self._on_reply(p, payload)
            return
        if p.send_req.done():
            try:
                p.send_req.wait(0.0)
            except BaseException as e:
                self._note_transport_failure(e)
                self._settle(p, error=map_transport_error(e, self.name))
                return
        if now >= p.t_fail:
            err = TimeoutError(
                f"no reply from {self.name} within "
                f"{p.t_fail - (p.t_deadline or p.t_fail):+.3f}s slack")
            self._note_transport_failure(err)
            if p.t_deadline is not None and now >= p.t_deadline:
                # the rider's budget is spent either way: deadline wins
                # over a retryable transport write-off
                dl = DeadlineExceeded(
                    f"deadline spent awaiting reply from {self.name}")
                dl.__cause__ = err
                self._settle(p, error=dl)
            else:
                self._settle(p, error=map_transport_error(err, self.name))

    def _on_reply(self, p: _PendingRpc, payload) -> None:
        try:
            header, arrays = decode_message(bytes(payload))
        except BaseException as e:
            self._settle(p, error=BatchFailed(
                f"remote replica {self.name}: undecodable reply",
                cause=e))
            return
        self._absorb_piggyback(header)
        if not header.get("ok", False):
            self._settle(p, error=decode_error(header))
            return
        if p.op == "search":
            if len(arrays) != 2:
                self._settle(p, error=BatchFailed(
                    f"remote replica {self.name}: search reply carried "
                    f"{len(arrays)} arrays, want 2"))
                return
            placement = header.get("placement")
            if placement is not None:
                # the replica's (row, bucket): what solo_reference needs
                p.future.placement = (int(placement[0]), int(placement[1]))
            self._settle(p, result=(arrays[0], arrays[1]))
        elif p.op == "scrape":
            self._settle(p, result=header.get("text", ""))
        elif p.op == "drain":
            self._settle(p, result=bool(header.get("drained", False)))
        elif p.op == "reset_samples":
            self._settle(p, result=bool(header.get("reset", False)))
        elif p.op == "swap":
            self._settle(p, result=header)
        else:  # health / hello / stop acks resolve to the header
            self._settle(p, result=header)

    def _absorb_piggyback(self, header: dict) -> None:
        """Every reply refreshes the health/stats cache and the link
        verdict — under load the cache is as fresh as the traffic."""
        piggy = header.get("health")
        with self._lock:
            self._link_ok = True
            self._health_at = self.clock()
            self._health_inflight = False
            if piggy:
                self._cached.update(piggy)
            if header.get("draining"):
                self._drained = True  # guarded_by: _lock

    def _note_transport_failure(self, exc: BaseException) -> None:
        kind = classify_transport(exc)
        self._fail_counters.get(
            kind, self._fail_counters["other"]).inc()
        drained = kind == "drained"
        with self._lock:
            self._link_ok = False
            self._health_inflight = False
            if drained:
                self._drained = True
        if not drained:
            logger.warn(
                "remote replica %s: transport failure (%s): %r",
                self.name, kind, exc)

    def _settle(self, p: _PendingRpc, result=None,
                error: Optional[BaseException] = None) -> None:
        """Settle exactly once, outside the lock; drop the correlation's
        leftovers so a late duplicate reply cannot pool in the inbox."""
        with self._lock:
            if self._pending.pop(p.cid, None) is None:
                return  # already settled
        if not p.recv_req.done():
            p.recv_req._cancelled = True
        self._ep.discard(self._peer, p.cid)
        if error is not None:
            if not p.future.set_running_or_notify_cancel():
                return  # rider cancelled first
            p.future.set_exception(error)
        else:
            if not p.future.set_running_or_notify_cancel():
                return
            p.future.set_result(result)

    def __repr__(self) -> str:
        return (f"RemoteReplica({self.name!r}, peer={self._peer}, "
                f"link={'up' if self._link_ok else 'down'})")
