"""Multi-replica serving fabric: one frontend over N Engine replicas.

A copy of ``raft_tpu.serving.fleet`` over the port's
:class:`~raft_tpu_torch.serving.engine.Engine`. One engine is one point of
failure: a replica death, a hung breaker or an upgrade would drop the
whole service. The :class:`Fleet` closes that gap with only in-process
machinery:

- **Routing** — ``submit()``/``search()`` pick a replica by
  power-of-two-choices over queue depth, ``health()``, and autoscale
  pressure (:class:`~raft_tpu_torch.serving.router.Router`); unhealthy
  replicas are routed around and breaker-open ones re-admitted via
  rate-limited probes.
- **Typed-failure retries** — ``BatchFailed`` / ``Overloaded`` /
  ``CircuitOpen`` (and replica death: ``EngineStopped``) retry on a
  sibling with exponential backoff + full jitter under a per-request
  retry budget that honors the rider's ``remaining_ms``: a retry never
  resets the deadline, and when budget, deadline headroom, or siblings
  run out the request is shed with a typed outcome — never silently
  lost. Every submitted request resolves to exactly one of
  ok / typed shed / typed failure / cancelled.
- **Rolling upgrades** — :meth:`Fleet.rolling_swap` drains and swaps
  one replica at a time through the existing zero-drop
  ``swap_index``/degraded-restore flow, refusing to take the fleet
  below ``FleetConfig.quorum`` healthy replicas
  (:class:`~raft_tpu_torch.serving.router.FleetBelowQuorum`).
- **Telemetry** — one ``kind="fleet"`` span per request ties every
  retry and the final outcome under a single fleet trace id (each
  attempt records the replica and its engine-side trace id), and the
  ``raft_tpu_fleet_*`` metric family (docs/observability.md) carries
  per-replica routed/retried counters, typed shed/outcome counters,
  the quorum gauge pair, and live per-replica health states.
  ``serve_metrics`` exposes the whole fleet on ONE scrape target:
  ``/healthz`` returns 503 below quorum and 200 (status
  ``"degraded"``) while any replica is degraded.

On the card, the replicas of one process share the device: each
engine's dispatch thread launches on its own thread's current stream, so
their batches interleave on the card rather than run beside each other —
more replicas buy failure isolation and zero-drop upgrades, not device
throughput. A replica stopped with ``drain=False`` still settles every
batch already launched (its completion thread reads them back before it
exits); only queued riders fail typed and are retried on a sibling.

Retries are event-driven, not polled: the first attempt runs on
the caller's thread, completions arrive on the owning engine's
completion thread, and backoff waits are one-shot ``threading.Timer``
daemons — the fleet adds no standing threads of its own. The fleet
lock guards only the live-request set and replica admin states; it is
a leaf lock, never held across an engine call or a blocking call
(races hammered by the interleave amplifier in
tests/test_torch_fleet.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import List, Optional, Sequence, Tuple

from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.obs.httpd import MetricsServer
from raft_tpu_torch.serving.batcher import DeadlineExceeded, EngineStopped
from raft_tpu_torch.serving.engine import Engine, EngineConfig
from raft_tpu_torch.serving.router import (FAILURE_KINDS, FleetBelowQuorum,
                                     NoReplicaAvailable, RetriesExhausted,
                                     RetryPolicy, Router, failure_kind,
                                     is_retryable)
from raft_tpu_torch.serving.searchers import Searcher

__all__ = ["Fleet", "FleetConfig", "Replica"]

_fleet_seq = itertools.count()

#: closed outcome vocabulary — pre-touched on the request counter so a
#: scrape shows every shed class at 0 and the span<->counter
#: reconciliation can enumerate it (tools/serving_bench.py --fleet)
_FLEET_EVENTS = ("submitted", "ok", "failed", "cancelled", "stopped",
                 "shed_deadline", "shed_no_replica", "shed_retries")

#: admin states a replica moves through (writes hold the fleet lock)
_ADMIN_STATES = ("in_service", "draining")

#: closed vocabulary for raft_tpu_fleet_replica_lifecycle_total —
#: added/removed are the Fleet's own add_replica/remove_replica;
#: spawned/retired/spawn_failed are the autoscaler attributing its
#: actuations (serving/autoscaler.py), 1:1 with kind="autoscale" spans
_LIFECYCLE_EVENTS = ("added", "removed", "spawned", "retired",
                     "spawn_failed")


@dataclasses.dataclass
class FleetConfig:
    """Knobs for one fleet (docs/serving.md "Fleet" for tuning).

    ``quorum`` is the floor on *healthy in-service* replicas:
    ``rolling_swap`` refuses to drain below it and ``health()`` reports
    the whole fleet ``"unhealthy"`` (503 on ``/healthz``) under it.
    ``retry_limit`` / ``backoff_base_ms`` / ``backoff_cap_ms`` feed
    :class:`~raft_tpu_torch.serving.router.RetryPolicy`; ``probe_interval_s``
    rate-limits the live probes that re-admit a breaker-open replica.
    ``pressure_weight`` and ``degraded_penalty`` shape the router's
    load score (docs/serving.md for the math). ``seed`` makes the
    power-of-two draws and jitter deterministic under the interleave
    amplifier. Telemetry knobs mirror ``EngineConfig``: ``span_sink``
    receives the ``kind="fleet"`` records; ``registry`` overrides the
    process-global metrics registry; ``metrics_port`` starts the
    fleet-wide scrape endpoint on ``start()``.
    """

    quorum: int = 1
    retry_limit: int = 3
    backoff_base_ms: float = 1.0
    backoff_cap_ms: float = 50.0
    probe_interval_s: float = 1.0
    pressure_weight: float = 32.0
    degraded_penalty: float = 8.0
    seed: int = 0
    # ---- telemetry
    span_sink: Optional[object] = None
    registry: Optional[object] = None
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    fleet_label: Optional[str] = None


class Replica:
    """One engine slot in the fleet: a stable name, the engine, and the
    admin state the router consults (``"in_service"`` routes,
    ``"draining"`` — during a rolling swap — does not). Admin writes
    hold the owning fleet's lock; the router's reads tolerate one-swap
    staleness by design (a stale route is just a retry)."""

    __slots__ = ("name", "engine", "admin")

    def __init__(self, name: str, engine: Engine):
        self.name = name
        self.engine = engine
        self.admin = "in_service"

    def __repr__(self) -> str:
        return f"Replica({self.name!r}, admin={self.admin!r})"


class _FleetRequest:
    """Per-request retry state machine. Exactly one thread advances it
    at a time (caller thread → completion callback → backoff timer →
    ...), so the mutable fields need no lock; the single exception —
    ``Fleet.stop`` racing that thread to settle the future — is decided
    atomically by ``Future.set_result/set_exception`` plus the ``once``
    counter (``itertools.count`` is C-atomic), so every request is
    counted exactly once."""

    __slots__ = ("query", "k", "future", "trace_id", "t_submit",
                 "t_deadline", "retries", "tried", "attempts",
                 "last_error", "timer", "once")

    def __init__(self, query, k: int, trace_id: str, t_submit: float,
                 t_deadline: Optional[float]):
        self.query = query
        self.k = int(k)
        self.future: Future = Future()
        self.future.trace_id = trace_id
        self.trace_id = trace_id
        self.t_submit = t_submit
        self.t_deadline = t_deadline
        self.retries = 0
        self.tried: set = set()          # replica names that failed us
        self.attempts: List[dict] = []   # [{replica, trace|error}, ...]
        self.last_error: Optional[BaseException] = None
        self.timer: Optional[threading.Timer] = None
        self.once = itertools.count()    # first next() == 0 wins

    def remaining_ms(self, now: float) -> Optional[float]:
        """Budget left on the rider's ORIGINAL deadline (None = no
        deadline; may be negative). The same authority every retry
        consults — a retry never resets it."""
        if self.t_deadline is None:
            return None
        return (self.t_deadline - now) * 1e3


class _FleetStats:
    """``raft_tpu_fleet_*`` metric family for one fleet, on the shared
    registry (docs/observability.md "Metric catalog"). Counter children
    are pre-touched over closed vocabularies; the quorum/health gauges
    are ``set_function`` callbacks so a scrape always reads live
    state."""

    def __init__(self, fleet, registry: Optional[obs_metrics.Registry]):
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        r, f = self.registry, fleet.label
        self._fleet_label = f
        req = r.counter(
            "raft_tpu_fleet_requests_total",
            "Fleet requests by typed outcome event.", ("fleet", "event"))
        self._req = {ev: req.labels(f, ev) for ev in _FLEET_EVENTS}
        # family refs kept: add_replica() registers children for
        # replicas that join after construction (autoscale spawns)
        self._routed_family = r.counter(
            "raft_tpu_fleet_routed_total",
            "Requests accepted by a replica (per attempt).",
            ("fleet", "replica"))
        self._retried_family = r.counter(
            "raft_tpu_fleet_retries_total",
            "Retries scheduled after a typed per-replica failure.",
            ("fleet", "replica", "error"))
        names = [rep.name for rep in fleet.replicas]
        self._routed = {n: self._routed_family.labels(f, n)
                        for n in names}
        self._retried = {(n, e): self._retried_family.labels(f, n, e)
                         for n in names for e in FAILURE_KINDS}
        lifecycle = r.counter(
            "raft_tpu_fleet_replica_lifecycle_total",
            "Replica membership transitions by closed event vocabulary "
            "(added/removed by the Fleet, spawned/retired/spawn_failed "
            "attributed by the autoscaler, 1:1 with its spans).",
            ("fleet", "event"))
        self._lifecycle = {ev: lifecycle.labels(f, ev)
                           for ev in _LIFECYCLE_EVENTS}
        self._swaps = r.counter(
            "raft_tpu_fleet_rolling_swaps_total",
            "Replicas drained + swapped by rolling_swap.",
            ("fleet",)).labels(f)
        r.gauge(
            "raft_tpu_fleet_quorum_healthy",
            "Healthy (ok/degraded) in-service replicas right now.",
            ("fleet",)).labels(f).set_function(
                lambda: float(fleet.healthy_count()))
        r.gauge(
            "raft_tpu_fleet_quorum_threshold",
            "Configured quorum floor (rolling_swap refusal line).",
            ("fleet",)).labels(f).set(float(fleet.config.quorum))
        self._health_family = r.gauge(
            "raft_tpu_fleet_replica_health",
            "Replica health: 1 ok, 0.5 degraded, 0 unhealthy.",
            ("fleet", "replica"))
        for rep in fleet.replicas:
            self._bind_health(rep)

    def _bind_health(self, rep) -> None:
        self._health_family.labels(self._fleet_label,
                                   rep.name).set_function(
            lambda rep=rep: _HEALTH_VALUE.get(
                rep.engine.health()["status"], 0.0))

    def add_replica(self, rep) -> None:
        """Register counter children + the health gauge for a replica
        that joined after construction (idempotent for rejoin-by-name:
        the registry hands back the existing children, so counts
        survive a retire/respawn cycle under the same name)."""
        f = self._fleet_label
        self._routed.setdefault(
            rep.name, self._routed_family.labels(f, rep.name))
        for e in FAILURE_KINDS:
            self._retried.setdefault(
                (rep.name, e), self._retried_family.labels(f, rep.name, e))
        self._bind_health(rep)

    def remove_replica(self, name: str) -> None:
        """Pin the departed replica's health gauge at 0.0 (its engine
        reference must not outlive the membership — a scrape of a
        retired name reads a constant, not a stopped engine)."""
        self._health_family.labels(self._fleet_label, name).set_function(
            lambda: 0.0)

    def record_lifecycle(self, event: str) -> None:
        self._lifecycle[event].inc()

    def record_request(self, event: str) -> None:
        self._req[event].inc()

    def record_routed(self, replica: str) -> None:
        self._routed[replica].inc()

    def record_retry(self, replica: str, error: str) -> None:
        self._retried[(replica, error)].inc()

    def record_swap(self) -> None:
        self._swaps.inc()

    def n_requests(self, event: str) -> int:
        return int(self._req[event].value)

    def outcome_counts(self) -> dict:
        """Typed-outcome snapshot — the bench's reconciliation reads
        this and asserts submitted == sum(everything else)."""
        return {ev: int(c.value) for ev, c in self._req.items()}


_HEALTH_VALUE = {"ok": 1.0, "degraded": 0.5, "unhealthy": 0.0}


class Fleet:
    """Frontend over N in-process Engine replicas (module docstring).

    Build it over started-or-not engines (``start()`` starts them all)
    or straight from searchers via :meth:`from_searchers`. ``submit``
    returns a Future that ALWAYS resolves typed — per-request failures
    (shed, deadline, batch failure after retries) land on the future,
    never as synchronous raises, so open-loop clients get exact
    accounting; only a stopped fleet raises (``EngineStopped``).
    """

    def __init__(self, engines: Sequence[Engine],
                 config: Optional[FleetConfig] = None,
                 names: Optional[Sequence[str]] = None,
                 clock=time.perf_counter):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        self.config = config or FleetConfig()
        if not 1 <= self.config.quorum <= len(engines):
            raise ValueError(
                f"quorum {self.config.quorum} outside [1, {len(engines)}]")
        if names is None:
            names = [f"replica{i}" for i in range(len(engines))]
        if len(names) != len(engines) or len(set(names)) != len(names):
            raise ValueError("names must be unique, one per engine")
        self.clock = clock
        self.label = (self.config.fleet_label
                      or f"fleet{next(_fleet_seq)}")
        self.replicas: Tuple[Replica, ...] = tuple(
            Replica(n, e) for n, e in zip(names, engines))
        dims = {r.engine.searcher.dim for r in self.replicas}
        if len(dims) != 1:
            raise ValueError(f"replica searcher dims differ: {dims}")
        self.dim = dims.pop()
        self.router = Router(seed=self.config.seed,
                             probe_interval_s=self.config.probe_interval_s,
                             pressure_weight=self.config.pressure_weight,
                             degraded_penalty=self.config.degraded_penalty,
                             clock=clock)
        self.retry_policy = RetryPolicy(
            retry_limit=self.config.retry_limit,
            backoff_base_ms=self.config.backoff_base_ms,
            backoff_cap_ms=self.config.backoff_cap_ms)
        self.span_sink = self.config.span_sink
        self.stats = _FleetStats(self, self.config.registry)
        self._lock = threading.Lock()
        self._requests: set = set()  # guarded_by: _lock
        self._started = False   # guarded_by: atomic
        self._stopped = False   # guarded_by: atomic
        self.metrics_server: Optional[MetricsServer] = None  # guarded_by: atomic

    @classmethod
    def from_searchers(cls, searchers: Sequence[Searcher],
                       engine_config: Optional[EngineConfig] = None,
                       config: Optional[FleetConfig] = None,
                       clock=time.perf_counter) -> "Fleet":
        """One engine per searcher, all sharing the fleet's registry and
        span sink (engine spans and fleet spans land in one stream, so
        per-attempt engine trace ids resolve in the same file)."""
        config = config or FleetConfig()
        base = engine_config or EngineConfig()
        engines = []
        for s in searchers:
            ec = dataclasses.replace(
                base, span_sink=config.span_sink,
                registry=config.registry)
            engines.append(Engine(s, ec, clock=clock))
        return cls(engines, config, clock=clock)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "Fleet":
        """Start every replica engine (idempotent), then the optional
        fleet-wide metrics endpoint."""
        for r in self.replicas:
            if not r.engine._started:
                r.engine.start()
        self._started = True
        if self.config.metrics_port is not None:
            self.serve_metrics(self.config.metrics_port,
                               self.config.metrics_host)
        return self

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every fleet-admitted request has resolved
        (retries included). True on success, False on timeout."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            with self._lock:
                idle = not self._requests
            if idle:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.002)

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the fleet. ``drain=True`` lets in-flight requests (and
        their retries) finish first; ``drain=False`` fails them typed
        (``EngineStopped``, outcome ``stopped`` — never silent), then
        stops every replica engine."""
        if self._stopped:
            return
        if drain:
            self.drain(timeout)
        self._stopped = True
        with self._lock:
            pending = list(self._requests)
        for req in pending:
            t = req.timer
            if t is not None:
                t.cancel()
            self._finish(req, "stopped",
                         EngineStopped("fleet stopped"))
        for r in self.replicas:
            r.engine.stop(drain=drain, timeout=timeout)
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None

    # -------------------------------------------------------------- client
    def submit(self, query, k: int,
               deadline_ms: Optional[float] = None) -> Future:
        """Route one query into the fleet; the Future resolves to
        ``(distances [k], indices [k])`` rows bit-identical to a solo
        search on whichever replica served it (its handle rides
        ``future.searcher``), or to a typed failure. ``deadline_ms``
        is the END-TO-END budget: queueing, device time, and every
        retry's backoff all draw from it, and a request that cannot
        finish (or retry) inside it sheds
        :class:`~raft_tpu_torch.serving.batcher.DeadlineExceeded`.

        Never raises for per-request conditions — overload, breaker,
        replica death, and batch failures resolve the future typed
        after sibling retries — so ``submitted == sum(outcomes)``
        reconciles exactly. Raises :class:`EngineStopped` only when
        the fleet itself is not running."""
        if not self._started or self._stopped:
            raise EngineStopped("fleet not running; call start()")
        now = self.clock()
        t_deadline = (None if deadline_ms is None
                      else now + float(deadline_ms) * 1e-3)
        req = _FleetRequest(query, k, obs_spans.new_trace_id(), now,
                            t_deadline)
        with self._lock:
            self._requests.add(req)
        self.stats.record_request("submitted")
        self._attempt(req)
        return req.future

    def search(self, query, k: int, timeout: Optional[float] = None,
               deadline_ms: Optional[float] = None):
        """Blocking convenience over :meth:`submit` with one end-to-end
        deadline (mirrors ``Engine.search``): with ``deadline_ms`` the
        call never blocks past it — an unresolved future is abandoned
        with the same typed ``DeadlineExceeded`` the shed path uses."""
        fut = self.submit(query, k, deadline_ms=deadline_ms)
        budget = (timeout if deadline_ms is None
                  else float(deadline_ms) * 1e-3)
        try:
            return fut.result(budget)
        except _FuturesTimeout:
            fut.cancel()
            raise DeadlineExceeded(
                f"no result within deadline_ms={deadline_ms}") from None

    # --------------------------------------------------------- retry loop
    def _attempt(self, req: _FleetRequest) -> None:
        """One routing attempt: pick a replica, hand the request to its
        engine, and arm the completion callback. Runs on the caller
        thread (first attempt) or a backoff timer thread (retries);
        admission rejections loop here to the next sibling via
        :meth:`_on_failure`."""
        while True:
            req.timer = None
            if self._stopped:
                self._finish(req, "stopped",
                             EngineStopped("fleet stopped"))
                return
            if req.future.cancelled():
                self._finish(req, "cancelled")
                return
            now = self.clock()
            remaining = req.remaining_ms(now)
            if remaining is not None and remaining <= 0.0:
                self._finish(req, "shed_deadline", DeadlineExceeded(
                    f"deadline spent after {len(req.attempts)} "
                    f"attempt(s)"))
                return
            replica = self.router.choose(self.replicas,
                                         exclude=req.tried)
            if replica is None:
                exc = NoReplicaAvailable(
                    f"no in-service replica available "
                    f"(tried {sorted(req.tried)})")
                if req.last_error is not None:
                    exc.__cause__ = req.last_error
                self._finish(req, "shed_no_replica", exc)
                return
            try:
                inner = replica.engine.submit(
                    req.query, req.k, block=False,
                    deadline_ms=remaining)
            except BaseException as e:
                req.attempts.append({"replica": replica.name,
                                     "error": failure_kind(e)})
                if self._on_failure(req, replica, e):
                    continue  # zero-delay retry: next sibling inline
                return
            self.stats.record_routed(replica.name)
            req.attempts.append({"replica": replica.name,
                                 "trace": inner.trace_id})
            inner.add_done_callback(
                lambda f, req=req, rep=replica: self._on_done(
                    req, rep, f))
            return

    def _on_done(self, req: _FleetRequest, replica: Replica,
                 inner: Future) -> None:
        """Completion callback (runs on ``replica``'s engine completion
        thread, or inline when the inner future settled first)."""
        if inner.cancelled():
            # replica stop cancelled the rider pre-launch: a replica
            # death, retryable on a sibling
            if self._on_failure(req, replica,
                                EngineStopped("replica stopped before "
                                              "launch")):
                self._attempt(req)
            return
        exc = inner.exception()
        if exc is None:
            fut = req.future
            for attr in ("searcher", "placement"):
                breadcrumb = getattr(inner, attr, None)
                if breadcrumb is not None:
                    setattr(fut, attr, breadcrumb)
            fut.replica = replica.name
            self._finish(req, "ok", inner.result())
            return
        if self._on_failure(req, replica, exc):
            self._attempt(req)

    def _on_failure(self, req: _FleetRequest, replica: Replica,
                    exc: BaseException) -> bool:
        """Classify one per-replica failure and either finish the
        request typed or clear it for retry on a sibling.

        Returns True when the CALLER should drive the next attempt
        immediately (negligible jitter drawn); otherwise the backoff
        is armed on a one-shot timer and False is returned. Never
        leaves the request unresolved: every path either finishes the
        future or hands the baton to exactly one next thread."""
        req.tried.add(replica.name)
        req.last_error = exc
        kind = failure_kind(exc)
        if not is_retryable(exc):
            if isinstance(exc, DeadlineExceeded):
                self._finish(req, "shed_deadline", exc)
            else:
                self._finish(req, "failed", exc)
            return False
        if req.retries >= self.retry_policy.retry_limit:
            self._finish(req, "shed_retries", RetriesExhausted(
                f"retry budget ({self.retry_policy.retry_limit}) spent; "
                f"last failure on {replica.name}: {kind}",
                attempts=len(req.attempts), last_error=exc))
            return False
        req.retries += 1
        delay_ms = self.router.backoff_ms(self.retry_policy, req.retries)
        now = self.clock()
        remaining = req.remaining_ms(now)
        if remaining is not None and delay_ms >= remaining:
            # the jittered wait alone would outlive the rider's budget:
            # shed typed NOW instead of burning a doomed retry — the
            # deadline is never reset or extended by retrying
            dl = DeadlineExceeded(
                f"remaining_ms={remaining:.1f} cannot fit retry "
                f"backoff {delay_ms:.1f} ms after {kind} on "
                f"{replica.name}")
            dl.__cause__ = exc
            self._finish(req, "shed_deadline", dl)
            return False
        self.stats.record_retry(replica.name, kind)
        if delay_ms <= 0.05:
            return True  # negligible jitter: caller drives the sibling
        timer = threading.Timer(delay_ms * 1e-3, self._attempt,
                                args=(req,))
        timer.daemon = True
        req.timer = timer
        timer.start()
        return False

    def _finish(self, req: _FleetRequest, outcome: str,
                payload=None) -> None:
        """Settle the outer future and account the outcome EXACTLY once
        (module docstring of :class:`_FleetRequest` for the race
        story)."""
        fut = req.future
        try:
            if outcome == "ok":
                fut.set_result(payload)
            else:
                fut.set_exception(payload)
        except InvalidStateError:
            if not fut.cancelled():
                return  # another thread settled AND accounted it
            outcome = "cancelled"  # user cancel won the settle race
        if next(req.once):
            return
        with self._lock:
            self._requests.discard(req)
        self.stats.record_request(outcome)
        self._emit_outcome(req, outcome)

    def _emit_outcome(self, req: _FleetRequest, outcome: str) -> None:
        if self.span_sink is None:
            return
        record = {
            "kind": "fleet",
            "fleet": self.label,
            "trace_id": req.trace_id,
            "outcome": outcome,
            "k": req.k,
            "retries": req.retries,
            "attempts": req.attempts,
            "t_elapsed_ms": round(
                (self.clock() - req.t_submit) * 1e3, 3),
        }
        if outcome not in ("ok", "cancelled") and req.last_error is not None:
            record["error"] = failure_kind(req.last_error)
        obs_spans.safe_emit(self.span_sink, record)

    # ------------------------------------------------------ rolling swap
    def rolling_swap(self, searchers: Sequence[Searcher],
                     warm: bool = True,
                     drain_timeout_s: Optional[float] = 30.0
                     ) -> List[Searcher]:
        """Upgrade every replica in place, one at a time, zero drops:
        take the replica out of rotation (``admin="draining"``), drain
        its queue, hot-swap via ``Engine.swap_index`` (place + warm on
        THIS thread while siblings keep serving), then return it to
        rotation. Refuses — :class:`FleetBelowQuorum`, before touching
        anything — whenever draining the next replica would leave
        fewer than ``config.quorum`` healthy in-service siblings.

        This is also the degraded-restore promotion path
        (docs/robustness.md): pass full-coverage restores to promote a
        fleet serving partial elastic restores without a blip.

        A dead replica (engine stopped — e.g. killed mid-run) cannot be
        upgraded in place: it is skipped with a ``fleet_swap`` span
        (``skipped: "stopped"``) and a ``None`` in the returned list.
        A quorum refusal aborts the rotation mid-way; replicas already
        swapped stay swapped and every replica is back in service.

        ``searchers`` is one new handle per replica, in replica order.
        Returns the displaced handles (same order; ``None`` where
        skipped)."""
        if len(searchers) != len(self.replicas):
            raise ValueError(
                f"need {len(self.replicas)} searchers, "
                f"got {len(searchers)}")
        old: List[Optional[Searcher]] = []
        for replica, searcher in zip(self.replicas, searchers):
            if not replica.engine.health()["running"]:
                old.append(None)
                obs_spans.safe_emit(self.span_sink, {
                    "kind": "fleet_swap", "fleet": self.label,
                    "replica": replica.name, "skipped": "stopped",
                })
                continue
            healthy_rest = sum(
                1 for r in self.replicas
                if r is not replica and r.admin == "in_service"
                and r.engine.health()["status"] != "unhealthy")
            if healthy_rest < self.config.quorum:
                raise FleetBelowQuorum(
                    f"draining {replica.name} would leave "
                    f"{healthy_rest} healthy replicas < quorum "
                    f"{self.config.quorum}")
            with self._lock:
                replica.admin = "draining"
            try:
                replica.engine.drain(drain_timeout_s)
                displaced = replica.engine.swap_index(searcher,
                                                      warm=warm)
            finally:
                with self._lock:
                    replica.admin = "in_service"
            old.append(displaced)
            self.stats.record_swap()
            obs_spans.safe_emit(self.span_sink, {
                "kind": "fleet_swap", "fleet": self.label,
                "replica": replica.name,
                "old_coverage": round(float(displaced.coverage), 6),
                "new_coverage": round(float(searcher.coverage), 6),
            })
        return old

    # ------------------------------------------------- dynamic membership
    def add_replica(self, engine, name: Optional[str] = None) -> Replica:
        """Admit one more replica (the autoscaler's scale-up actuator).
        The engine-like must match the fleet ``dim``; it is started if
        the fleet is running, registered with the stats family, and
        placed in rotation atomically (the replicas tuple is replaced
        wholesale under the fleet lock — the router's lock-free read
        sees either the old or the new tuple, both valid)."""
        if name is None:
            name = f"replica{len(self.replicas)}"
        dim = int(engine.searcher.dim)
        if dim != self.dim:
            raise ValueError(f"replica dim {dim} != fleet dim {self.dim}")
        with self._lock:
            if any(r.name == name for r in self.replicas):
                raise ValueError(f"replica name {name!r} already in fleet")
        if self._started and not getattr(engine, "_started", False):
            engine.start()
        rep = Replica(name, engine)
        self.stats.add_replica(rep)
        with self._lock:
            self.replicas = self.replicas + (rep,)  # guarded_by: _lock
        self.stats.record_lifecycle("added")
        return rep

    def remove_replica(self, name: str, drain: bool = True,
                       drain_timeout_s: Optional[float] = 30.0):
        """Retire one replica (the autoscaler's scale-down actuator)
        through the same quorum-checked drain discipline as
        ``rolling_swap``: refuse (:class:`FleetBelowQuorum`) when the
        remaining siblings could not hold quorum, take the replica out
        of rotation, drain its queue, stop its engine, then drop it
        from the tuple. Returns the removed engine (the caller owns
        any process teardown)."""
        target = None
        for r in self.replicas:
            if r.name == name:
                target = r
                break
        if target is None:
            raise KeyError(f"no replica named {name!r}")
        healthy_rest = sum(
            1 for r in self.replicas
            if r is not target and r.admin == "in_service"
            and r.engine.health()["status"] != "unhealthy")
        if healthy_rest < self.config.quorum:
            raise FleetBelowQuorum(
                f"removing {name} would leave {healthy_rest} healthy "
                f"replicas < quorum {self.config.quorum}")
        with self._lock:
            target.admin = "draining"
        try:
            if drain:
                target.engine.drain(drain_timeout_s)
            target.engine.stop(drain=drain, timeout=drain_timeout_s)
        finally:
            with self._lock:
                self.replicas = tuple(
                    r for r in self.replicas if r is not target)
        self.stats.remove_replica(name)
        self.stats.record_lifecycle("removed")
        return target.engine

    # ------------------------------------------------------------- health
    def healthy_count(self) -> int:
        """In-service replicas currently ok or degraded — the quorum
        gauge's live numerator."""
        return sum(
            1 for r in self.replicas
            if r.admin == "in_service"
            and r.engine.health()["status"] != "unhealthy")

    def health(self) -> dict:
        """Fleet-level liveness for ONE ``/healthz`` scrape target:
        ``"unhealthy"`` (503) when the fleet is not running or healthy
        replicas are below quorum; ``"degraded"`` (200) while quorum
        holds but any replica is degraded/unhealthy/draining; ``"ok"``
        otherwise. Per-replica detail rides ``replicas``."""
        per = {}
        healthy = 0
        clean = True
        for r in self.replicas:
            h = r.engine.health()
            per[r.name] = {"admin": r.admin, **h}
            in_service = r.admin == "in_service"
            if in_service and h["status"] != "unhealthy":
                healthy += 1
            if not in_service or h["status"] != "ok":
                clean = False
        quorum_ok = healthy >= self.config.quorum
        running = self._started and not self._stopped
        if not running or not quorum_ok:
            status = "unhealthy"
        elif clean:
            status = "ok"
        else:
            status = "degraded"
        return {
            "status": status,
            "fleet": self.label,
            "running": running,
            "quorum": {"required": self.config.quorum,
                       "healthy": healthy, "ok": quorum_ok},
            "replicas": per,
        }

    def serve_metrics(self, port: int = 0,
                      host: str = "127.0.0.1") -> MetricsServer:
        """One scrape target for the whole fleet: the shared registry
        (every ``raft_tpu_serving_*`` engine family plus
        ``raft_tpu_fleet_*``) at ``/metrics``, and the aggregated
        :meth:`health` at ``/healthz`` — 200 while quorum holds (status
        ``"degraded"`` when any replica is), 503 below quorum.

        The host_p2p transport families (``raft_tpu_p2p_*`` — the 8
        per-peer send/retry/poison/death counters a REMOTE fleet's
        health story needs) always live on the process-global registry;
        when the fleet scrapes a private registry they are appended to
        the same ``/metrics`` body, so cross-host transport health is
        never invisible behind a registry override.

        Remote replicas' own engine families (which live in OTHER
        processes' registries) are served at
        ``/metrics/replica/<name>`` — a passthrough of the replica's
        ``scrape`` RPC, resolved against live membership so autoscaled
        replicas appear and retire with the fleet. They are routes, not
        an inline merge: merging another process's text into
        ``/metrics`` would duplicate family declarations."""
        if self.metrics_server is None:
            extra = None
            if self.stats.registry is not obs_metrics.REGISTRY:
                extra = (lambda: obs_metrics.REGISTRY
                         .to_prometheus_text(prefix="raft_tpu_p2p_"))
            self.metrics_server = MetricsServer(
                port, host, registry=self.stats.registry,
                health_fn=self.health, extra_text_fn=extra,
                text_route_fn=self._replica_scrape_route).start()
        return self.metrics_server

    def _replica_scrape_route(self, path: str):
        """``/metrics/replica/<name>`` → that replica's own scrape text
        fetched over the wire (remote replicas only — a local engine's
        families are already on the fleet registry at ``/metrics``).
        None (→ 404) for unknown names, local replicas, and every other
        path; a dead link raises and surfaces as the handler's counted
        500, not a silent empty body."""
        prefix = "/metrics/replica/"
        if not path.startswith(prefix):
            return None
        name = path[len(prefix):]
        for r in self.replicas:
            if r.name == name:
                scrape = getattr(r.engine, "scrape", None)
                if callable(scrape):
                    return str(scrape(timeout=5.0))
                return None
        return None
