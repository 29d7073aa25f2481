"""Replica selection + typed-failure retry policy for the serving fleet.

A copy of ``raft_tpu.serving.router`` over the port's engine and typed failures.

The :class:`Router` answers one question — *which replica should this
request try next?* — with power-of-two-choices over a load score built
from the three signals the fleet already exports (docs/serving.md
"Fleet"):

- **queue depth** (``len(engine.batcher)``): the direct backlog;
- **autoscale pressure** (p99 queue wait / deadline budget — the same
  ratio the ``raft_tpu_serving_autoscale_pressure`` gauge publishes):
  catches a replica whose queue is short but slow;
- **health()**: ``"unhealthy"`` replicas (stopped, or breaker open
  after a hang) are routed around entirely; ``"degraded"`` ones
  (shedding / half-open / partial coverage) pay a score penalty but
  stay in rotation.

A breaker-open replica is not abandoned: the engine's breaker only
flips open→half-open when a request *arrives* after the cooldown, so
the router deliberately sends one live request per ``probe_interval_s``
to each breaker-open (but still running) replica. A too-early probe is
rejected with :class:`~raft_tpu_torch.serving.engine.CircuitOpen` and the
fleet retries it on a sibling — cheap; a post-cooldown probe is the
half-open batch whose completion closes the breaker and re-admits the
replica.

:class:`RetryPolicy` owns the retry arithmetic: exponential backoff
with **full jitter** (``uniform(0, min(cap, base * 2**retry))``),
bounded by a per-request retry budget AND the rider's ``remaining_ms``
— a retry never resets the deadline; when the drawn delay would land
past the deadline the request is shed typed instead of retried.

Retryability is classified by ``isinstance`` over the typed hierarchy
exported from :mod:`raft_tpu_torch.serving` (never by string matching):

==================  =========  ==============================================
exception           retryable  why
==================  =========  ==============================================
``BatchFailed``     yes        contained to one batch on one replica; a
                               sibling's device is unaffected
``Overloaded``      yes        replica-local backlog; a sibling may have room
``CircuitOpen``     yes        replica-local device sickness (subclass of
                               ``Overloaded``)
``QueueFull``       yes        replica-local admission queue at capacity
``EngineStopped``   yes        replica death — exactly the case siblings
                               exist for
``ReplicaStarting`` yes        remote replica still spawning (connect
                               refused); a sibling serves meanwhile
                               (subclass of ``Overloaded``)
``CancelledError``  yes        a replica stop cancelled the rider pre-launch
``DeadlineExceeded``no         the *rider's* budget is spent; no sibling can
                               un-spend it
``IntegrityError``  no         corrupt index/checkpoint state — retrying
                               re-serves the corruption
anything else       no         programmer errors (``ValueError`` ...) must
                               surface, not bounce between replicas
==================  =========  ==============================================

Thread discipline: the router's single lock
guards only its RNG and the probe timestamps — it is a *leaf* lock
(never held across an engine call, a blocking call, or another lock),
so no lock-order edge starts at it.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import CancelledError
from typing import Dict, Iterable, Optional, Sequence

from raft_tpu_torch.core.errors import IntegrityError
from raft_tpu_torch.serving.batcher import (DeadlineExceeded, EngineStopped,
                                      QueueFull)
from raft_tpu_torch.serving.engine import BatchFailed, CircuitOpen, Overloaded

__all__ = ["NoReplicaAvailable", "RetriesExhausted", "FleetBelowQuorum",
           "ReplicaStarting", "RetryPolicy", "Router", "is_retryable",
           "failure_kind"]


# ------------------------------------------------------------ typed sheds
class NoReplicaAvailable(Overloaded):
    """Shed: no in-service replica could take the request — every
    sibling is unhealthy, draining, or already failed this request.
    Subclasses :class:`~raft_tpu_torch.serving.engine.Overloaded` so one
    handler covers every shed path. The last per-replica failure (if
    any) rides ``__cause__``."""


class RetriesExhausted(Overloaded):
    """Shed: the per-request retry budget ran out before any replica
    answered. ``attempts`` is the number of replica submissions tried;
    the final per-replica failure rides ``last_error`` (also chained
    via ``__cause__``)."""

    def __init__(self, message: str, attempts: int = 0,
                 last_error: Optional[BaseException] = None):
        super().__init__(message)
        self.attempts = int(attempts)
        self.last_error = last_error
        if last_error is not None:
            self.__cause__ = last_error


class FleetBelowQuorum(RuntimeError):
    """``Fleet.rolling_swap`` refused to drain a replica because doing
    so would leave fewer healthy in-service replicas than
    ``FleetConfig.quorum`` — fix the sick replicas first, then
    upgrade."""


class ReplicaStarting(Overloaded):
    """A remote replica's transport refused the connection — the process
    is still spawning (or restarting), its listener not yet bound.
    Subclasses :class:`~raft_tpu_torch.serving.engine.Overloaded` so the
    existing retryability table sends the request to a sibling while
    the newcomer warms up. The ECONNREFUSED (or poisoned-stream wrapper)
    rides ``__cause__``."""


# ------------------------------------------------------- retryability map
_RETRYABLE = (BatchFailed, Overloaded, QueueFull, EngineStopped,
              CancelledError)
_NON_RETRYABLE = (DeadlineExceeded, IntegrityError)


def is_retryable(exc: BaseException) -> bool:
    """True when a sibling replica could plausibly answer where this one
    failed (see the module-docstring table). Classified by
    ``isinstance`` — never by message matching."""
    if isinstance(exc, _NON_RETRYABLE):
        return False
    return isinstance(exc, _RETRYABLE)


def failure_kind(exc: BaseException) -> str:
    """Closed label vocabulary for the retry counters / span records —
    most-derived classes first so ``CircuitOpen`` does not report as
    ``overloaded``."""
    if isinstance(exc, CircuitOpen):
        return "circuit_open"
    if isinstance(exc, RetriesExhausted):
        return "retries_exhausted"
    if isinstance(exc, NoReplicaAvailable):
        return "no_replica"
    if isinstance(exc, ReplicaStarting):
        return "replica_starting"
    if isinstance(exc, QueueFull):
        return "queue_full"
    if isinstance(exc, Overloaded):
        return "overloaded"
    if isinstance(exc, BatchFailed):
        return "batch_failed"
    if isinstance(exc, EngineStopped):
        return "engine_stopped"
    if isinstance(exc, CancelledError):
        return "cancelled"
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, IntegrityError):
        return "integrity"
    return "other"


#: every label ``failure_kind`` can produce — the fleet pre-touches its
#: retry counters over this vocabulary so a scrape shows zeros, not holes
FAILURE_KINDS = ("circuit_open", "retries_exhausted", "no_replica",
                 "replica_starting", "queue_full", "overloaded",
                 "batch_failed", "engine_stopped", "cancelled", "deadline",
                 "integrity", "other")


class RetryPolicy:
    """Exponential backoff + full jitter under a per-request budget.

    ``retry_limit`` caps *retries* (a request makes at most
    ``retry_limit + 1`` replica submissions). ``backoff_ms`` draws the
    delay before retry ``n`` (1-based) as
    ``uniform(0, min(cap, base * 2**(n-1)))`` — full jitter
    decorrelates the retry storms a fleet-wide brownout would otherwise
    synchronize. The caller compares the drawn delay against the
    rider's ``remaining_ms`` and sheds typed when it does not fit: a
    retry never resets, extends, or outlives the deadline.
    """

    def __init__(self, retry_limit: int = 3, backoff_base_ms: float = 1.0,
                 backoff_cap_ms: float = 50.0):
        if retry_limit < 0:
            raise ValueError(f"retry_limit must be >= 0, got {retry_limit}")
        self.retry_limit = int(retry_limit)
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_cap_ms = float(backoff_cap_ms)

    def backoff_ms(self, retry: int, rng: random.Random) -> float:
        """Full-jitter delay before 1-based retry number ``retry``."""
        ceiling = min(self.backoff_cap_ms,
                      self.backoff_base_ms * (2.0 ** max(retry - 1, 0)))
        return rng.uniform(0.0, ceiling)


class Router:
    """Power-of-two-choices replica selection with health route-around
    and breaker-probe re-admission (module docstring for the policy).

    ``choose`` takes any sequence of replica records exposing ``name``,
    ``admin`` (``"in_service"`` routes; anything else — draining,
    retired — does not) and ``engine``; it never mutates them. All
    selection state lives here: the seeded RNG (deterministic tests)
    and the per-replica probe clock.
    """

    def __init__(self, seed: int = 0, probe_interval_s: float = 1.0,
                 pressure_weight: float = 32.0,
                 degraded_penalty: float = 8.0,
                 clock=time.perf_counter):
        self.probe_interval_s = float(probe_interval_s)
        self.pressure_weight = float(pressure_weight)
        self.degraded_penalty = float(degraded_penalty)
        self.clock = clock
        self._lock = threading.Lock()
        self._rng = random.Random(seed)  # guarded_by: _lock
        self._last_probe: Dict[str, float] = {}  # guarded_by: _lock

    # ----------------------------------------------------------- scoring
    def score(self, replica, health: Optional[dict] = None) -> float:
        """Load score (lower routes first): queue depth, plus the
        autoscale-pressure ratio scaled by ``pressure_weight`` (so a
        replica at its full latency budget scores like ~``weight``
        extra queued requests), plus a flat penalty while degraded."""
        eng = replica.engine
        if health is None:
            health = eng.health()
        depth = float(len(eng.batcher))
        # windowed when available (same signal the autoscaler reads);
        # remote stats views only piggyback the cumulative p99
        read = getattr(eng.stats, "queue_wait_p99_window_s",
                       eng.stats.queue_wait_p99_s)
        pressure = read() * 1e3 / eng.autoscale_budget_ms
        s = depth + self.pressure_weight * pressure
        if health["status"] == "degraded":
            s += self.degraded_penalty
        return s

    # --------------------------------------------------------- selection
    def choose(self, replicas: Sequence, exclude: Iterable[str] = ()):
        """Pick the next replica for one request attempt, or None when
        every in-service sibling is excluded/unroutable.

        Routable replicas race power-of-two-choices on :meth:`score`.
        Breaker-open (but running) replicas are unroutable EXCEPT for
        one probe per ``probe_interval_s`` — a due probe preempts the
        healthy pick, because the breaker can only close by seeing
        traffic. Replicas in ``exclude`` (already failed this request)
        are never picked: a retry always lands on a sibling."""
        excluded = set(exclude)
        now = self.clock()
        routable = []
        probeable = []
        for r in replicas:
            if r.admin != "in_service" or r.name in excluded:
                continue
            h = r.engine.health()
            if h["status"] != "unhealthy":
                routable.append((r, h))
            elif h["running"] and h["breaker"] == "open":
                probeable.append(r)
        probe = self._due_probe(probeable, now)
        if probe is not None:
            return probe
        if not routable:
            return None
        if len(routable) == 1:
            return routable[0][0]
        with self._lock:
            pair = self._rng.sample(routable, 2)
        (ra, ha), (rb, hb) = pair
        # score() reads engine state — outside the router lock, so the
        # router lock stays a leaf
        return ra if self.score(ra, ha) <= self.score(rb, hb) else rb

    def _due_probe(self, probeable: Sequence, now: float):
        """First breaker-open replica whose probe interval has elapsed
        (claiming the probe slot), else None."""
        if not probeable:
            return None
        with self._lock:
            for r in probeable:
                last = self._last_probe.get(r.name)
                if last is None or now - last >= self.probe_interval_s:
                    self._last_probe[r.name] = now
                    return r
        return None

    def backoff_ms(self, policy: RetryPolicy, retry: int) -> float:
        """Draw ``policy``'s full-jitter delay from the router's seeded
        RNG (one RNG stream keeps amplified-interleave runs
        reproducible)."""
        with self._lock:
            return policy.backoff_ms(retry, self._rng)
