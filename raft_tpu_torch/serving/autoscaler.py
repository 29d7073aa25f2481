"""Closed autoscale loop: the pressure gauge actuates.

The serving engine exports ``raft_tpu_serving_autoscale_pressure`` (p99
queue wait ÷ per-request latency budget — 1.0 means the queue alone eats
the whole budget) and its SLO monitor reports burn rates through
fast-burn callbacks; both are signals with no actuator of their own.
:class:`Autoscaler` closes the loop: a control thread samples fleet
pressure every ``tick_s``, and with hysteresis spawns or retires replicas
through the Fleet's quorum-checked membership surface (``add_replica`` /
``remove_replica``). A copy of ``raft_tpu.serving.autoscaler``: the same
law, reasons and counters, decision for decision.

Control law (deliberately boring — the interesting property is that
every transition is attributable, not that the law is clever):

- ``pressure`` = max over in-service replicas of
  ``queue_wait_p99_window_s() * 1e3 / autoscale_budget_ms`` — the same
  windowed ratio the gauge publishes, taken at its worst replica (a
  fleet is as slow as the replica the router is forced to use). The
  window re-baselines on ``reset_samples()``, so pressure decays when
  offered load does; remote stats views without the windowed method
  fall back to the cumulative one.
- **Scale up** when pressure has stayed above ``high_watermark`` for a
  full ``up_window_s`` (sustained overload, not a spike), or
  immediately on an SLO **fast-burn** notification (wire
  :meth:`Autoscaler.on_fast_burn` as the ``SLOMonitor``'s callback) —
  burn is already a windowed signal, so it does not wait out a second
  window.
- **Scale down** only after pressure has stayed below
  ``low_watermark`` for a full ``down_window_s`` (the cooldown — an
  idle dip never retires capacity that a burst just paid for), never
  below ``min_replicas``, and always through the Fleet's drain +
  quorum refusal path.
- After ANY decision (including blocked ones) both windows re-arm, so
  decisions are rate-limited to one per window and a blocked verdict
  logs once per window instead of every tick.

Every decision — acted or blocked — emits ONE ``kind="autoscale"``
span with a closed ``reason`` vocabulary (:data:`AUTOSCALE_REASONS`)
and increments the fleet's ``raft_tpu_fleet_replica_lifecycle_total``
counter 1:1 for the acted ones (``spawned`` / ``retired`` /
``spawn_failed``), so spans and counters reconcile exactly
(tests/test_torch_remote_fleet.py pins it).

The actuators are injected: ``spawn()`` returns an engine-like to
admit (an in-process Engine in tests; a subprocess + RemoteReplica
proxy in the two-host runbook — docs/serving.md), ``retire(name,
engine)`` runs after the quorum-checked removal for process teardown.
A raising ``spawn`` is a ``spawn_failed`` decision, never an escaped
exception.

Thread discipline: the autoscaler owns NO
lock. All mutable control state (window anchors, stop flag) is touched
only by the control thread; ``on_fast_burn`` (foreign thread) sets one
``threading.Event`` — the control thread consumes it. Fleet membership
mutations happen through Fleet's own lock discipline. The tick loop
sleeps in real short slices but computes every window deadline on the
injectable ``clock``, so chaos tests drive hysteresis with a fake
clock instead of real waits (as the batcher's fake-clock tests do).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from raft_tpu_torch.core import logger
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.serving.router import FleetBelowQuorum

__all__ = ["Autoscaler", "AutoscalerConfig", "AUTOSCALE_REASONS"]

#: closed reason vocabulary for kind="autoscale" spans — every decision
#: the loop can take, including the refusals (observability.md)
AUTOSCALE_REASONS = ("scale_up_pressure", "scale_up_fast_burn",
                     "scale_down_idle", "blocked_max_replicas",
                     "blocked_quorum", "spawn_failed")


@dataclasses.dataclass
class AutoscalerConfig:
    """Hysteresis knobs (docs/serving.md "Remote fleet" for tuning).

    The watermarks are pressure ratios (1.0 = queue wait alone spends
    the whole latency budget); keep ``low_watermark`` well under
    ``high_watermark`` or the loop will flap at the boundary.
    ``up_window_s`` is how long overload must SUSTAIN before a spawn;
    ``down_window_s`` is the cooldown an idle fleet must ride out
    before a retire — asymmetry is deliberate (scaling up too late
    sheds traffic; scaling down too late only costs capacity).
    """

    min_replicas: int = 1
    max_replicas: int = 8
    high_watermark: float = 0.8
    low_watermark: float = 0.2
    up_window_s: float = 5.0
    down_window_s: float = 30.0
    tick_s: float = 0.5
    span_sink: Optional[object] = None


class Autoscaler:
    """The control loop (module docstring for the law)."""

    def __init__(self, fleet, spawn: Callable[[], object],
                 retire: Optional[Callable[[str, object], None]] = None,
                 config: Optional[AutoscalerConfig] = None,
                 clock=time.monotonic):
        self.fleet = fleet
        self.spawn = spawn
        self.retire = retire
        self.config = config or AutoscalerConfig()
        if self.config.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.config.max_replicas < self.config.min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if self.config.low_watermark >= self.config.high_watermark:
            raise ValueError("low_watermark must be < high_watermark")
        self.clock = clock
        self._spawn_seq = 0            # control thread only
        self._above_since: Optional[float] = None  # control thread only
        self._below_since: Optional[float] = None  # control thread only
        self._last_burn: Optional[tuple] = None    # set-once handoff
        self._burn_event = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._decisions = 0            # control thread only

    # ------------------------------------------------------------ signals
    def on_fast_burn(self, slo_name: str, burn: float) -> None:
        """SLOMonitor fast-burn callback (wire it as ``on_fast_burn=``).
        Foreign thread: records the excursion and wakes the loop; the
        control thread takes the decision."""
        # rebind-only handoff published BEFORE the Event set(); the
        # control thread reads it after wait() returns
        self._last_burn = (str(slo_name), float(burn))  # guarded_by: atomic
        self._burn_event.set()

    def pressure(self) -> float:
        """Worst in-service replica's autoscale pressure ratio.

        Prefers the windowed p99 (``queue_wait_p99_window_s``) so
        pressure can FALL again after the load generator re-baselines via
        ``reset_samples()`` — a cumulative p99 only ratchets up, which
        would pin the loop at its historical worst and make scale-down
        unreachable. Stats views that only expose the cumulative method
        (e.g. a remote replica's piggybacked health) fall back to it."""
        worst = 0.0
        for r in self.fleet.replicas:
            if r.admin != "in_service":
                continue
            eng = r.engine
            try:
                read = getattr(eng.stats, "queue_wait_p99_window_s",
                               eng.stats.queue_wait_p99_s)
                p = read() * 1e3 / eng.autoscale_budget_ms
            except Exception:
                continue  # a dying replica's stats never stall the loop
            worst = max(worst, p)
        return worst

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(  # guarded_by: atomic
            target=self._run, daemon=True, name="raft-tpu-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._burn_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------- the loop
    def _run(self) -> None:
        while not self._stop.is_set():
            # real-time slice, injected-clock deadlines
            self._burn_event.wait(min(self.config.tick_s, 0.05))
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception as e:
                # the loop must outlive any single bad tick
                logger.warn("autoscaler tick failed: %r", e)

    def tick(self) -> None:
        """One control step — public so fake-clock tests can single-step
        the law without the thread."""
        now = self.clock()
        burn = None
        if self._burn_event.is_set():
            self._burn_event.clear()
            burn = self._last_burn
        p = self.pressure()
        cfg = self.config
        # ---- hysteresis window tracking
        if p > cfg.high_watermark:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
        elif p < cfg.low_watermark:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
        else:  # dead band: both windows re-arm
            self._above_since = None
            self._below_since = None
        sustained_up = (self._above_since is not None
                        and now - self._above_since >= cfg.up_window_s)
        sustained_down = (self._below_since is not None
                          and now - self._below_since >= cfg.down_window_s)
        if burn is not None or sustained_up:
            reason = ("scale_up_fast_burn" if burn is not None
                      else "scale_up_pressure")
            self._scale_up(reason, p, burn)
            self._rearm()
        elif sustained_down:
            self._scale_down(p)
            self._rearm()

    def _rearm(self) -> None:
        self._above_since = None
        self._below_since = None

    # ----------------------------------------------------------- actuate
    def _n_replicas(self) -> int:
        return len(self.fleet.replicas)

    def _scale_up(self, reason: str, pressure: float, burn) -> None:
        n = self._n_replicas()
        if n >= self.config.max_replicas:
            self._emit("blocked_max_replicas", pressure, burn,
                       n_before=n, n_after=n)
            return
        self._spawn_seq += 1
        name = f"scale{self._spawn_seq}"
        try:
            engine = self.spawn()
            rep = self.fleet.add_replica(engine, name=name)
        except Exception as e:
            self.fleet.stats.record_lifecycle("spawn_failed")
            self._emit("spawn_failed", pressure, burn, n_before=n,
                       n_after=n, error=f"{type(e).__name__}: {e}")
            return
        self.fleet.stats.record_lifecycle("spawned")
        self._emit(reason, pressure, burn, n_before=n,
                   n_after=self._n_replicas(), replica=rep.name)

    def _scale_down(self, pressure: float) -> None:
        n = self._n_replicas()
        if n <= self.config.min_replicas:
            return  # nothing to retire; windows re-arm in tick()
        # retire the newest autoscaled replica first (LIFO keeps the
        # hand-built seed replicas stable); fall back to the last one
        target = None
        for r in reversed(self.fleet.replicas):
            if r.name.startswith("scale"):
                target = r
                break
        if target is None:
            target = self.fleet.replicas[-1]
        try:
            engine = self.fleet.remove_replica(target.name, drain=True)
        except FleetBelowQuorum as e:
            self._emit("blocked_quorum", pressure, None, n_before=n,
                       n_after=n, error=str(e))
            return
        self.fleet.stats.record_lifecycle("retired")
        self._emit("scale_down_idle", pressure, None, n_before=n,
                   n_after=self._n_replicas(), replica=target.name)
        if self.retire is not None:
            try:
                self.retire(target.name, engine)
            except Exception as e:
                logger.warn("autoscaler retire hook failed for %s: %r",
                            target.name, e)

    # ------------------------------------------------------------- spans
    def _emit(self, reason: str, pressure: float, burn,
              **fields) -> None:
        assert reason in AUTOSCALE_REASONS
        self._decisions += 1
        record = {
            "kind": "autoscale",
            "fleet": self.fleet.label,
            "reason": reason,
            "pressure": round(float(pressure), 6),
            **fields,
        }
        if burn is not None:
            record["slo"], record["burn"] = burn[0], round(burn[1], 3)
        sink = (self.config.span_sink
                if self.config.span_sink is not None
                else self.fleet.span_sink)
        obs_spans.safe_emit(sink, record)
        logger.info("autoscale: %s pressure=%.3f %s", reason, pressure,
                    {k: v for k, v in fields.items() if k != "error"})
