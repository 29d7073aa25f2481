"""Async micro-batching serving engine.

Counterpart of ``raft_tpu.serving.engine``. ``Engine`` sits in front of
one built index (via a :mod:`raft_tpu_torch.serving.searchers` handle) and
turns concurrent single-query ``submit()`` calls into batched searches at
``utils.shape.query_bucket`` shapes: users send single queries, and one
search of a batch of them costs the card little more than a search of one.

Three mechanisms, each its own thread-or-phase:

1. **Warm start** (:meth:`Engine.start`): keep the index on its device,
   build every kernel library (``gpu_kernels.build_all``; the build
   directory persists by source hash), then search every configured
   (bucket, k) with a zeros batch — on the caller's thread AND on the
   dispatch thread before ``start()`` returns, since cuBLAS handles and
   workspaces and the caching allocator's first use of a size are per
   thread in torch. The first user request builds nothing (asserted via
   :func:`compile_count`, the ``raft_tpu_kernel_build_total`` counter).
2. **Dispatch thread**: drains the :class:`~raft_tpu_torch.serving.
   batcher.Batcher` under the ``(max_batch, max_wait_us)`` policy, stacks
   the coalesced queries on the host, stages them on the card from pinned
   memory, and launches ONE search on its current stream. The search
   returns before the card finishes (no search path reads the card back),
   so the thread records a CUDA event after it and stages the next batch.
3. **Completion thread**: waits on the oldest in-flight batch's event,
   then copies its rows to the host on a readback stream of its own that
   has waited for that event (never on the dispatch stream, where the
   copy would queue behind the next batch), and scatters per-request row
   slices through the futures. With ``max_inflight >= 2`` batch N's
   readback overlaps batch N+1's staging and device time.

Span fields keep the JAX package's meaning: ``device_ms`` is launch →
readback start (the event has fired: the card is done), ``readback_ms``
the copy to the host. The port adds ``host_return_ms`` (launch → the
search call returned on the host) and ``device_event_ms`` (CUDA events
around the search on the dispatch stream); on the CPU the search returns
when it is done, so ``device_event_ms`` is absent and ``device_ms`` is
the wait between the search's return and the readback.

Exactness: a coalesced request's result row is bit-identical to a solo
search of the same query at the same bucket shape and row
(:func:`solo_reference`; the search paths are row-wise).

Robustness (as the JAX engine): per-request ``deadline_ms`` shedding
(``DeadlineExceeded``), watermark admission control (``Overloaded``),
per-batch failure containment (``BatchFailed``), a hang watchdog +
circuit breaker (``CircuitOpen``, :meth:`Engine.health`), and
:meth:`Engine.swap_index` with zero dropped requests.

Telemetry: every ``submit()`` mints a trace id and the request's whole
life — admission wait, queue wait, pad/copy, device, readback, and its
typed outcome — is emitted as one span record to
``EngineConfig.span_sink`` (plus a per-batch record carrying batch id,
bucket, searcher generation, the explain briefs of the search, and the
device timings). Counters and latency histograms live on the
:mod:`raft_tpu_torch.obs.metrics` registry via :class:`ServingStats`
under the JAX package's family names; ``EngineConfig.metrics_port`` (or
:meth:`Engine.serve_metrics`) exposes ``/metrics`` + ``/healthz`` +
``/slo`` + ``/debug/bundle``. Telemetry never fails the serving path: a
raising sink is counted and silenced.

Not ported: the adaptive planner (``EngineConfig.planner``, ROADMAP Queue
A item 10) and the write surface (:meth:`Engine.writer`, item 11) raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import queue as _queue
import random as _random
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.obs import device as obs_device
from raft_tpu_torch.obs import diagnostics as obs_diagnostics
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.obs import quality as obs_quality
from raft_tpu_torch.obs import slo as obs_slo
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.obs.httpd import MetricsServer
from raft_tpu_torch.serving.batcher import (Batch, Batcher, DeadlineExceeded,
                                      EngineStopped, QueueFull, Request)
from raft_tpu_torch.serving.searchers import Searcher
from raft_tpu_torch.serving.stats import ServingStats
from raft_tpu_torch.utils.shape import query_bucket

__all__ = ["EngineConfig", "Engine", "compile_count", "EngineStopped",
           "BatchFailed", "Overloaded", "CircuitOpen", "CircuitBreaker",
           "solo_reference", "verify_bit_identity"]


def compile_count() -> int:
    """Process-wide count of kernel library builds observed since the
    first call. Monotonic; compare deltas around a region to assert that
    it built nothing. Backed by the ``raft_tpu_kernel_build_total``
    registry counter (:func:`raft_tpu_torch.obs.device.compile_count`)."""
    return obs_device.compile_count()


# ------------------------------------------------------------ typed errors
class BatchFailed(RuntimeError):
    """A batch's device call failed (exception or watchdog-detected hang):
    every rider's future gets THIS exception, with the underlying cause on
    ``.cause`` (also chained via ``__cause__``) and ``.hang`` marking a
    watchdog trip. The engine itself keeps serving — the failure is
    contained to the one batch."""

    def __init__(self, message: str, cause: Optional[BaseException] = None,
                 hang: bool = False):
        super().__init__(message)
        self.cause = cause
        self.hang = bool(hang)
        if cause is not None:
            self.__cause__ = cause


class Overloaded(RuntimeError):
    """Admission rejected by the load-shedding controller (queue depth
    over the watermark or the shed-probability ramp). A fast, typed
    rejection — the caller should back off or retry elsewhere, not
    wait."""


class CircuitOpen(Overloaded):
    """Admission rejected because the circuit breaker is open: the device
    hung within the last ``breaker_cooldown_s`` and has not yet passed a
    half-open probe. Subclasses :class:`Overloaded` so one handler
    covers both shed paths."""


class CircuitBreaker:
    """open → half-open probe → closed breaker around the device path.

    - ``trip()`` (watchdog, on a hang) opens the breaker: admission
      rejects with :class:`CircuitOpen` for ``cooldown_s``.
    - After the cooldown, the next admission flips to **half-open**: new
      requests are admitted as probes.
    - The first probe batch outcome decides: a completed batch closes the
      breaker; a failed/hung one re-opens it (fresh cooldown).
    """

    def __init__(self, cooldown_s: float = 5.0,
                 clock=time.perf_counter):
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state = "closed"  # guarded_by: _lock
        self._opened_at: Optional[float] = None  # guarded_by: _lock
        # trip-generation counter: batch results are stamped with the
        # epoch captured at launch, so a result from a batch launched
        # BEFORE the most recent trip can never decide a half-open
        # probe (it proves nothing about the device after the hang)
        self._epoch = 0  # guarded_by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def epoch(self) -> int:
        """Current trip generation — capture at batch launch and pass
        back via :meth:`on_batch_result`."""
        with self._lock:
            return self._epoch

    def trip(self) -> None:
        with self._lock:
            self._state = "open"
            self._opened_at = self.clock()
            self._epoch += 1

    def admit(self) -> bool:
        """True when a new request may enter (closed, or half-open probe
        window — including the open→half-open transition once the
        cooldown has elapsed)."""
        with self._lock:
            if self._state == "open":
                if self.clock() - self._opened_at >= self.cooldown_s:
                    self._state = "half_open"
                    return True
                return False
            return True

    def on_batch_result(self, ok: bool,
                        epoch: Optional[int] = None) -> None:
        """Probe verdict: only meaningful in half-open (a closed breaker
        ignores batch failures — those are contained per-batch, not a
        device-health signal; only the watchdog's hang verdict opens).

        ``epoch`` is the value of :attr:`epoch` when the batch was
        launched; a result whose epoch predates the last trip is stale
        (the batch ran against the device state that caused the hang)
        and is discarded rather than closing or re-opening the breaker.
        ``None`` keeps the legacy always-current behavior for direct
        unit-test calls."""
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return
            if self._state != "half_open":
                return
            if ok:
                self._state = "closed"
                self._opened_at = None
            else:
                self._state = "open"
                self._opened_at = self.clock()


@dataclasses.dataclass
class EngineConfig:
    """Knobs for one serving engine.

    ``max_batch`` caps coalescing; keep it <= 256 so every reachable
    batch lands on a warmed power-of-two bucket (``query_bucket`` keeps
    exact shapes above 256, which cannot all be warmed).
    ``max_wait_us`` is the latency the slowest rider donates to the
    batch; where a batch of 8 costs the card what one query costs, a
    deadline near the device latency converts straight into batch size
    under load.

    Overload & failure knobs: admission latches shed mode at ``queue_high_watermark``
    pending requests and unlatches at ``queue_low_watermark``
    (defaults: ``min(queue_limit, 16 * max_batch)`` and half of it);
    ``shed_ramp`` adds a probabilistic shed between the watermarks so
    rejection ramps instead of cliffing. ``hang_timeout_s`` arms the
    watchdog (None disables); ``breaker_cooldown_s`` is the open→
    half-open wait after a hang trips the circuit breaker.

    Telemetry knobs: ``span_sink`` is any object
    with ``emit(dict)`` (e.g. :class:`raft_tpu_torch.obs.JsonlSink`; None
    disables span records, the default); ``metrics_port`` starts the
    ``/metrics`` + ``/healthz`` server on ``start()`` (0 = ephemeral,
    read ``engine.metrics_server.port``); ``registry`` overrides the
    process-global metrics registry (tests); ``deadline_budget_ms`` is
    the autoscale pressure denominator — the per-request latency budget
    the deployment promises (None derives 10x the flush deadline).

    Quality & SLO knobs: ``shadow_oracle`` is a ``(queries, k) -> (dist, idx)``
    callable (typically a brute-force exact sibling of the serving
    index) that grades a ``shadow_sample_rate`` fraction of completed
    batches on a background thread — off the hot path, deadline-capped
    at ``shadow_deadline_ms``, shed (and counted) behind a
    ``shadow_queue_limit``-deep queue. Results land in the
    ``raft_tpu_online_recall`` gauges and ``kind="shadow_eval"`` spans.
    ``slos`` is a tuple of :class:`raft_tpu_torch.obs.SLO` objectives
    evaluated over ``slo_window_s`` windows into burn-rate gauges and
    the ``/slo`` endpoint; a fast-burn crossing auto-dumps the flight
    recorder (reason ``slo_fast_burn``, same rate limit as the other
    auto-dumps).
    """

    max_batch: int = 64
    max_wait_us: int = 2000
    max_inflight: int = 2
    queue_limit: int = 4096
    warm_ks: Tuple[int, ...] = (10,)
    warm_buckets: Optional[Tuple[int, ...]] = None  # None: derive
    #: the kernel build directory (``build/raft_tpu_torch/``), which
    #: persists by source hash, so a restart on the same tree builds
    #: nothing; None: True on CUDA, False on the CPU (no kernels there).
    #: Reported in ``warmup_info``: the port has no cache to switch off
    persistent_cache: Optional[bool] = None
    stats_window: int = 8192
    # ---- overload / failure containment
    queue_high_watermark: Optional[int] = None  # None: derive
    queue_low_watermark: Optional[int] = None   # None: high // 2
    shed_ramp: bool = False
    shed_seed: int = 0  # deterministic ramp draws (tests)
    hang_timeout_s: Optional[float] = 30.0
    breaker_cooldown_s: float = 5.0
    # ---- telemetry
    span_sink: Optional[object] = None
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    registry: Optional[object] = None
    deadline_budget_ms: Optional[float] = None
    # ---- flight recorder:
    # a bounded RingSink tape of the last N span records, on by default
    # (O(capacity) memory, a deque append per span). On a watchdog hang
    # or a breaker trip the engine freezes the tape + registry snapshot
    # + health into a diagnostics bundle; ``diagnostics_dir`` (None
    # keeps bundles in memory only, see ``Engine.last_diagnostics``)
    # makes auto-dumps land on disk. ``diagnostics_min_interval_s``
    # rate-limits auto-dumps so a flapping breaker can't spam bundles.
    flight_recorder: bool = True
    flight_recorder_capacity: int = 512
    diagnostics_dir: Optional[str] = None
    diagnostics_min_interval_s: float = 30.0
    # ---- online quality (shadow sampling) + SLOs
    shadow_oracle: Optional[object] = None  # (queries, k) -> (d, i)
    shadow_sample_rate: float = 0.0  # fraction of batches graded
    shadow_deadline_ms: float = 250.0
    shadow_queue_limit: int = 64
    shadow_seed: int = 0  # deterministic sampling draws (tests)
    slos: Optional[Tuple[object, ...]] = None  # obs.SLO objectives
    slo_window_s: float = 300.0
    # ---- adaptive planning: the JAX package's AdaptivePlanner hook; not
    # ported (ROADMAP Queue A item 10), so anything but None raises
    planner: Optional[object] = None


def _default_warm_buckets(max_batch: int) -> Tuple[int, ...]:
    """Every bucket shape a batch of 1..max_batch can land on."""
    out = []
    n = 1
    while True:
        b = query_bucket(min(n, max_batch))
        if b not in out:
            out.append(b)
        if n >= max_batch:
            break
        n = b + 1
    return tuple(out)


class Engine:
    """Micro-batching front end for one :class:`Searcher` handle."""

    def __init__(self, searcher: Searcher,
                 config: Optional[EngineConfig] = None,
                 clock=time.perf_counter):
        # reads outside the lock (submit/health) tolerate one-swap
        # staleness by design; every WRITE holds _swap_lock so a batch
        # runs whole on exactly one (searcher, gen) pair
        self._searcher = searcher  # guarded_by: _swap_lock
        self.config = config or EngineConfig()
        if self.config.planner is not None:
            raise NotImplementedError(
                "EngineConfig.planner: the adaptive planner is not ported "
                "yet (ROADMAP Queue A item 10)")
        self.clock = clock
        self.stats = ServingStats(window=self.config.stats_window,
                                  registry=self.config.registry)
        self.batcher = Batcher(self.config.max_batch,
                               self.config.max_wait_us,
                               self.config.queue_limit, clock)
        cfg = self.config
        high = cfg.queue_high_watermark
        if high is None:
            high = min(cfg.queue_limit, 16 * cfg.max_batch)
        self._high_watermark = max(int(high), 1)
        low = cfg.queue_low_watermark
        if low is None:
            low = self._high_watermark // 2
        self._low_watermark = min(max(int(low), 0),
                                  self._high_watermark - 1)
        self._shed_rng = _random.Random(cfg.shed_seed)
        self._admission_lock = threading.Lock()
        self._shedding = False  # guarded_by: _admission_lock
        self.breaker = CircuitBreaker(cfg.breaker_cooldown_s, clock)
        self._completion: _queue.Queue = _queue.Queue()
        self._inflight = threading.Semaphore(self.config.max_inflight)
        self._outstanding = 0  # guarded_by: _outstanding_cv
        self._outstanding_cv = threading.Condition()
        self._swap_lock = threading.Lock()
        self._calls_lock = threading.Lock()
        # id(call) -> live device-call record
        self._calls: dict = {}  # guarded_by: _calls_lock
        self._watchdog_stop = threading.Event()
        # start()-once lifecycle: thread handles and flags transition
        # a single time before/after the worker threads exist; readers
        # tolerate staleness (rebind of an immutable reference)
        self._dispatch_thread: Optional[
            threading.Thread] = None  # guarded_by: atomic
        self._completion_thread: Optional[
            threading.Thread] = None  # guarded_by: atomic
        self._watchdog_thread: Optional[
            threading.Thread] = None  # guarded_by: atomic
        self._started = False  # guarded_by: atomic
        # set by the dispatch thread once it has warmed every shape
        self._dispatch_warm = threading.Event()
        self._dispatch_warm_error: Optional[
            BaseException] = None  # guarded_by: atomic
        # the completion thread's copies to the host (CUDA only)
        self._readback_stream = None  # guarded_by: atomic
        self._stopped = False  # guarded_by: atomic
        self.warmup_info: dict = {}  # guarded_by: atomic (start() rebind)
        # ---- telemetry
        self._flight_ring: Optional[obs_spans.RingSink] = None
        if cfg.flight_recorder:
            # the tape tees to the user's sink, so installing the
            # recorder never displaces configured telemetry
            self._flight_ring = obs_spans.RingSink(
                cfg.flight_recorder_capacity, inner=cfg.span_sink)
            self._span_sink = self._flight_ring
        else:
            self._span_sink = cfg.span_sink
        # rebind-only: each dump publishes a fresh immutable doc
        self.last_diagnostics: Optional[dict] = None  # guarded_by: atomic
        self._last_dump_t: Optional[float] = None  # guarded_by: _dump_lock
        self._dump_lock = threading.Lock()
        self._batch_seq = itertools.count(1)
        self._searcher_gen = 0  # guarded_by: _swap_lock
        self.metrics_server: Optional[MetricsServer] = None
        budget_ms = cfg.deadline_budget_ms
        if budget_ms is None:
            budget_ms = max(10.0 * cfg.max_wait_us * 1e-3, 1.0)
        #: autoscale pressure denominator, ms
        self.autoscale_budget_ms = float(budget_ms)
        reg = self.stats.registry
        label = self.stats.engine_label
        reg.gauge(
            "raft_tpu_serving_autoscale_pressure",
            "p99 queue wait / deadline budget — the documented autoscale "
            "signal: sustained > 1.0 means coalescing cannot keep up and "
            "the replica set should grow. Windowed: reset_samples() "
            "re-baselines it, so the ratio falls again when load falls.",
            ("engine",)).labels(label).set_function(
                lambda: self.stats.queue_wait_p99_window_s() * 1e3
                / self.autoscale_budget_ms)
        reg.gauge(
            "raft_tpu_serving_queue_depth",
            "Requests admitted but not yet launched.",
            ("engine",)).labels(label).set_function(
                lambda: float(len(self.batcher)))
        # ---- online quality + SLOs
        self.shadow: Optional[obs_quality.ShadowSampler] = None
        if cfg.shadow_oracle is not None and cfg.shadow_sample_rate > 0:
            self.shadow = obs_quality.ShadowSampler(
                cfg.shadow_oracle, cfg.shadow_sample_rate,
                deadline_ms=cfg.shadow_deadline_ms,
                queue_limit=cfg.shadow_queue_limit,
                seed=cfg.shadow_seed,
                record_event=self.stats.record_shadow,
                span_sink=self._span_sink, engine_label=label,
                registry=reg)
        self.slo_monitor: Optional[obs_slo.SLOMonitor] = None
        if cfg.slos:
            self.slo_monitor = obs_slo.SLOMonitor(
                cfg.slos, label, registry=reg,
                # _auto_dump is already rate-limited, so a flapping
                # burn can't spam bundles even across SLOs
                on_fast_burn=lambda name, burn: self._auto_dump(
                    "slo_fast_burn"),
                window_s=cfg.slo_window_s)

    @property
    def searcher(self) -> Searcher:
        """The handle currently serving (atomically replaced by
        :meth:`swap_index`)."""
        return self._searcher

    def writer(self):
        """The mutable write surface behind the current searcher: not
        ported yet (the write path is ROADMAP Queue A item 11)."""
        raise NotImplementedError(
            "Engine.writer: the write path (MutableIvf) is not ported yet "
            "(ROADMAP Queue A item 11)")

    # ------------------------------------------------------------ lifecycle
    def _warm(self, searcher: Searcher) -> None:
        """Search every configured (bucket, k) shape on ``searcher`` with
        a zeros batch and wait for the card: loads each kernel library,
        sizes the caching allocator's blocks and draws per-shape state
        (CAGRA's seed tables) off the hot path. Runs on the thread that
        calls it: ``start()`` runs it on the caller's thread and on the
        dispatch thread, ``swap_index()`` on the caller's."""
        cfg = self.config
        buckets = cfg.warm_buckets or _default_warm_buckets(cfg.max_batch)
        for b in buckets:
            zeros = np.zeros((b, searcher.dim), searcher.query_dtype)
            for k in cfg.warm_ks:
                d, i = searcher.search(searcher.to_device(zeros), int(k))
                i.cpu()  # the fence: waits for the card

    def start(self) -> "Engine":
        """Build and warm everything, then start the dispatch/completion/
        watchdog threads. After ``start()`` returns, the first
        ``submit()`` builds no kernel, uploads no index and meets no cold
        shape on the dispatch thread."""
        if self._started:
            return self
        cfg = self.config
        t0 = self.clock()
        searcher = self._searcher
        on_cuda = searcher.device.type == "cuda"
        use_cache = on_cuda if cfg.persistent_cache is None \
            else bool(cfg.persistent_cache)
        c0 = compile_count()
        if on_cuda:
            from raft_tpu_torch.ops import gpu_kernels

            gpu_kernels.build_all()
            self._readback_stream = torch.cuda.Stream(searcher.device)
        n_placed = searcher.place()
        buckets = cfg.warm_buckets or _default_warm_buckets(cfg.max_batch)
        self._warm(searcher)
        self.stats.set_coverage(searcher.coverage)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="raft-tpu-serving-dispatch",
            daemon=True)
        self._completion_thread = threading.Thread(
            target=self._completion_loop, name="raft-tpu-serving-complete",
            daemon=True)
        self._dispatch_thread.start()
        # the dispatch thread warms every shape again on its own thread
        # before it takes the first batch; start() returns after that
        self._dispatch_warm.wait()
        if self._dispatch_warm_error is not None:
            self.batcher.stop(drain=False)
            self._dispatch_thread.join()
            raise RuntimeError("warming the dispatch thread failed") \
                from self._dispatch_warm_error
        self.warmup_info = {
            "warm_s": round(self.clock() - t0, 3),
            "buckets": list(buckets),
            "ks": list(cfg.warm_ks),
            "compiles": compile_count() - c0,
            "arrays_placed": n_placed,
            "persistent_cache": use_cache,
            "device": str(searcher.device),
        }
        self._completion_thread.start()
        if cfg.hang_timeout_s is not None:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, name="raft-tpu-serving-watchdog",
                daemon=True)
            self._watchdog_thread.start()
        if cfg.metrics_port is not None:
            self.serve_metrics(cfg.metrics_port, cfg.metrics_host)
        self._started = True
        return self

    def serve_metrics(self, port: int = 0,
                      host: str = "127.0.0.1") -> MetricsServer:
        """Expose this engine's registry at ``/metrics`` (Prometheus
        text), ``/metrics.json``, its :meth:`health` at ``/healthz``
        (200 for ok/degraded, 503 otherwise — the pre-flight curl), the
        SLO report at ``/slo`` and a fresh flight-recorder bundle at
        ``/debug/bundle``.
        ``port=0`` binds an ephemeral port; read
        ``engine.metrics_server.port``. Stopped by :meth:`stop`."""
        if self.metrics_server is None:
            self.metrics_server = MetricsServer(
                port, host, registry=self.stats.registry,
                health_fn=self.health,
                bundle_fn=lambda: self.dump_diagnostics(
                    reason="http"),
                slo_fn=(self.slo_monitor.report
                        if self.slo_monitor is not None
                        else None)).start()
        return self.metrics_server

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # -------------------------------------------------------------- client
    def submit(self, query, k: int, block: bool = True,
               timeout: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one query (host array or list); the Future resolves to
        ``(distances [k], indices [k])`` numpy rows, bit-identical to a
        solo search at the batch's bucket.

        ``timeout`` bounds ADMISSION only (waiting for queue space with
        ``block=True``); the returned future's ``.result(timeout)`` is a
        separate completion bound — :meth:`search` ties both to one
        end-to-end deadline. ``deadline_ms`` is the shed deadline: a
        request still queued when it expires fails with
        :class:`~raft_tpu_torch.serving.batcher.DeadlineExceeded` instead of
        launching (typed, never silent).

        Raises :class:`EngineStopped` after :meth:`stop`, ``QueueFull``
        when ``block=False`` and the admission queue is at capacity,
        :class:`Overloaded` when the admission controller is shedding
        (queue depth latched over ``queue_high_watermark``, or the
        probability ramp fired), and :class:`CircuitOpen` while the
        breaker holds the device path open after a hang."""
        # trace id minted HERE — rejections are traced too, so a span
        # file reconciles 1:1 with the typed-outcome counters
        trace_id = obs_spans.new_trace_id()
        t0 = self.clock()
        try:
            if not self._started or self._stopped:
                raise EngineStopped("engine not running; call start()")
            self._admit()
        except (EngineStopped, Overloaded) as e:
            self._emit_reject(trace_id, t0, k, e)
            raise
        searcher = self._searcher
        q = np.asarray(query, searcher.query_dtype)
        if q.ndim == 2 and q.shape[0] == 1:
            q = q[0]
        if q.shape != (searcher.dim,):
            raise ValueError(
                f"query shape {q.shape} != ({searcher.dim},)")
        fut: Future = Future()
        fut.trace_id = trace_id
        now = self.clock()
        t_deadline = None
        if deadline_ms is not None:
            t_deadline = now + float(deadline_ms) * 1e-3
        req = Request(q, int(k), fut, now, t_deadline, trace_id=trace_id)
        with self._outstanding_cv:
            self._outstanding += 1
        try:
            self.batcher.put(req, block=block, timeout=timeout)
        except BaseException as e:
            self._resolve(1)
            if isinstance(e, (QueueFull, EngineStopped)):
                self._emit_reject(trace_id, t0, k, e)
            raise
        req.t_admit = self.clock()
        self.stats.record_submit()
        return fut

    def _admit(self) -> None:
        """Admission controller: breaker first (a sick device sheds
        everything), then the latched watermark, then the optional
        probability ramp. All rejections are typed and counted."""
        if not self.breaker.admit():
            self.stats.record_rejected("breaker")
            raise CircuitOpen(
                f"circuit breaker open after a device hang; probes resume "
                f"after breaker_cooldown_s={self.breaker.cooldown_s}")
        depth = len(self.batcher)
        high, low = self._high_watermark, self._low_watermark
        with self._admission_lock:
            if self._shedding and depth <= low:
                self._shedding = False
            elif not self._shedding and depth >= high:
                self._shedding = True
            if self._shedding:
                self.stats.record_rejected("overload")
                raise Overloaded(
                    f"shedding: queue depth {depth} latched over high "
                    f"watermark {high} (resumes at {low})")
            if self.config.shed_ramp and depth > low:
                p = (depth - low) / max(high - low, 1)
                if self._shed_rng.random() < p:
                    self.stats.record_rejected("overload")
                    raise Overloaded(
                        f"shed ramp: queue depth {depth} in "
                        f"[{low}, {high}), shed probability {p:.2f}")

    def search(self, query, k: int, timeout: Optional[float] = None,
               deadline_ms: Optional[float] = None):
        """Blocking convenience with ONE end-to-end deadline.

        The split ``submit`` documents — admission ``timeout`` vs the
        future's own ``result(timeout)`` — is closed here: with
        ``deadline_ms`` set, admission wait, queue time, and device time
        all draw from the same budget and the call NEVER blocks past it.
        Still queued at expiry → the batcher sheds it
        (:class:`~raft_tpu_torch.serving.batcher.DeadlineExceeded`); launched
        but unfinished → the wait is abandoned with the same typed
        :class:`DeadlineExceeded` (the device result, when it lands, is
        discarded). ``timeout`` alone keeps the legacy behavior of
        bounding only the result wait."""
        if deadline_ms is None:
            return self.submit(query, k, timeout=timeout).result(timeout)
        t0 = self.clock()
        budget_s = float(deadline_ms) * 1e-3
        fut = self.submit(query, k, timeout=budget_s,
                          deadline_ms=deadline_ms)
        remaining = budget_s - (self.clock() - t0)
        try:
            return fut.result(max(remaining, 0.0))
        except _FuturesTimeout:
            fut.cancel()  # un-launched: dispatch drops it at pickup
            raise DeadlineExceeded(
                f"no result within deadline_ms={deadline_ms}") from None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has resolved. True on
        success, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._outstanding_cv:
            while self._outstanding > 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._outstanding_cv.wait(remaining)
        return True

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the engine. ``drain=True`` flushes queued + in-flight
        requests first (flush deadlines voided — everything launches
        immediately; shed deadlines still apply at launch);
        ``drain=False`` cancels queued requests (their futures get
        :class:`EngineStopped`) but still completes batches already
        launched."""
        if not self._started or self._stopped:
            self._stopped = True
            return
        self._stopped = True
        cancelled = self.batcher.stop(drain)
        for r in cancelled:
            if not r.future.cancel():
                with contextlib.suppress(InvalidStateError):
                    r.future.set_exception(
                        EngineStopped("engine stopped before launch"))
        for r in cancelled:
            self._emit_request_outcome(r, "cancelled", where="stop")
        if cancelled:
            self.stats.record_cancelled(len(cancelled))
            self._resolve(len(cancelled))
        if self._dispatch_thread is not None:
            self._dispatch_thread.join(timeout)
        if self._completion_thread is not None:
            self._completion_thread.join(timeout)
        self._watchdog_stop.set()
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout)
        if self.shadow is not None:
            self.shadow.close()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None

    # ------------------------------------------------------------ hot swap
    def swap_index(self, searcher: Searcher, warm: bool = True) -> Searcher:
        """Atomically replace the serving index with ``searcher`` — zero
        dropped requests, zero cold compiles on the hot path.

        The new index is placed on its device and (with ``warm``) every
        configured (bucket, k) shape is searched on the CALLER's thread
        while the old index keeps serving; only then is the handle
        swapped under the dispatch lock, so every batch runs whole on
        exactly one index (its identity rides ``future.searcher`` for
        the exactness oracle). Queued requests simply launch on the new
        index. Returns the old handle.

        Coverage transitions are recorded in
        ``stats.coverage_transitions``."""
        if self._stopped:
            raise EngineStopped("engine is stopped")
        # snapshot for validation only: dim/query_dtype are invariant
        # across swaps, so a concurrent swap can't invalidate the check
        snap = self._searcher
        if searcher.dim != snap.dim:
            raise ValueError(
                f"swap_index dim mismatch: {searcher.dim} != {snap.dim}")
        if searcher.query_dtype != snap.query_dtype:
            raise ValueError(
                f"swap_index query_dtype mismatch: {searcher.query_dtype}"
                f" != {snap.query_dtype}")
        if searcher.device != snap.device:
            raise ValueError(
                f"swap_index device mismatch: {searcher.device} != "
                f"{snap.device} (the readback stream is the old device's)")
        searcher.place()
        if warm and self._started:
            self._warm(searcher)
        with self._swap_lock:
            # capture the outgoing handle under the lock so the
            # (old, new) coverage transition pairs correctly even when
            # two swaps race
            old = self._searcher
            self._searcher = searcher
            self._searcher_gen += 1
            gen = self._searcher_gen
        self.stats.record_swap(old.coverage, searcher.coverage)
        self._emit({"kind": "swap", "engine": self.stats.engine_label,
                    "searcher_gen": gen,
                    "old_coverage": round(float(old.coverage), 6),
                    "new_coverage": round(float(searcher.coverage), 6)})
        return old

    @property
    def searcher_generation(self) -> int:
        """Monotonic swap count: 0 for the boot searcher, +1 per
        :meth:`swap_index`. Rides every ``kind="swap"`` and batch span
        as ``searcher_gen``."""
        with self._swap_lock:
            return self._searcher_gen

    # -------------------------------------------------------------- health
    def health(self) -> dict:
        """Liveness summary for external probes: ``status`` is ``"ok"``
        (serving, breaker closed, full coverage), ``"degraded"``
        (serving but shedding, breaker half-open, or coverage < 1.0 from
        a partial restore), or ``"unhealthy"`` (not running, or breaker
        open after a hang)."""
        breaker = self.breaker.state
        with self._admission_lock:
            shedding = self._shedding
        coverage = self._searcher.coverage
        if not self._started or self._stopped or breaker == "open":
            status = "unhealthy"
        elif breaker == "half_open" or shedding or coverage < 1.0:
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "running": self._started and not self._stopped,
            "breaker": breaker,
            "shedding": shedding,
            "queue_depth": len(self.batcher),
            "coverage": coverage,
            "n_batch_errors": self.stats.n_batch_errors,
            "n_hangs": self.stats.n_hangs,
        }

    # ---------------------------------------------------- flight recorder
    def _config_doc(self) -> dict:
        """The effective config as JSON-safe primitives (objects like
        sinks/registries degrade to their repr)."""
        out = {}
        for f in dataclasses.fields(self.config):
            v = getattr(self.config, f.name)
            if v is None or isinstance(v, (bool, int, float, str)):
                out[f.name] = v
            elif isinstance(v, (tuple, list)):
                out[f.name] = list(v)
            else:
                out[f.name] = repr(v)
        return out

    def dump_diagnostics(self, reason: str = "manual",
                         dir_path: Optional[str] = None) -> dict:
        """Freeze the flight-recorder state into a diagnostics bundle:
        the span tape (last N records), a full registry snapshot,
        ``health()``, and the effective config. Returns the bundle doc
        (also kept as ``last_diagnostics``); when ``dir_path`` (or
        ``EngineConfig.diagnostics_dir``) is set the bundle is also
        written there atomically and the doc carries its ``"path"``.

        Safe to call from any thread at any time — including while the
        dispatch loop is wedged on a hung device call, which is the
        moment it exists for (the watchdog calls this after tripping
        the breaker)."""
        spans = (self._flight_ring.records
                 if self._flight_ring is not None else [])
        extra = None
        if self._flight_ring is not None:
            extra = {"ring_capacity": self._flight_ring.capacity,
                     "ring_emitted": self._flight_ring.emitted,
                     "ring_dropped": self._flight_ring.dropped}
        doc = obs_diagnostics.build_bundle(
            reason=reason, spans=spans, registry=self.stats.registry,
            health=self.health(), config=self._config_doc(), extra=extra)
        target = dir_path if dir_path is not None \
            else self.config.diagnostics_dir
        if target is not None:
            try:
                doc["path"] = obs_diagnostics.write_bundle(target, doc)
            except OSError as e:  # recorder must never take serving down
                doc["path_error"] = f"{type(e).__name__}: {e}"
        self.last_diagnostics = doc
        self.stats.registry.counter(
            "raft_tpu_serving_diagnostics_dumps_total",
            "Flight-recorder bundles written, by trigger.",
            ("engine", "reason")).labels(
                self.stats.engine_label, reason).inc()
        return doc

    def _auto_dump(self, reason: str) -> None:
        """Rate-limited dump from the failure paths (watchdog hang,
        breaker open): at most one bundle per
        ``diagnostics_min_interval_s`` so a flapping breaker can't
        drown the disk, and never an exception out."""
        now = self.clock()
        with self._dump_lock:
            min_gap = self.config.diagnostics_min_interval_s
            if (self._last_dump_t is not None
                    and now - self._last_dump_t < min_gap):
                return
            self._last_dump_t = now
        try:
            self.dump_diagnostics(reason=reason)
        except Exception:
            # never an exception out of a failure path, but a recorder
            # that cannot record is itself an incident signal
            self.stats.registry.counter(
                "raft_tpu_serving_diagnostics_dump_errors_total",
                "Flight-recorder bundles that failed to freeze.",
                ("engine", "reason")).labels(
                    self.stats.engine_label, reason).inc()

    def _on_batch_failure(self, epoch: Optional[int] = None) -> None:
        """Report a failed batch to the breaker; when that re-opens it
        (a half-open probe failed), freeze a bundle — the operator will
        want the spans from the probe that kept the breaker open.

        ``epoch`` is the breaker epoch stamped at batch LAUNCH (see
        ``CircuitBreaker.on_batch_result``): a late result from a batch
        launched before the last trip says nothing about current device
        health and must not flip the breaker state."""
        self.breaker.on_batch_result(False, epoch)
        if self.breaker.state == "open":
            self._auto_dump("breaker_open")

    # ------------------------------------------------------------- internal
    def _resolve(self, n: int) -> None:
        with self._outstanding_cv:
            self._outstanding -= n
            if self._outstanding <= 0:
                self._outstanding_cv.notify_all()

    # ---- span emission: every emitter funnels through safe_emit, so a
    # raising sink is counted + silenced — telemetry never fails serving
    def _emit(self, record: dict) -> None:
        obs_spans.safe_emit(self._span_sink, record)

    def _emit_reject(self, trace_id: str, t_start: float, k: int,
                     exc: BaseException) -> None:
        """Request span for a submission that never entered the queue —
        the typed admission rejections, reconciled 1:1 with the
        ``rejected_*`` counters."""
        if self._span_sink is None:
            return
        if isinstance(exc, CircuitOpen):
            outcome = "rejected_breaker"
        elif isinstance(exc, Overloaded):
            outcome = "rejected_overload"
        elif isinstance(exc, QueueFull):
            outcome = "rejected_queue_full"
        else:
            outcome = "rejected_stopped"
        self._emit({
            "kind": "request", "trace_id": trace_id,
            "engine": self.stats.engine_label, "k": int(k),
            "outcome": outcome,
            "total_ms": round((self.clock() - t_start) * 1e3, 3),
            "error": f"{type(exc).__name__}: {exc}"})

    def _emit_request_outcome(self, req: Request, outcome: str,
                              **extra) -> None:
        """Terminal span record for an admitted request: the phase
        decomposition (admission/queue, plus whatever ``extra`` the
        call site knows — pad/copy, device, readback, batch
        breadcrumbs) and the typed outcome."""
        if self._span_sink is None:
            return
        rec = {"kind": "request", "trace_id": req.trace_id,
               "engine": self.stats.engine_label, "k": req.k,
               "outcome": outcome,
               "total_ms": round((self.clock() - req.t_submit) * 1e3, 3)}
        if req.t_admit is not None:
            rec["admission_ms"] = round(
                (req.t_admit - req.t_submit) * 1e3, 3)
        if req.t_launch is not None:
            t_q0 = req.t_admit if req.t_admit is not None else req.t_submit
            rec["queue_ms"] = round((req.t_launch - t_q0) * 1e3, 3)
        rec.update(extra)
        self._emit(rec)

    def _fail_requests(self, reqs: Sequence[Request], exc: BaseException,
                       hang: bool = False,
                       meta: Optional[dict] = None) -> int:
        """Resolve ``reqs``'s still-pending futures with ``exc`` (typed,
        never silent) and settle the outstanding count for exactly the
        ones this call transitioned — safe to race the watchdog and the
        completion thread. ``meta`` is the batch breadcrumb dict for the
        span records (may be None before padding built one)."""
        failed = 0
        outcome = "hang" if hang else "batch_failed"
        err = f"{type(exc).__name__}: {exc}"
        for r in reqs:
            with contextlib.suppress(InvalidStateError):
                r.future.set_exception(exc)
                failed += 1
                self._emit_request_outcome(r, outcome, error=err,
                                           **(meta or {}))
        if failed:
            self.stats.record_batch_failed(failed, hang=hang)
            self._resolve(failed)
            if self._span_sink is not None:
                rec = {"kind": "batch",
                       "engine": self.stats.engine_label,
                       "outcome": outcome, "error": err,
                       "trace_ids": [r.trace_id for r in reqs]}
                rec.update(meta or {})
                self._emit(rec)
        return failed

    def _shed_expired(self) -> None:
        """Fail the requests the batcher pruned for blowing their
        ``deadline_ms`` — typed DeadlineExceeded, counted in stats."""
        expired = self.batcher.pop_expired()
        if not expired:
            return
        now = self.clock()
        shed = 0
        for r in expired:
            waited_ms = (now - r.t_submit) * 1e3
            with contextlib.suppress(InvalidStateError):
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed before launch (queued "
                    f"{waited_ms:.1f} ms)"))
                shed += 1
                self._emit_request_outcome(
                    r, "shed_deadline",
                    shed_after_ms=round(waited_ms, 3))
        if shed:
            self.stats.record_shed_deadline(shed)
            self._resolve(shed)

    # ---- device-call tracking (watchdog protocol): both loops bracket
    # their blocking device interaction in a call record; the watchdog
    # fails any record older than hang_timeout_s and marks it hung so the
    # stuck thread discards the late result when (if) the call returns.
    def _begin_device_call(self, reqs: List[Request], where: str,
                           meta: Optional[dict] = None) -> dict:
        call = {"t0": self.clock(), "reqs": reqs, "where": where,
                "hung": False, "meta": meta}
        with self._calls_lock:
            self._calls[id(call)] = call
        return call

    def _end_device_call(self, call: dict) -> bool:
        """Unregister; True when the watchdog already failed this call's
        batch (the caller must discard the result and not re-resolve)."""
        with self._calls_lock:
            self._calls.pop(id(call), None)
            return call["hung"]

    def _watchdog_loop(self) -> None:
        timeout = self.config.hang_timeout_s
        poll = max(min(timeout / 4.0, 0.25), 0.01)
        while not self._watchdog_stop.wait(poll):
            now = self.clock()
            with self._calls_lock:
                overdue = [c for c in self._calls.values()
                           if not c["hung"] and now - c["t0"] >= timeout]
                for c in overdue:
                    c["hung"] = True
            for c in overdue:
                self.breaker.trip()
                self.stats.record_breaker_trip()
                self._fail_requests(
                    c["reqs"],
                    BatchFailed(
                        f"device call ({c['where']}) exceeded "
                        f"hang_timeout_s={timeout}; circuit breaker "
                        f"opened",
                        cause=TimeoutError(f"hung > {timeout}s"),
                        hang=True),
                    hang=True, meta=c["meta"])
            if overdue:
                # freeze the tape AFTER the hang spans land on it, so
                # the bundle explains itself (the dispatch thread is
                # still wedged on the device — this thread is the only
                # one that can record what happened)
                self._auto_dump("watchdog_hang")

    # ------------------------------------------------------------ the loops
    def _dispatch_loop(self) -> None:
        try:
            self._warm(self._searcher)
        except BaseException as e:  # noqa: B036 — relayed by start()
            self._dispatch_warm_error = e
            return
        finally:
            self._dispatch_warm.set()
        while True:
            reqs = self.batcher.take(block=True)
            if reqs is None:  # stopping and drained
                self._shed_expired()  # sheds pruned on the final take
                self._completion.put(None)
                return
            # requests that blew their deadline_ms never launch — they
            # fail HERE, promptly and typed (take() wakes for them)
            self._shed_expired()
            if not reqs:
                continue
            try:
                self._dispatch_batch(reqs)
            except BaseException as e:  # noqa: B036 — containment: the
                # loop survives anything; only this batch's riders fail
                self._fail_requests(
                    reqs, BatchFailed("dispatch failed", cause=e))
                self._on_batch_failure()

    def _dispatch_batch(self, reqs: List[Request]) -> None:
        # honor client-side Future.cancel() before paying the launch
        live: List[Request] = []
        for r in reqs:
            if r.future.set_running_or_notify_cancel():
                live.append(r)
            else:
                self._emit_request_outcome(r, "cancelled", where="pickup")
        if len(live) < len(reqs):
            self.stats.record_cancelled(len(reqs) - len(live))
            self._resolve(len(reqs) - len(live))
        if not live:
            return
        # pipelining cap: at most max_inflight launched-unread batches
        self._inflight.acquire()
        t_launch = self.clock()
        for r in live:
            r.t_launch = t_launch
        # snapshot the searcher under the swap lock: a concurrent
        # swap_index lands BETWEEN batches, never mid-batch
        with self._swap_lock:
            searcher = self._searcher
            gen = self._searcher_gen
        # pad to the bucket HERE (host-side zeros): every launch is one of
        # the warmed shapes, and a row's neighbours are zeros or riders
        bucket = query_bucket(len(live))
        # batch breadcrumbs: ride Batch.meta to the completion thread
        # and into every rider's span record
        meta = {"batch_id": next(self._batch_seq), "bucket": bucket,
                "batch_size": len(live), "searcher_gen": gen,
                "coverage": round(float(searcher.coverage), 6),
                # launch-time breaker epoch: a result from a batch
                # launched before a trip must not flip breaker state
                "breaker_epoch": self.breaker.epoch}
        try:
            t_pad0 = self.clock()
            batch = np.zeros((bucket, searcher.dim), searcher.query_dtype)
            for j, r in enumerate(live):
                batch[j] = r.query
            meta["pad_copy_ms"] = round((self.clock() - t_pad0) * 1e3, 3)
            call = self._begin_device_call(live, "dispatch", meta)
            events = None
            try:
                # execution-plan attribution: every family search records
                # its decision into the open capture; briefs ride batch
                # meta into every rider's span record. The batch's lead
                # trace id is visible to deep emitters for the call.
                with obs_spans.trace_scope(live[0].trace_id), \
                        obs_explain.capture() as cap, \
                        _device_scope(searcher.device):
                    t_stage = self.clock()
                    queries = searcher.to_device(batch)
                    if searcher.device.type == "cuda":
                        events = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                        events[0].record()
                    d, i = searcher.search(queries, live[0].k)
                    if events is not None:
                        events[1].record()
                    meta["host_return_ms"] = round(
                        (self.clock() - t_stage) * 1e3, 3)
                if cap.records:
                    meta["explain"] = cap.briefs()
            finally:
                hung = self._end_device_call(call)
        except BaseException as e:  # noqa: B036 — relay to callers
            self._inflight.release()
            self._fail_requests(live, BatchFailed("dispatch failed",
                                                  cause=e), meta=meta)
            self._on_batch_failure(meta.get("breaker_epoch"))
            return
        if hung:
            # the watchdog already failed these futures and settled the
            # accounting while the call was stuck; drop the late result
            self._inflight.release()
            return
        self._completion.put(Batch(live, d, i, t_launch, bucket, searcher,
                                   meta, events))

    def _completion_loop(self) -> None:
        while True:
            b = self._completion.get()
            if b is None:
                return
            call = self._begin_device_call(b.requests, "readback", b.meta)
            event_ms = None
            try:
                # the serving host sync BY DESIGN: one readback completes
                # batch N while the dispatch thread stages batch N+1
                if b.events is not None:
                    b.events[1].synchronize()
                    event_ms = b.events[0].elapsed_time(b.events[1])
                t_read0 = self.clock()
                d_np, i_np = self._readback(b)
            except BaseException as e:  # noqa: B036 — relay to callers
                self._end_device_call(call)
                self._inflight.release()
                self._fail_requests(
                    b.requests, BatchFailed("readback failed", cause=e),
                    meta=b.meta)
                self._on_batch_failure(
                    b.meta.get("breaker_epoch") if b.meta else None)
                continue
            t_read1 = self.clock()
            hung = self._end_device_call(call)
            self._inflight.release()
            if hung:
                continue  # watchdog failed + settled them; discard rows
            t_done = self.clock()
            # phase decomposition for the span records: device is
            # launch → readback start (the batch's event has fired),
            # readback is the copy to the host itself
            meta = dict(b.meta or {})
            meta["device_ms"] = round((t_read0 - b.t_launch) * 1e3, 3)
            meta["readback_ms"] = round((t_read1 - t_read0) * 1e3, 3)
            if event_ms is not None:
                meta["device_event_ms"] = round(event_ms, 4)
            resolved = 0
            for j, r in enumerate(b.requests):
                # placement breadcrumbs for the exactness oracle
                # (solo_reference needs the row + bucket + the index
                # that actually served — swaps change it mid-run)
                r.future.placement = (j, b.bucket)
                r.future.searcher = b.searcher
                with contextlib.suppress(InvalidStateError):
                    r.future.set_result((d_np[j], i_np[j]))
                    resolved += 1
                    self._emit_request_outcome(r, "ok", **meta)
            if self.shadow is not None and resolved:
                # the answers just served, offered for grading AFTER the
                # futures resolved — a slow/hung oracle can never delay
                # a caller, only fill the shadow queue (typed sheds)
                self.shadow.offer(
                    [r.query for r in b.requests],
                    [i_np[j] for j in range(len(b.requests))],
                    [r.trace_id for r in b.requests],
                    [r.k for r in b.requests],
                    b.searcher.family, b.bucket)
            self.breaker.on_batch_result(
                True, b.meta.get("breaker_epoch") if b.meta else None)
            self.stats.record_batch(
                len(b.requests), b.bucket,
                [b.t_launch - r.t_submit for r in b.requests],
                t_done - b.t_launch,
                [t_done - r.t_submit for r in b.requests])
            if self._span_sink is not None:
                rec = {"kind": "batch",
                       "engine": self.stats.engine_label, "outcome": "ok",
                       "trace_ids": [r.trace_id for r in b.requests],
                       "batch_ms": round((t_done - b.t_launch) * 1e3, 3)}
                rec.update(meta)
                self._emit(rec)
            self._resolve(resolved)


    def _readback(self, b: Batch) -> Tuple[np.ndarray, np.ndarray]:
        """The batch's rows on the host. On CUDA the copy runs on the
        readback stream after it has waited for the batch's event."""
        if b.events is None:
            return b.distances.numpy(), b.indices.numpy()
        stream = self._readback_stream
        with torch.cuda.stream(stream):
            stream.wait_event(b.events[1])
            return b.distances.cpu().numpy(), b.indices.cpu().numpy()


def _device_scope(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def solo_reference(searcher: Searcher, query, k: int, row: int,
                   bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """The engine's exactness oracle: search ``query`` ALONE in a
    zero-padded batch of ``bucket`` rows at row ``row`` — the same
    shape, and row position a coalesced batch uses, with no other live
    queries. A coalesced request's result must be bit-identical to this
    (proves riders never leak into each other's rows)."""
    q = np.zeros((bucket, searcher.dim), searcher.query_dtype)
    q[row] = np.asarray(query, searcher.query_dtype)
    d, i = searcher.search(searcher.to_device(q), int(k))
    return d[row].cpu().numpy(), i[row].cpu().numpy()


def verify_bit_identity(searcher: Searcher, queries: Sequence,
                        results: Sequence, k: int,
                        placements: Sequence[Tuple[int, int]]) -> int:
    """Count mismatches between engine ``results`` (rows of (d, i)) and
    the :func:`solo_reference` oracle; ``placements`` are the futures'
    ``(row, bucket)`` breadcrumbs."""
    bad = 0
    for query, (d_row, i_row), (row, bucket) in zip(queries, results,
                                                    placements):
        d_ref, i_ref = solo_reference(searcher, query, k, row, bucket)
        if not (np.array_equal(d_row, d_ref)
                and np.array_equal(i_row, i_ref)):
            bad += 1
    return bad
