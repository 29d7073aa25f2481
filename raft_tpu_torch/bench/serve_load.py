"""Closed-loop single-query load against a serving ``Engine`` or ``Fleet``.

``closed_loop`` runs ``n_threads`` submitter threads; each submits one
query, waits for its result, then submits the next, until every query has
been served once. Against a fleet (``typed=True``) a request that fails
typed (a shed, a failure after retries, a stopped replica) is counted
under its ``failure_kind`` instead of stopping the load. ``summarize``
turns the run and the engine's batch spans into the serving figures
``chip_smoke.py`` prints: QPS, p50/p99 latency,
mean batch size and bucket histogram, a batch's mean phases (pad and copy
on the host, host return of the search call, launch to results ready,
readback, launch to futures resolved) and CUDA-event device time, and the
device busy share (the batches' CUDA-event time over the load's wall
time; batches of one engine run on one stream, so their event spans do
not overlap).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from raft_tpu_torch.serving.stats import percentiles


class BatchSink:
    """Span sink that keeps only batch records (request records are
    built anyway, for the flight recorder, and dropped here)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.batches: List[dict] = []  # guarded_by: _lock

    def emit(self, record: dict) -> None:
        if record.get("kind") == "batch":
            with self._lock:
                self.batches.append(record)

    def take(self) -> List[dict]:
        with self._lock:
            out, self.batches = self.batches, []
            return out


def closed_loop(engine, queries: np.ndarray, k: int, n_threads: int,
                timeout: float = 120.0,
                deadlines_ms: Optional[Sequence[Optional[float]]] = None,
                typed: bool = False) -> Dict[str, object]:
    """Serve every row of ``queries`` once through ``engine`` (an Engine
    or a Fleet), one request at a time per thread (thread t takes rows t,
    t + n_threads, ...), row j with ``deadlines_ms[j]`` when given.
    Returns the wall seconds, per-query latencies (s), result rows,
    placements, the handle that served each request (``searchers``, None
    where the future names none), the operating point each request's
    batch was served with (``params``, None without a planner), which
    requests were shed past their deadline (``shed``), which failed typed
    (``failed``, only with ``typed``) and the outcome counts by kind
    (``outcomes``: ``"ok"`` and ``failure_kind``'s labels)."""
    from raft_tpu_torch.serving.batcher import DeadlineExceeded
    from raft_tpu_torch.serving.router import failure_kind

    n = queries.shape[0]
    lat = np.zeros(n)
    ids = np.zeros((n, k), np.int32)
    dists = np.zeros((n, k), np.float32)
    placements: List[tuple] = [None] * n
    params: List[Optional[dict]] = [None] * n
    searchers: List[object] = [None] * n
    shed = np.zeros(n, bool)
    failed = np.zeros(n, bool)
    kinds: List[str] = ["ok"] * n
    errors: List[BaseException] = []

    def worker(t: int) -> None:
        try:
            for j in range(t, n, n_threads):
                t0 = time.perf_counter()
                fut = engine.submit(queries[j], k, deadline_ms=(
                    None if deadlines_ms is None else deadlines_ms[j]))
                try:
                    d, i = fut.result(timeout=timeout)
                except DeadlineExceeded:
                    shed[j] = True
                    kinds[j] = "deadline"
                    continue
                except BaseException as e:  # noqa: B036 — typed or raised
                    if not typed or failure_kind(e) == "other":
                        raise
                    failed[j] = True
                    kinds[j] = failure_kind(e)
                    continue
                finally:
                    lat[j] = time.perf_counter() - t0
                dists[j], ids[j] = d, i
                placements[j] = getattr(fut, "placement", None)
                searchers[j] = getattr(fut, "searcher", None)
                params[j] = getattr(fut, "params", None)
        except BaseException as e:  # noqa: B036 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout * n)
    seconds = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} submitter(s) failed") \
            from errors[0]
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a submitter thread did not finish")
    outcomes: Dict[str, int] = {}
    for kind in kinds:
        outcomes[kind] = outcomes.get(kind, 0) + 1
    return {"seconds": seconds, "latencies_s": lat, "ids": ids,
            "distances": dists, "placements": placements,
            "searchers": searchers, "params": params, "shed": shed,
            "failed": failed, "outcomes": outcomes}


def summarize(run: Dict[str, object], batches: List[dict]) -> dict:
    """The serving figures of one run and its batch spans."""
    n = len(run["latencies_s"])
    lat_ms = percentiles(list(run["latencies_s"] * 1e3), (50.0, 99.0))
    sizes = [b["batch_size"] for b in batches]
    buckets: Dict[int, int] = {}
    for b in batches:
        buckets[b["bucket"]] = buckets.get(b["bucket"], 0) + 1
    host = [b["host_return_ms"] for b in batches]
    dev = [b["device_event_ms"] for b in batches if "device_event_ms" in b]
    out = {
        "requests": n, "seconds": run["seconds"],
        "qps": n / run["seconds"],
        "p50_ms": lat_ms["p50"], "p99_ms": lat_ms["p99"],
        "batches": len(batches),
        "mean_batch_size": float(np.mean(sizes)) if sizes else 0.0,
        "bucket_hist": dict(sorted(buckets.items())),
        "host_return_ms_p50": percentiles(host, (50.0,))["p50"],
    }
    for key in ("pad_copy_ms", "host_return_ms", "device_ms", "readback_ms",
                "batch_ms"):
        vals = [b[key] for b in batches if key in b]
        out[f"{key}_mean"] = float(np.mean(vals)) if vals else None
    if dev:
        out.update(device_event_ms_mean=float(np.mean(dev)),
                   device_event_ms_p50=percentiles(dev, (50.0,))["p50"],
                   device_busy_share=sum(dev) / (run["seconds"] * 1e3))
    return out
