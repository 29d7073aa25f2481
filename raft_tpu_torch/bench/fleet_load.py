"""Phase 6g of ``chip_smoke.py``: the replica fleet on the card.

``phase(...)`` drives, at the first configuration's full width (1,000,000 ×
128 rows, 10,000 queries, k=10):

- ``fleet``: three replicas in this process (quorum 2), each its own
  searcher handle over the one IVF-Flat index on the card, behind
  ``serving.Fleet`` with ``EngineConfig(max_batch=64, max_wait_us=2000,
  warm_ks=(10,))`` (and a breaker cooldown short enough to re-admit inside
  the load). The queries go through it once from 8 and once from 64
  closed-loop submitters (``chip_smoke.py`` passes phase 6b's 3,000). During
  the first load one replica's breaker is
  tripped (``faults.trip_breaker``) and must be re-admitted through the
  router's probe; during the second, ``rolling_swap`` moves every replica
  to a fresh handle at 16 probes and then ``faults.kill_replica`` stops one
  with ``drain=False``. A sampler reads the healthy in-service count
  throughout. Checked: every request resolves to exactly one outcome and
  the outcome counters and ``kind="fleet"`` spans reconcile with
  ``submitted``; no future is left pending; 0 of 256 sampled ok rows
  differ from ``solo_reference`` on the handle that served them; 0 kernel
  builds after ``start()``; the healthy count never below quorum; the
  tripped replica's breaker closed by a request the router routed to it
  (recorded beside it: how many it got afterwards); recall@10
  of the first load (all of it before the swap) equal to the single
  engine's at the same probes (phase 6b's).
- ``remote_fleet``: two ``replica_main`` children on the card (``python -m
  raft_tpu_torch.serving.replica_main --family ivf_flat --dim 128 --rows
  1000000 --n-lists 1024 --max-batch 64 ...``, started with
  ``subprocess.Popen``, never forked from this CUDA process), each building
  the seeded spec; this process builds the same spec as the reference.
  Checked: 1,000 queries through a fleet of the two bitwise this process's
  ``solo_reference`` at each reply's placement; one child SIGKILLed
  mid-load with exact typed accounting (the supervisor's
  ``mark_peer_dead`` follows the death, and ``remove_replica`` takes it
  out after the load); ``Autoscaler.on_fast_burn``
  spawning a third child through a real ``spawn`` and retiring it through
  the ``stop`` op's drain handshake (exit 0), the lifecycle counters equal
  to the ``kind="autoscale"`` spans; the surviving child swapped by
  ``RemoteReplica.swap_index`` to the ``brute_force`` spec of the same rows
  and its answers bitwise this process's brute force; each child's
  ``scrape`` op showing 0 kernel builds and the fused route
  (``raft_tpu_dispatch_total``, reason ``auto_fused_wins``).
  Recorded: each child's seconds from start to ``REPLICA_READY``, the round
  trip p50/p99 of a search RPC and of a ``hello`` RPC (the host's cost),
  QPS.

The frontend's kernel launches are counted inside the in-process loads
only (``fleet_launches`` on the kernels line).

Standalone (builds its own data, index, ground truth and single-engine
recall first)::

    python3 -m raft_tpu_torch.bench.fleet_load [--seed N] [--only fleet|remote]
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 10_000, 10
N_LISTS = 1024
N_REPLICAS, QUORUM = 3, 2
LOADS = (8, 64)
SAMPLE = 256
SWAP_PROBES = 16
#: the breaker's cooldown and the router's probe interval: short enough
#: that a tripped replica comes back inside one load
BREAKER_COOLDOWN_S, PROBE_INTERVAL_S = 0.5, 0.2
#: when the faults land, as shares of their load's requests completed
TRIP_AT, SWAP_AT, KILL_AT = 0.1, 0.2, 0.6
#: the remote part: queries held bitwise, queries of the kill load (the
#: kill after KILL9_AT of them), RPCs timed one at a time
REMOTE_QUERIES, KILL9_QUERIES, KILL9_AT, RTT_CALLS = 1_000, 2_000, 300, 200
CHILD_READY_S, RPC_TIMEOUT_S, SWAP_TIMEOUT_S = 600.0, 10.0, 300.0
FUSED_REASON = "auto_fused_wins"


# ------------------------------------------------------------------ helpers


class FleetSink:
    """Span sink keeping the fleet's own records (``fleet``,
    ``fleet_swap``, ``autoscale``); the engines' request and batch records
    are dropped."""

    KINDS = ("fleet", "fleet_swap", "autoscale")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.records: List[dict] = []  # guarded_by: _lock

    def emit(self, record: dict) -> None:
        if record.get("kind") in self.KINDS:
            with self._lock:
                self.records.append(record)

    def by_kind(self, kind: str) -> List[dict]:
        with self._lock:
            return [r for r in self.records if r.get("kind") == kind]


class _FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _free_ports(n: int) -> List[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _lat(run) -> dict:
    from raft_tpu_torch.serving.stats import percentiles

    pct = percentiles(list(run["latencies_s"] * 1e3), (50.0, 99.0))
    n = len(run["latencies_s"])
    return {"requests": n, "seconds": run["seconds"],
            "qps": n / run["seconds"], "p50_ms": pct["p50"],
            "p99_ms": pct["p99"], "outcomes": run["outcomes"]}


def _bitwise(got, want) -> bool:
    return (np.array_equal(np.asarray(got[0]).view(np.int32),
                           np.asarray(want[0]).view(np.int32))
            and np.array_equal(np.asarray(got[1]), np.asarray(want[1])))


def _reconcile(fleet, sink: FleetSink, where: str) -> dict:
    oc = fleet.stats.outcome_counts()
    resolved = sum(v for k, v in oc.items() if k != "submitted")
    spans = len(sink.by_kind("fleet"))
    if oc["submitted"] != resolved or spans != oc["submitted"]:
        raise AssertionError(f"{where}: {oc['submitted']} submitted, "
                             f"{resolved} resolved, {spans} fleet spans: "
                             f"{oc}")
    return oc


def _retries_by_kind(fleet) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for (_, kind), c in fleet.stats._retried.items():
        if c.value:
            out[kind] = out.get(kind, 0) + int(c.value)
    return out


def _routed(fleet) -> Dict[str, int]:
    return {name: int(c.value) for name, c in fleet.stats._routed.items()}


def _when(cond: Callable[[], bool], timeout: float) -> bool:
    """Poll ``cond`` every 2 ms until it holds or ``timeout`` passes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return cond()


# --------------------------------------------------------- in-process fleet


def in_process(*, smi, dev, seed, queries, gt_i, flat, flat_probes,
               serve_recall: Optional[float], emit: Callable
               ) -> Dict[str, int]:
    """The ``fleet`` line. Returns the kernels' launches of its loads."""
    from raft_tpu_torch import serving
    from raft_tpu_torch.bench.serve_load import closed_loop
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.stats import neighborhood_recall
    from raft_tpu_torch.testing import faults

    q_host = queries.cpu().numpy()
    n = q_host.shape[0]
    sink = FleetSink()

    def handle(probes):
        return serving.ivf_flat_searcher(
            flat, ivf_flat.SearchParams(n_probes=probes))

    fleet = serving.Fleet.from_searchers(
        [handle(flat_probes) for _ in range(N_REPLICAS)],
        engine_config=serving.EngineConfig(
            max_batch=64, max_wait_us=2000, warm_ks=(K,),
            breaker_cooldown_s=BREAKER_COOLDOWN_S),
        config=serving.FleetConfig(quorum=QUORUM, seed=seed,
                                   probe_interval_s=PROBE_INTERVAL_S,
                                   span_sink=sink))
    t0 = time.perf_counter()
    fleet.start()
    start_s = time.perf_counter() - t0
    builds0 = serving.compile_count()
    launches = {name: 0 for name in gk.LAUNCHES}
    shapes: Dict[str, int] = {}  # select_k's launches by "caller:n:k"

    def count():
        for name, c in gk.LAUNCHES.items():
            launches[name] += c
        for (caller, n_, k_), c in gk.SELECT_K_SHAPES.items():
            key = f"{caller}:{n_}:{k_}"
            shapes[key] = shapes.get(key, 0) + c

    samples: List[int] = []
    sampling = threading.Event()

    def sampler():
        while not sampling.is_set():
            samples.append(fleet.healthy_count())
            time.sleep(0.002)

    sam = threading.Thread(target=sampler, daemon=True)
    sam.start()
    ev: Dict[str, object] = {}
    runs = []
    extra = 0
    try:
        # ---- load 1: 8 submitters; replica1's breaker tripped, re-admitted
        r1 = fleet.replicas[1].engine

        def trip():
            _when(lambda: fleet.stats.n_requests("ok") >= TRIP_AT * n, 120)
            faults.trip_breaker(fleet, "replica1")
            ev["trip_t"] = time.perf_counter()
            ev["routed_at_trip"] = _routed(fleet)["replica1"]
            _when(lambda: r1.breaker.state == "closed", 120)
            ev["readmit_t"] = time.perf_counter()
            ev["routed_at_readmit"] = _routed(fleet)["replica1"]

        chaos = threading.Thread(target=trip, daemon=True)
        chaos.start()
        gk.reset_launch_counts()
        run1 = closed_loop(fleet, q_host, K, LOADS[0], typed=True)
        # a load that ended before the re-admission: single requests until
        # the probe closes the breaker (counted with the load)
        deadline = time.monotonic() + 60
        while chaos.is_alive() and time.monotonic() < deadline:
            fleet.search(q_host[extra % n], K, timeout=60)
            extra += 1
        chaos.join(60)
        count()
        runs.append(run1)
        # ---- load 2: 64 submitters; a rolling swap to 16 probes, a kill
        ok_before = fleet.stats.n_requests("ok")

        def swap_and_kill():
            _when(lambda: fleet.stats.n_requests("ok") - ok_before
                  >= SWAP_AT * n, 120)
            t_swap = time.perf_counter()
            ev["displaced"] = sum(o is not None for o in fleet.rolling_swap(
                [handle(SWAP_PROBES) for _ in range(N_REPLICAS)]))
            ev["swap_s"] = time.perf_counter() - t_swap
            _when(lambda: fleet.stats.n_requests("ok") - ok_before
                  >= KILL_AT * n, 120)
            faults.kill_replica(fleet, "replica2")
            ev["killed_after_ok"] = fleet.stats.n_requests("ok") - ok_before

        chaos = threading.Thread(target=swap_and_kill, daemon=True)
        chaos.start()
        gk.reset_launch_counts()
        run2 = closed_loop(fleet, q_host, K, LOADS[1], typed=True)
        count()
        chaos.join(120)
        runs.append(run2)
        drained = fleet.drain(timeout=60)
    finally:
        sampling.set()
        sam.join(10)
        builds = serving.compile_count() - builds0
        fleet.stop(drain=True, timeout=60)
    oc = _reconcile(fleet, sink, "fleet")
    submitted = sum(len(r["latencies_s"]) for r in runs) + extra
    sample_rng = np.random.default_rng(seed)
    pool = [(r, j) for r in runs
            for j in np.flatnonzero(~(r["failed"] | r["shed"]))]
    picks = sample_rng.choice(len(pool), min(SAMPLE, len(pool)),
                              replace=False)
    mismatches = 0
    for p in picks:
        run, j = pool[p]
        want = serving.solo_reference(run["searchers"][j], q_host[j], K,
                                      *run["placements"][j])
        mismatches += not _bitwise((run["distances"][j], run["ids"][j]),
                                   want)
    ok1 = np.flatnonzero(~(run1["failed"] | run1["shed"]))
    recall1 = float(neighborhood_recall(
        torch.from_numpy(run1["ids"][ok1]).to(dev),
        gt_i[torch.from_numpy(ok1).to(dev)]))
    routed = _routed(fleet)
    line = {
        "phase": "fleet", "card": smi, "replicas": N_REPLICAS,
        "quorum": QUORUM, "n_probes": flat_probes,
        "swap_probes": SWAP_PROBES, "start_s": start_s,
        "loads": [dict(submitters=s, **_lat(r))
                  for s, r in zip(LOADS, runs)],
        "extra_requests": extra, "routed": routed,
        "retries_by_kind": _retries_by_kind(fleet),
        "outcomes": oc,
        "trip_to_readmit_s": (ev.get("readmit_t", np.nan)
                              - ev.get("trip_t", np.nan)),
        "routed_replica1_probes": ev.get("routed_at_readmit", 0)
        - ev.get("routed_at_trip", 0),
        "routed_replica1_after_readmit": routed["replica1"]
        - ev.get("routed_at_readmit", routed["replica1"]),
        "swap_s": ev.get("swap_s"), "displaced": ev.get("displaced"),
        "killed_after_ok": ev.get("killed_after_ok"),
        "healthy_min": min(samples) if samples else None,
        "healthy_samples": len(samples), "drained": drained,
        "builds_after_start": builds, "solo_mismatches": mismatches,
        "solo_sampled": len(picks), "recall_at_10_load1": recall1,
        "recall_at_10_engine": serve_recall, "launches": launches,
        "select_k_shapes": shapes}
    emit(line)
    if oc["submitted"] != submitted:
        raise AssertionError(f"fleet: {oc['submitted']} submitted to the "
                             f"fleet, {submitted} by the loads")
    if not drained:
        raise AssertionError("fleet: a request was left pending")
    if builds:
        raise AssertionError(f"fleet: {builds} kernel builds after start()")
    if mismatches:
        raise AssertionError(f"fleet: {mismatches} of {len(picks)} rows "
                             "differ from solo_reference")
    if not samples or min(samples) < QUORUM:
        raise AssertionError(f"fleet: healthy count fell to "
                             f"{min(samples or [0])} < quorum {QUORUM}")
    # the probe that closed the breaker was routed to the replica
    if "readmit_t" not in ev or \
            ev["routed_at_readmit"] <= ev["routed_at_trip"]:
        raise AssertionError("fleet: the tripped replica was not re-admitted"
                             " through the router's probe")
    if ev.get("displaced") != N_REPLICAS or "killed_after_ok" not in ev:
        raise AssertionError(f"fleet: the swap or the kill did not land "
                             f"during the load: {ev}")
    if run1["outcomes"] != {"ok": n}:
        raise AssertionError(f"fleet: load 1 outcomes {run1['outcomes']}")
    if serve_recall is not None and recall1 != serve_recall:
        raise AssertionError(f"fleet: recall@10 {recall1} of the rows served"
                             f" before the swap != {serve_recall} of one "
                             "engine at the same probes")
    for name in ("fused_ivf_topk", "select_k"):
        if launches[name] < 1:
            raise AssertionError(f"fleet: the loads launched no {name}")
    return launches


# -------------------------------------------------------------- children


class Child:
    """One ``replica_main`` child process; its stdout is read on a thread."""

    def __init__(self, rank: int, size: int, peers, spec: dict, repo: Path,
                 log: Path, device: str = "cuda") -> None:
        self.rank = rank
        peer_arg = ",".join(f"{h}:{p}" for h, p in peers)
        cmd = [sys.executable, "-m", "raft_tpu_torch.serving.replica_main",
               "--rank", str(rank), "--size", str(size),
               "--frontend-rank", "0", "--peers", peer_arg,
               "--family", spec["family"], "--dim", str(spec["dim"]),
               "--rows", str(spec["rows"]), "--seed", str(spec["seed"]),
               "--n-lists", str(spec["n_lists"]), "--max-batch", "64",
               "--max-wait-us", "2000", "--peer-grace", "1.0",
               "--device", device]
        self.log = log
        self._err = open(log, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=str(repo),
                                     stdout=subprocess.PIPE,
                                     stderr=self._err, text=True)
        self.lines: "queue.Queue[str]" = queue.Queue()
        #: seconds to REPLICA_READY, set once by the one wait_ready caller
        self.ready_s: Optional[float] = None  # guarded_by: atomic
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put("")

    def wait_ready(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line.startswith("REPLICA_READY"):
                self.ready_s = time.perf_counter() - self.t0
                return True
            if line == "":
                return False
        return False

    def tail(self) -> str:
        self._err.flush()
        return self.log.read_text()[-3000:]

    def reap(self) -> Optional[int]:
        if self.proc.poll() is None:
            self.proc.kill()
        rc = self.proc.wait(60)
        self._err.close()
        return rc


def _start_ready(rank, size, peers, spec, repo, logdir,
                 device: str) -> Child:
    """A ready child at ``rank``; a child that exits first (its port taken)
    is started once more on a fresh port (``peers[rank]`` updated)."""
    for attempt in range(2):
        child = Child(rank, size, peers, spec, repo,
                      logdir / f"replica{rank}.{attempt}.log", device)
        if child.wait_ready(CHILD_READY_S):
            return child
        tail = child.tail()
        child.reap()
        if attempt == 0:
            peers[rank] = ("127.0.0.1", _free_ports(1)[0])
    raise AssertionError(f"replica {rank} never printed REPLICA_READY:\n"
                         f"{tail}")


_METRIC = re.compile(r'^(\w+)(?:\{([^}]*)\})? (\S+)$')


def scrape_figures(text: str) -> dict:
    """From a child's scrape: its kernel builds and its dispatch counts by
    (family, engine, reason)."""
    builds, dispatch = 0.0, {}
    for line in text.splitlines():
        m = _METRIC.match(line)
        if not m:
            continue
        name, labels, value = m.groups()
        if name == "raft_tpu_kernel_build_total":
            builds = float(value)
        elif name == "raft_tpu_dispatch_total":
            lab = dict(re.findall(r'(\w+)="([^"]*)"', labels or ""))
            dispatch[f"{lab.get('family')}:{lab.get('engine')}:"
                     f"{lab.get('reason')}"] = float(value)
    return {"builds": builds, "dispatch": dispatch}


def _check_scrape(fig: dict, family: str, who: str) -> None:
    if fig["builds"]:
        raise AssertionError(f"{who}: {fig['builds']} kernel builds")
    if not any(k.startswith(f"{family}:") and k.endswith(f":{FUSED_REASON}")
               and v > 0 for k, v in fig["dispatch"].items()):
        raise AssertionError(f"{who}: no {family} search on the fused route "
                             f"({FUSED_REASON}): {fig['dispatch']}")


# ------------------------------------------------------------ remote fleet


def remote(*, smi, dev, seed, queries, emit: Callable, repo: Path,
           logdir: Path) -> None:
    """The ``remote_fleet`` line."""
    from raft_tpu_torch import serving
    from raft_tpu_torch.bench.serve_load import closed_loop
    from raft_tpu_torch.parallel.host_p2p import HostP2P
    from raft_tpu_torch.serving.replica_main import build_searcher
    from raft_tpu_torch.serving.stats import percentiles

    logdir.mkdir(parents=True, exist_ok=True)
    q_host = queries.cpu().numpy()
    spec = {"family": "ivf_flat", "dim": DIM, "rows": N_ROWS, "seed": seed,
            "n_lists": N_LISTS}
    bf_spec = {"family": "brute_force", "dim": DIM, "rows": N_ROWS,
               "seed": seed}
    size = 4  # the frontend, two replicas, one autoscaled
    peers = [("127.0.0.1", p) for p in _free_ports(size)]
    children: Dict[int, Child] = {}
    starts: List[Child] = []
    ep = fleet = None
    sink = FleetSink()
    line: dict = {"phase": "remote_fleet", "card": smi, "spec": spec}
    try:
        starts.extend(Child(r, size, peers, spec, repo,
                            logdir / f"replica{r}.0.log", dev.type)
                      for r in (1, 2))
        # the reference: the same spec built here, while the children build
        ref, ref_s = _timed(lambda: build_searcher(spec, dev))
        bf_ref, _ = _timed(lambda: build_searcher(bf_spec, dev))
        for c in starts:
            if c.wait_ready(CHILD_READY_S):
                children[c.rank] = c
            else:
                tail = c.tail()
                c.reap()
                peers[c.rank] = ("127.0.0.1", _free_ports(1)[0])
                children[c.rank] = _start_ready(c.rank, size, peers, spec,
                                                repo, logdir, dev.type)
                line.setdefault("restarted", []).append([c.rank, tail[-300:]])
        line["ready_s"] = {f"replica{r}": c.ready_s
                           for r, c in children.items()}
        line["frontend_build_s"] = ref_s
        ep = HostP2P(rank=0, size=size, peers=peers, timeout=120,
                     peer_grace=1.0)
        proxies = {r: serving.RemoteReplica(
            ep, peer=r, dim=DIM, name=f"remote{r}",
            rpc_timeout_s=RPC_TIMEOUT_S, rpc_slack_s=2.0) for r in (1, 2)}
        fleet = serving.Fleet(
            [proxies[1], proxies[2]], names=["remote1", "remote2"],
            config=serving.FleetConfig(quorum=1, seed=seed, span_sink=sink,
                                       probe_interval_s=0.5))
        fleet.start()
        if not _when(lambda: all(p.health()["link"] == "up"
                                 for p in proxies.values()), 60):
            raise AssertionError("remote_fleet: a replica's link never came "
                                 "up")
        # ---- the round trip of one RPC at a time
        rtt_search, rtt_hello = [], []
        for j in range(RTT_CALLS):
            t = time.perf_counter()
            proxies[1].submit(q_host[j], K).result(timeout=60)
            rtt_search.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            proxies[1]._rpc({"op": "hello"}).result(timeout=60)
            rtt_hello.append((time.perf_counter() - t) * 1e3)
        line["rpc_search_ms"] = percentiles(rtt_search, (50.0, 99.0))
        line["rpc_hello_ms"] = percentiles(rtt_hello, (50.0, 99.0))
        # ---- 1,000 queries through the fleet, bitwise the reference
        qs = q_host[:REMOTE_QUERIES]
        run = closed_loop(fleet, qs, K, LOADS[0], typed=True)
        line["bitwise_load"] = _lat(run)
        if run["outcomes"] != {"ok": len(qs)}:
            raise AssertionError(f"remote_fleet: outcomes {run['outcomes']}")
        mism = sum(not _bitwise(
            (run["distances"][j], run["ids"][j]),
            serving.solo_reference(ref, qs[j], K, *run["placements"][j]))
            for j in range(len(qs)))
        line["bitwise_mismatches"] = mism
        line["routed_bitwise"] = _routed(fleet)
        if mism:
            raise AssertionError(f"remote_fleet: {mism} of {len(qs)} rows "
                                 "differ from this process's search of the "
                                 "same spec")
        scrapes = {}
        for r in (1, 2):
            fig = scrape_figures(proxies[r].scrape(timeout=60))
            scrapes[f"replica{r}"] = fig
            _check_scrape(fig, "ivf_flat", f"replica{r}")
        # ---- SIGKILL replica 2 mid-load: the supervisor sees the death
        qk = q_host[REMOTE_QUERIES:REMOTE_QUERIES + KILL9_QUERIES]
        ok0 = fleet.stats.n_requests("ok")

        def kill():
            _when(lambda: fleet.stats.n_requests("ok") - ok0 >= KILL9_AT,
                  120)
            os.kill(children[2].proc.pid, signal.SIGKILL)
            children[2].proc.wait(60)
            ep.mark_peer_dead(2, ConnectionError("replica 2 was killed"))

        killer = threading.Thread(target=kill, daemon=True)
        killer.start()
        run_k = closed_loop(fleet, qk, K, LOADS[0], typed=True)
        killer.join(120)
        oc = _reconcile(fleet, sink, "remote_fleet kill -9")
        line["kill9_load"] = _lat(run_k)
        line["kill9_rc"] = children[2].proc.returncode
        line["kill9_outcomes"] = oc
        line["kill9_retries_by_kind"] = _retries_by_kind(fleet)
        if children[2].proc.returncode != -signal.SIGKILL:
            raise AssertionError("remote_fleet: replica 2 was not killed")
        # the supervisor takes the dead replica out (its last piggybacked
        # load would otherwise stand in the autoscaler's pressure)
        fleet.remove_replica("remote2", drain=False, drain_timeout_s=10)
        # ---- the autoscaler: a fast burn spawns a child, idleness retires it
        clk = _FakeClock()
        retired_rc: List[Optional[int]] = []

        def spawn():
            child = _start_ready(3, size, peers, spec, repo, logdir,
                                 dev.type)
            ep.peers[3] = peers[3]  # a restart may have moved its port
            children[3] = child
            return serving.RemoteReplica(ep, peer=3, dim=DIM, name="scale1",
                                         rpc_timeout_s=RPC_TIMEOUT_S,
                                         rpc_slack_s=2.0)

        def retire(name, engine):
            retired_rc.append(children[3].proc.wait(120))

        asc = serving.Autoscaler(
            fleet, spawn=spawn, retire=retire,
            config=serving.AutoscalerConfig(min_replicas=1, max_replicas=3,
                                            span_sink=sink), clock=clk)
        asc.on_fast_burn("availability", 20.0)
        asc.tick()
        scaled = [r for r in fleet.replicas if r.name == "scale1"]
        if not scaled:
            raise AssertionError(f"remote_fleet: no spawn: "
                                 f"{sink.by_kind('autoscale')}")
        line["ready_s"]["replica3"] = children[3].ready_s
        if not _when(lambda: scaled[0].engine.health()["link"] == "up", 60):
            raise AssertionError("remote_fleet: the spawned replica's link "
                                 "never came up")
        routed0 = _routed(fleet).get("scale1", 0)
        qa = q_host[:REMOTE_QUERIES // 2]
        run_a = closed_loop(fleet, qa, K, LOADS[0], typed=True)
        line["autoscaled_load"] = _lat(run_a)
        line["routed_scale1"] = _routed(fleet).get("scale1", 0) - routed0
        mism_a = sum(not _bitwise(
            (run_a["distances"][j], run_a["ids"][j]),
            serving.solo_reference(ref, qa[j], K, *run_a["placements"][j]))
            for j in range(len(qa)) if not run_a["failed"][j])
        fig = scrape_figures(scaled[0].engine.scrape(timeout=60))
        scrapes["replica3"] = fig
        _check_scrape(fig, "ivf_flat", "replica3 (autoscaled)")
        for r in fleet.replicas:  # re-baseline: pressure falls when idle
            r.engine.stats.reset_samples()
        proxies[1].scrape(timeout=60)
        scaled[0].engine.scrape(timeout=60)
        line["pressure_before_retire"] = asc.pressure()
        asc.tick()
        clk.t += asc.config.down_window_s + 1.0
        asc.tick()
        spans = sink.by_kind("autoscale")
        lc = {ev: int(c.value) for ev, c in fleet.stats._lifecycle.items()}
        line["autoscale"] = {"spans": [
            {k: v for k, v in s.items() if k != "fleet"} for s in spans],
            "lifecycle": lc, "retired_rc": retired_rc}
        if [s["reason"] for s in spans] != ["scale_up_fast_burn",
                                             "scale_down_idle"]:
            raise AssertionError(f"remote_fleet: autoscale decisions {spans}")
        # removed: the supervisor's removal of replica 2, then the retire
        if not (lc["spawned"] == lc["added"] == 1 and lc["retired"] == 1
                and lc["removed"] == 2 and lc["spawn_failed"] == 0):
            raise AssertionError(f"remote_fleet: lifecycle {lc}")
        if retired_rc != [0]:
            raise AssertionError(f"remote_fleet: the retired child exited "
                                 f"{retired_rc}")
        if line["routed_scale1"] < 1 or mism_a:
            raise AssertionError(f"remote_fleet: the spawned replica served "
                                 f"{line['routed_scale1']} requests, "
                                 f"{mism_a} mismatches")
        # ---- swap the survivor to brute force over the same rows
        proxies[1].rpc_timeout_s = SWAP_TIMEOUT_S
        t = time.perf_counter()
        old = proxies[1].swap_index(bf_spec)
        line["swap_s"] = time.perf_counter() - t
        line["swap_old_coverage"] = old.coverage
        proxies[1].rpc_timeout_s = RPC_TIMEOUT_S
        qb = q_host[:REMOTE_QUERIES]
        run_b = closed_loop(fleet, qb, K, LOADS[0], typed=True)
        line["brute_force_load"] = _lat(run_b)
        if run_b["outcomes"] != {"ok": len(qb)}:
            raise AssertionError(f"remote_fleet: brute-force outcomes "
                                 f"{run_b['outcomes']}")
        mism_b = sum(not _bitwise(
            (run_b["distances"][j], run_b["ids"][j]),
            serving.solo_reference(bf_ref, qb[j], K,
                                   *run_b["placements"][j]))
            for j in range(len(qb)))
        line["brute_force_mismatches"] = mism_b
        fig = scrape_figures(proxies[1].scrape(timeout=60))
        scrapes["replica1_after_swap"] = fig
        line["scrapes"] = scrapes
        if mism_b:
            raise AssertionError(f"remote_fleet: {mism_b} of {len(qb)} "
                                 "brute-force rows differ from this "
                                 "process's")
        _check_scrape(fig, "brute_force", "replica1 after the swap")
        line["outcomes"] = _reconcile(fleet, sink, "remote_fleet")
        fleet.stop(drain=True, timeout=30)
        line["replica1_rc"] = children[1].proc.wait(60)
        if line["replica1_rc"] != 0:
            raise AssertionError(f"remote_fleet: replica 1 exited "
                                 f"{line['replica1_rc']} after stop")
        fleet = None
    except BaseException as e:  # noqa: B036 — the line says how far it got
        line["error"] = repr(e)[:2000]
        raise
    finally:
        if fleet is not None:
            fleet.stop(drain=False, timeout=10)
        if ep is not None:
            ep.close()
        for c in [*children.values(), *starts]:
            if c.proc.poll() is None or not c._err.closed:
                c.reap()
        emit(line)


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase(*, smi, dev, seed, queries, gt_i, flat, flat_probes,
          serve_recall: Optional[float], emit: Callable, repo: Path,
          only: Optional[str] = None) -> Dict[str, int]:
    """Phase 6g. Returns the frontend's launches in its in-process loads."""
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the children need the card's memory
    launches: Dict[str, int] = {}
    if only in (None, "fleet"):
        launches = in_process(smi=smi, dev=dev, seed=seed, queries=queries,
                              gt_i=gt_i, flat=flat, flat_probes=flat_probes,
                              serve_recall=serve_recall, emit=emit)
    if only in (None, "remote"):
        remote(smi=smi, dev=dev, seed=seed, queries=queries, emit=emit,
               repo=repo, logdir=repo / "build" / "chip_smoke_6g")
    emit({"phase": "fleet_total", "card": smi,
          "seconds": time.perf_counter() - t0, "launches": launches})
    return launches


def main(argv=None) -> int:
    """Standalone: phase 3-4's data, index and ground truth, the single
    engine's recall at 8 submitters (phase 6b's), then the phase."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--only", choices=("fleet", "remote"), default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fleet_load: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import serving
    from raft_tpu_torch.bench.datagen import low_rank_clusters
    from raft_tpu_torch.bench.serve_load import closed_loop
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.stats import neighborhood_recall

    def emit(obj):
        print(json.dumps(obj, default=float), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gk.build_all()
    rows = low_rank_clusters(np.random.default_rng(args.seed),
                             N_ROWS + N_QUERIES, DIM)
    dataset = torch.from_numpy(rows[:N_ROWS]).to(dev)
    queries = torch.from_numpy(rows[N_ROWS:]).to(dev)
    _, gt_i = brute_force.search(brute_force.build(
        dataset, metric="sqeuclidean"), queries, K)
    flat = ivf_flat.build(dataset, ivf_flat.IndexParams(n_lists=N_LISTS))
    probes = 32
    while True:
        _, ii = ivf_flat.search(flat, queries, K,
                                ivf_flat.SearchParams(n_probes=probes))
        if float(neighborhood_recall(ii, gt_i)) >= 0.90 or probes >= N_LISTS:
            break
        probes *= 2
    eng = serving.Engine(serving.ivf_flat_searcher(
        flat, ivf_flat.SearchParams(n_probes=probes)),
        serving.EngineConfig(max_batch=64, max_wait_us=2000,
                             max_inflight=2, warm_ks=(K,))).start()
    try:
        run = closed_loop(eng, queries.cpu().numpy(), K, LOADS[0])
    finally:
        eng.stop()
    recall = float(neighborhood_recall(
        torch.from_numpy(run["ids"]).to(dev), gt_i))
    emit({"phase": "engine_reference", "card": smi, "n_probes": probes,
          "recall_at_10": recall, **_lat(run)})
    phase(smi=smi, dev=dev, seed=args.seed, queries=queries, gt_i=gt_i,
          flat=flat, flat_probes=probes, serve_recall=recall, emit=emit,
          repo=Path(__file__).resolve().parents[2], only=args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
