"""Child-process entrypoint for one remote serving replica.

``python -m raft_tpu_torch.serving.replica_main --rank 1 --size 2 ...``
builds a searcher from a synthetic-dataset spec (deterministic by
``--seed``: the rows are ``np.random.default_rng(seed).standard_normal``
exactly as ``raft_tpu.serving.replica_main`` draws them, so the frontend,
every replica and a replica of either package start from the same
bytes), wraps it in a real :class:`~raft_tpu_torch.serving.engine.Engine`
on ``--device`` (``cuda`` by default; without a card the process exits
non-zero unless given ``--device cpu``), and serves the
:mod:`raft_tpu_torch.serving.remote` wire protocol over one
:class:`~raft_tpu_torch.parallel.host_p2p.HostP2P` endpoint until told to
stop. The flags, the readiness lines and the wire are raft_tpu's.

On the card a replica is a process of its own with its own CUDA context:
the kernels are loaded from ``build/raft_tpu_torch/`` where an earlier
process built them (the libraries are keyed by a hash of their sources
and renamed into place whole, so replicas starting together never load a
half-written one); the replica's ``scrape`` op shows
``raft_tpu_kernel_build_total``, which counts its own ``nvcc`` runs.
Start replicas with ``subprocess.Popen``, never by forking a process that
holds a CUDA context.

The loop is deliberately dumb: one ``irecv`` per inbound request on the
fixed ``RPC_TAG``, each request dispatched to a short-lived worker
thread (a slow search must not block the accept loop), each reply
``isend``-ed back on the request's correlation id. At-least-once
transport delivery is dedup'd with a bounded seen-window so a retried
request frame is served once, not twice.

Every reply piggybacks the engine's current ``health()`` plus the
queue-depth/queue-wait numbers the router scores on — under live
traffic the frontend's cached view is as fresh as its last reply, with
zero extra RPCs.

Shutdown is the graceful-drain handshake from both directions:

- an inbound ``{"op": "stop"}`` (the autoscaler's retire path) acks
  first, then announces a drain frame (``HostP2P.announce_drain``) so
  the frontend's pending irecvs fail *typed* (``PeerDrained`` →
  ``EngineStopped`` → retry-on-sibling), then drains the engine and
  exits 0;
- SIGTERM does the same (a supervisor-initiated retire);
- SIGKILL obviously does none of it — that is the chaos case the fleet
  must absorb as a peer-death verdict (tests/test_torch_remote_fleet.py).

The replica also serves its own ``/metrics`` + ``/healthz`` on
``--metrics-port`` (0 = ephemeral, printed on stdout as
``METRICS_PORT=<n>``), so the one-target aggregation in
``Fleet.serve_metrics`` has a same-shape scrape to pull via the
``scrape`` op.
"""

from __future__ import annotations

import argparse
import collections
import json
import signal
import sys
import threading
import time

import numpy as np

from raft_tpu_torch.core import logger
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.parallel.host_p2p import HostP2P
from raft_tpu_torch.serving.remote import (RPC_TAG, decode_message,
                                     encode_error, encode_message)

__all__ = ["build_searcher", "serve", "main"]

#: bounded dedup window for at-least-once request delivery
_SEEN_WINDOW = 4096

#: accept-loop slice: how often the stop event is honoured while the
#: posted irecv waits (a delivery wakes the loop at once). NOT a request
#: budget — per-request deadlines ride the wire (``deadline_ms`` in each
#: header) and the engine enforces them from its own clock.
_ACCEPT_POLL_S = 0.02

#: reap timeout for a request already ``done()`` — never blocks
_REAP_NOW_S = 0.0


def build_searcher(spec: dict, device=None):
    """Deterministic searcher from a flat spec dict (also the payload
    of the remote ``swap`` op): ``family`` (brute_force | ivf_flat),
    ``dim``, ``rows``, ``seed``, optional ``n_lists`` / ``n_probes``.
    Synthetic standard-normal rows drawn as raft_tpu draws them; the
    index is built on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    from raft_tpu_torch.serving import searchers as s
    family = spec.get("family", "brute_force")
    dim = int(spec["dim"])
    rows = int(spec.get("rows", 2048))
    seed = int(spec.get("seed", 0))
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((rows, dim)).astype(np.float32)
    if family == "brute_force":
        from raft_tpu_torch.neighbors import brute_force
        return s.brute_force_searcher(brute_force.build(db, device=device))
    if family == "ivf_flat":
        from raft_tpu_torch.neighbors import ivf_flat
        index = ivf_flat.build(
            db, ivf_flat.IndexParams(n_lists=int(spec.get("n_lists", 16))),
            device=device)
        return s.ivf_flat_searcher(
            index, ivf_flat.SearchParams(
                n_probes=int(spec.get("n_probes", 8))))
    raise ValueError(f"unknown searcher family {family!r} "
                     f"(remote specs support brute_force, ivf_flat)")


class _ReplicaServer:
    """One engine + one endpoint + the request loop (module docstring)."""

    def __init__(self, engine, endpoint: HostP2P, frontend: int):
        self.engine = engine
        self.ep = endpoint
        self.frontend = int(frontend)
        self._seen: dict = {}           # cid -> True, bounded FIFO
        self._seen_order = collections.deque()
        self._seen_lock = threading.Lock()
        self._stop = threading.Event()
        self._stop_drain = True

    # ---------------------------------------------------------- piggyback
    def _piggyback(self) -> dict:
        h = dict(self.engine.health())
        h["queue_wait_p99_s"] = float(
            self.engine.stats.queue_wait_p99_s())
        h["queue_wait_p99_window_s"] = float(
            self.engine.stats.queue_wait_p99_window_s())
        return h

    def _reply(self, cid: int, header: dict, *arrays) -> None:
        header = dict(header)
        header.setdefault("ok", True)
        header["health"] = self._piggyback()
        try:
            self.ep.isend(encode_message(header, *arrays),
                          self.frontend, tag=cid)
        except (ConnectionError, OSError) as e:
            # a reply to a vanished frontend is not a replica failure
            logger.warn("replica rank %d: reply for cid %d undeliverable"
                        ": %r", self.ep.rank, cid, e)

    def _dedup(self, cid: int) -> bool:
        """True when this cid was already served (at-least-once
        redelivery) — the earlier reply is on its way or already
        consumed; serving again would double device work."""
        with self._seen_lock:
            if cid in self._seen:
                return True
            self._seen[cid] = True  # guarded_by: _seen_lock
            self._seen_order.append(cid)  # guarded_by: _seen_lock
            if len(self._seen_order) > _SEEN_WINDOW:
                self._seen.pop(self._seen_order.popleft(), None)
        return False

    # ------------------------------------------------------------ ops
    def _handle(self, payload: bytes) -> None:
        try:
            header, arrays = decode_message(bytes(payload))
        except Exception as e:
            logger.warn("replica rank %d: undecodable request dropped: "
                        "%r", self.ep.rank, e)
            return
        cid = int(header.get("cid", -1))
        if cid < 0 or self._dedup(cid):
            return
        op = header.get("op")
        try:
            if op == "search":
                self._op_search(cid, header, arrays)
            elif op in ("health", "hello"):
                self._reply(cid, {"op": op,
                                  "dim": self.engine.searcher.dim,
                                  "query_dtype": str(np.dtype(
                                      self.engine.searcher.query_dtype)),
                                  "autoscale_budget_ms":
                                      self.engine.autoscale_budget_ms})
            elif op == "scrape":
                self._reply(cid, {
                    "op": op,
                    "text": obs_metrics.REGISTRY.to_prometheus_text()})
            elif op == "drain":
                ok = self.engine.drain(
                    timeout=float(header.get("timeout_s", 30.0)))
                self._reply(cid, {"op": op, "drained": bool(ok)})
            elif op == "reset_samples":
                # the frontend's load generator re-baselines the latency
                # window here exactly like it does on local replicas, so
                # the piggybacked windowed p99 (the autoscale pressure
                # numerator) reflects the current operating point
                self.engine.stats.reset_samples()
                self._reply(cid, {"op": op, "reset": True})
            elif op == "swap":
                old = self.engine.swap_index(
                    build_searcher(header["spec"],
                                   self.engine.searcher.device),
                    warm=bool(header.get("warm", True)))
                self._reply(cid, {"op": op, "old_coverage":
                                  float(getattr(old, "coverage", 1.0))})
            elif op == "stop":
                # rebind-only, published BEFORE the stop Event;
                # shutdown() reads it after the event fires
                self._stop_drain = bool(  # guarded_by: atomic
                    header.get("drain", True))
                self._reply(cid, {"op": op, "stopping": True,
                                  "draining": True})
                self._stop.set()
            else:
                self._reply(cid, {
                    "ok": False, "error_kind": "other",
                    "error_type": "ValueError",
                    "message": f"unknown op {op!r}"})
        except BaseException as e:  # typed engine failures → wire
            self._reply(cid, encode_error(e))

    def _op_search(self, cid: int, header: dict, arrays) -> None:
        if len(arrays) != 1:
            self._reply(cid, {"ok": False, "error_kind": "other",
                              "error_type": "ValueError",
                              "message": "search carries exactly one "
                                         "query array"})
            return
        # the wire deadline is the REMAINING budget at client send
        # time; the engine enforces it from its own clock, so far-side
        # queueing sheds typed DeadlineExceeded like a local replica
        fut = self.engine.submit(
            arrays[0], int(header.get("k", 10)), block=True,
            deadline_ms=header.get("deadline_ms"))
        d, i = fut.result()
        reply = {"op": "search", "trace_id": header.get("trace_id")}
        placement = getattr(fut, "placement", None)
        if placement is not None:
            # (row, bucket) of the batch that served it: the frontend's
            # solo_reference needs it (a raft_tpu proxy ignores the key)
            reply["placement"] = [int(placement[0]), int(placement[1])]
        self._reply(cid, reply, np.asarray(d), np.asarray(i))

    # ------------------------------------------------------------ loop
    def run(self) -> None:
        """Accept loop: one posted irecv at a time from the frontend,
        each request handed to a worker thread. The posted request is
        polled via ``done()`` (a ``wait`` timeout would *cancel* it and
        orphan the next delivery)."""
        while not self._stop.is_set():
            req = self.ep.irecv(source=self.frontend, tag=RPC_TAG)
            # wait on the request's own event: a delivery wakes the loop
            # at once (raft_tpu's loop sleeps out the whole slice, up to
            # 20 ms a request), and the stop event is still honoured
            # every slice
            while not self._stop.is_set() and not req._done.wait(
                    _ACCEPT_POLL_S):
                pass
            if not req.done():
                req._cancelled = True
                break
            try:
                payload = req.wait(timeout=_REAP_NOW_S)
            except (ConnectionError, OSError):
                # frontend died/drained: nothing to serve until a
                # reconnect delivers again — re-post and keep living
                time.sleep(0.05)
                continue
            t = threading.Thread(target=self._handle, args=(payload,),
                                 daemon=True,
                                 name=f"raft-tpu-replica-op-{self.ep.rank}")
            t.start()

    def shutdown(self) -> None:
        """Both shutdown paths funnel here: announce the drain frame
        (typed PeerDrained on the frontend), then stop the engine."""
        self._stop.set()
        try:
            self.ep.announce_drain(self.frontend).wait(timeout=2.0)
        except (ConnectionError, OSError, TimeoutError) as e:
            # frontend already gone: the drain frame has no audience
            logger.debug("replica rank %d: drain announce not delivered"
                         ": %r", self.ep.rank, e)
        try:
            self.engine.stop(drain=self._stop_drain, timeout=10.0)
        finally:
            self.ep.close()


def serve(rank: int, size: int, spec: dict, frontend: int = 0,
          base_port: int = 41300, metrics_port: int = -1,
          engine_kw: dict = None, peer_grace: float = 2.0,
          peers=None, device=None) -> int:
    """Build, announce readiness on stdout, serve until stopped."""
    from raft_tpu_torch.obs import device as obs_device
    from raft_tpu_torch.serving.engine import Engine, EngineConfig
    # count this process's own nvcc runs from the start (the scrape op
    # shows them as raft_tpu_kernel_build_total)
    obs_device.install_compile_metrics()
    searcher = build_searcher(spec, device)
    cfg = EngineConfig(**(engine_kw or {}))
    engine = Engine(searcher, cfg).start()
    ep = HostP2P(rank=rank, size=size, base_port=base_port,
                 peer_grace=peer_grace, peers=peers)
    server = _ReplicaServer(engine, ep, frontend)
    if metrics_port >= 0:
        ms = engine.serve_metrics(port=metrics_port)
        print(f"METRICS_PORT={ms.port}", flush=True)

    def _sigterm(signum, frame):
        server._stop.set()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigterm)
    # readiness marker: the listener is bound (HostP2P binds in
    # __init__), the engine is warm — the parent may start driving load
    print(f"REPLICA_READY rank={rank}", flush=True)
    try:
        server.run()
    finally:
        server.shutdown()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="raft_tpu_torch remote serving replica (the wire "
                    "and flags of raft_tpu.serving.replica_main)")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--size", type=int, required=True)
    p.add_argument("--frontend-rank", type=int, default=0)
    p.add_argument("--base-port", type=int, default=41300)
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="-1 disables the replica's own /metrics")
    p.add_argument("--family", default="brute_force")
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-lists", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-us", type=int, default=2000)
    p.add_argument("--peer-grace", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="where the index lives and is searched: cuda (the "
                        "default; no card is an error) or cpu")
    p.add_argument("--peers", default=None,
                   help="comma-separated host:port per rank; default "
                        "localhost at base_port+rank")
    args = p.parse_args(argv)
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            print(f"replica_main: --device {args.device} but no CUDA device "
                  "is available; pass --device cpu to serve on the CPU",
                  file=sys.stderr, flush=True)
            return 2
    peers = None
    if args.peers:
        peers = []
        for entry in args.peers.split(","):
            host, _, port = entry.strip().rpartition(":")
            peers.append((host, int(port)))
    spec = {"family": args.family, "dim": args.dim, "rows": args.rows,
            "seed": args.seed, "n_lists": args.n_lists}
    logger.info("replica_main: rank=%d size=%d spec=%s",
                args.rank, args.size, json.dumps(spec, sort_keys=True))
    return serve(args.rank, args.size, spec,
                 frontend=args.frontend_rank, base_port=args.base_port,
                 metrics_port=args.metrics_port,
                 engine_kw={"max_batch": args.max_batch,
                            "max_wait_us": args.max_wait_us},
                 peer_grace=args.peer_grace, peers=peers,
                 device=args.device)


if __name__ == "__main__":
    sys.exit(main())
