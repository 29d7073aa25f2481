"""Host async point-to-point — the UCX role of the reference comms stack.

Reference: ``comms_t::isend/irecv/waitall`` (core/comms.hpp:137-141), whose
std_comms implementation runs host-side async messaging over UCX endpoints
(comms/detail/std_comms.hpp:211-253, detail/ucp_helper.hpp) alongside
NCCL's device collectives. Consumers use it to overlap host-side data
exchange (metadata, ragged buffers, dataset spans) with device compute —
the raft-dask pattern.

Design (a copy of ``raft_tpu.parallel.host_p2p``, which imports nothing
of JAX, over the port's logger and metrics): device traffic rides the
port's collectives (:mod:`raft_tpu_torch.parallel.comms`); this module
supplies the *host* channel as plain TCP — no external dependency, usable
across the hosts of a ``torch.distributed`` deployment or between serving
processes that share one card (each process listens on its ``peers``
entry). Frames, tags and metric names are raft_tpu's, so an endpoint of
either package talks to the other.
Requests mirror the reference's ``request_t`` handles: ``isend``/``irecv``
return immediately; ``waitall`` blocks on any mix of them.

Ordering contract (matches MPI/UCX non-overtaking semantics): sends to one
destination run on that destination's dedicated sender thread over one
persistent connection, and the receiver matches messages to pending
``irecv`` requests in post order — two isends with the same (dest, tag)
are received in the order they were posted.

Message framing: [i32 magic][i32 src][i32 tag][u64 nbytes][type byte]
[payload]. ndarray payloads carry a dtype/shape header (npy) so they
reconstruct on the receiving side; raw ``bytes`` pass through untouched.

Request/response support (the serving remote-replica proxy rides this):
``correlation_id()`` allocates tags from a reserved range
(``>= _CORR_BASE``) so an RPC reply can be matched to exactly one
outstanding request without colliding with user tags; ``discard()``
drops an abandoned correlation's state so late replies cannot
accumulate in the inbox. ``announce_drain(dest)`` sends a control frame
that tells the peer "nothing more is coming from me — this is a clean
goodbye": the receiver fails that source's pending irecvs with the
typed :class:`PeerDrained` (not a presumed death), suppresses the
peer-death grace timer for the EOF that follows, and fails later
irecvs from that source immediately instead of waiting out the
timeout. A new delivery from the source (a restarted process) clears
the drained verdict.
"""

from __future__ import annotations

import collections
import errno
import io
import itertools
import os
import queue
import random
import selectors
import socket
import struct
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from raft_tpu_torch.core import logger
from raft_tpu_torch.obs import metrics as obs_metrics

_MAGIC = 0x52465450  # "RFTP"
_HDR = struct.Struct("<iiiQ")

#: control-frame tag: graceful drain announcement (never delivered to an
#: irecv — intercepted in _deliver)
_DRAIN_TAG = -2

#: correlation tags live at and above this value; user tags should stay
#: below it (the allocator wraps inside [_CORR_BASE, _CORR_LIMIT))
_CORR_BASE = 1 << 20
_CORR_LIMIT = 1 << 30

# fabric counters (docs/observability.md), labeled by the REMOTE rank:
# `peer` is the destination for send-side families, the source for
# receive-side ones — so one scrape shows which link is sick
_SENT_MSGS = obs_metrics.REGISTRY.counter(
    "raft_tpu_p2p_messages_sent_total",
    "Frames delivered to a peer (after any retries).", ("peer",))
_SENT_BYTES = obs_metrics.REGISTRY.counter(
    "raft_tpu_p2p_bytes_sent_total",
    "Wire bytes sent (header + type byte + payload).", ("peer",))
_RECV_MSGS = obs_metrics.REGISTRY.counter(
    "raft_tpu_p2p_messages_received_total",
    "Frames received from a peer.", ("peer",))
_RECV_BYTES = obs_metrics.REGISTRY.counter(
    "raft_tpu_p2p_bytes_received_total",
    "Wire bytes received (header + type byte + payload).", ("peer",))
_SEND_RETRIES = obs_metrics.REGISTRY.counter(
    "raft_tpu_p2p_send_retries_total",
    "Send attempts that failed and were retried with backoff.", ("peer",))
_BACKOFF_SECONDS = obs_metrics.REGISTRY.counter(
    "raft_tpu_p2p_backoff_seconds_total",
    "Cumulative seconds slept in send retry backoff.", ("peer",))
_STREAMS_POISONED = obs_metrics.REGISTRY.counter(
    "raft_tpu_p2p_streams_poisoned_total",
    "Send streams poisoned after exhausting retries.", ("peer",))
_PEER_DEATHS = obs_metrics.REGISTRY.counter(
    "raft_tpu_p2p_peer_deaths_total",
    "Peer-death verdicts (grace timer expiry or mark_peer_dead).",
    ("peer",))


class _EndpointClosed(ConnectionError):
    """Sentinel for "the endpoint closed while this operation was in
    flight". A distinct class because Python maps OSError(ECONNREFUSED/
    ECONNRESET, ...) to ConnectionRefused/ResetError — ConnectionError
    subclasses — so `except ConnectionError` would also swallow ordinary
    refused connects."""


class PeerDrained(ConnectionError):
    """The peer announced a graceful drain (``announce_drain``): nothing
    more will arrive from it, by design. A typed, *clean* verdict — the
    serving proxy maps it to a retry-on-sibling, distinct from the
    presumed-death ConnectionError the grace timer raises."""


class Request:
    """An in-flight isend/irecv (the request_t analog). ``wait`` blocks
    until completion and, for receives, returns the payload. A receive
    whose ``wait`` times out is cancelled: the message it would have
    matched goes to the next ``irecv`` instead of being lost.

    ``wait()`` with no explicit timeout uses the ENDPOINT's timeout as a
    real deadline (raising TimeoutError) rather than blocking forever — a
    dead peer costs a bounded wait, never a hung serving process.

    Deadlines are computed against the endpoint's injectable ``clock``
    (the same seam the fake-clock batcher tests use): with the default
    ``time.monotonic`` the wait is a single blocking ``Event.wait``;
    with an injected clock it polls short real slices against the
    injected time so a test can advance the deadline synthetically."""

    def __init__(self, kind: str, lock: threading.Lock,
                 default_timeout: Optional[float] = None,
                 clock=time.monotonic):
        self.kind = kind
        self._lock = lock  # endpoint matching lock
        self._default_timeout = default_timeout
        self._clock = clock
        self._done = threading.Event()
        self._cancelled = False
        self._value = None
        self._error: Optional[BaseException] = None

    def _finish(self, value=None, error: Optional[BaseException] = None):
        self._value = value
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def _wait_done(self, timeout: Optional[float]) -> bool:
        if timeout is None:
            self._done.wait()
            return True
        if self._clock is time.monotonic:
            return self._done.wait(timeout)
        # injected clock: real-time slices, injected-time deadline
        deadline = self._clock() + timeout
        while True:
            if self._done.wait(0.02):
                return True
            if self._clock() >= deadline:
                return False

    def wait(self, timeout: Optional[float] = None):
        if timeout is None:
            timeout = self._default_timeout
        if not self._wait_done(timeout):
            with self._lock:
                if not self._done.is_set():  # lost the race with delivery?
                    self._cancelled = True
                    raise TimeoutError(
                        f"{self.kind} request timed out after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


def _encode(payload) -> Tuple[bytes, bytes]:
    """→ (type tag, wire bytes). Arrays keep dtype/shape; bytes pass raw."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return b"B", bytes(payload)
    arr = np.asarray(payload)
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return b"A", buf.getvalue()


def _decode(tag: bytes, raw: bytes):
    if tag == b"B":
        return raw
    return np.load(io.BytesIO(raw), allow_pickle=False)


def _drain_queue(q: "queue.Queue", error: BaseException) -> None:
    """Fail every request still sitting in a sender queue. Safe to call
    from multiple threads: Queue.get_nowait is atomic, so each request is
    finished exactly once."""
    while True:
        try:
            req = q.get_nowait()[0]
        except queue.Empty:
            return
        req._finish(error=error)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-message")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class HostP2P:
    """One endpoint of the host p2p fabric (one per rank/process).

    ``peers``: (host, port) per rank. ``peers=None`` → all-localhost at
    ``base_port + r`` (single-host multiprocess, and the CI shape).

    Fault model (docs/robustness.md): a failed connect/send is RETRIED up
    to ``retries`` times with exponential backoff + jitter before the
    stream poisons (``retries=0`` restores strict fail-fast). Retried
    sends are at-least-once: a frame cut mid-send is resent whole on a
    fresh connection, so a crash window can deliver a message twice —
    receivers that care must dedup by tag/sequence. ``wait``/``waitall``
    default to the endpoint ``timeout`` as a hard deadline (TimeoutError,
    never a hang). A connection that drops MID-FRAME starts a
    ``peer_grace`` timer on the receiver; if the peer has not delivered
    again when it fires, every pending ``irecv`` from that source fails
    with ConnectionError (a reconnect in the window cancels the verdict —
    it was a sender retry, not a death).
    """

    def __init__(self, rank: int, size: int,
                 peers: Optional[Sequence[Tuple[str, int]]] = None,
                 base_port: int = 41300, timeout: float = 120.0,
                 retries: int = 3, retry_backoff: float = 0.05,
                 retry_backoff_max: float = 2.0, peer_grace: float = 2.0,
                 clock=time.monotonic):
        self.rank = int(rank)
        self.size = int(size)
        self.timeout = timeout
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)
        self.retry_backoff_max = float(retry_backoff_max)
        self.peer_grace = float(peer_grace)
        # every deadline in the endpoint (wait/waitall, the connect
        # handshake, the peer-grace window) is computed on this clock —
        # the same injectable seam the fake-clock Batcher tests use
        self._clock = clock
        self.peers = (list(peers) if peers is not None
                      else [("127.0.0.1", base_port + r)
                            for r in range(size)])
        if len(self.peers) != size:
            raise ValueError(f"{len(self.peers)} peers for size {size}")
        # receiver matching state, all under one lock: FIFO inbox of
        # unclaimed messages + FIFO queue of waiting irecvs per (src, tag)
        self._match_lock = threading.Lock()
        # (src, tag) -> deque of payloads
        self._inbox: dict = {}  # guarded_by: _match_lock
        # (src, tag) -> deque of Requests
        self._waiting: dict = {}  # guarded_by: _match_lock
        # per-src delivery generation counters: an abnormal connection
        # drop schedules a grace check against the generation at drop
        # time — any later delivery proves the peer (or its retry) is
        # alive and voids the death verdict
        self._peer_gen: dict = {}  # guarded_by: _match_lock
        # sources that announced a graceful drain (module docstring):
        # their EOF is clean and their pending irecvs fail PeerDrained
        self._drained: set = set()  # guarded_by: _match_lock
        # per-destination sender worker: one persistent connection, FIFO
        self._send_queues: dict = {}  # guarded_by: _send_lock
        self._send_lock = threading.Lock()
        # dest -> live outbound socket (test hook _sever_send cuts it)
        self._active_send: dict = {}  # guarded_by: _send_lock
        # dest -> poisoning error; reset_stream() clears it so a healed
        # link can carry traffic again (the caller acknowledges the gap)
        self._poison: dict = {}  # guarded_by: _send_lock
        # injected-fault state (testing.faults.partition_hosts /
        # delay_link): replaced wholesale under _send_lock; hot-path
        # reads are lock-free attribute loads of the immutable values
        self._partitioned: frozenset = frozenset()
        self._link_delay: dict = {}
        # correlation-tag allocator (itertools.count is C-atomic)
        self._corr = itertools.count()
        # live accepted connections (see close())
        self._conns: set = set()  # guarded_by: _conns_lock
        self._conns_lock = threading.Lock()
        self._closed = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        bind_host = self.peers[self.rank][0] if peers is not None \
            else "127.0.0.1"
        self._listener.bind((bind_host, self.peers[self.rank][1]))
        self._listener.listen(size * 4)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"raft-tpu-hostp2p-{rank}")
        self._accept_thread.start()

    # ------------------------------------------------------------- receive
    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._conns_lock:
                if self._closed.is_set():  # raced with close(): reap now
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        """One thread per inbound connection; messages on a connection are
        delivered in arrival order (TCP preserves the sender's order).

        A connection that ends CLEANLY at a frame boundary is a normal
        disconnect. One that cuts mid-frame (partial header/payload,
        reset) is ABNORMAL: the sender likely died mid-send — schedule a
        peer-death check so its pending irecvs fail after ``peer_grace``
        instead of waiting out the full endpoint timeout."""
        last_src = None
        abnormal = False
        try:
            with conn:
                while True:
                    hdr = conn.recv(_HDR.size, socket.MSG_WAITALL)
                    if not hdr:
                        return  # clean EOF at a frame boundary
                    if len(hdr) < _HDR.size:
                        abnormal = True  # cut mid-header
                        return
                    magic, src, tag, nbytes = _HDR.unpack(hdr)
                    if magic != _MAGIC:
                        raise ConnectionError("bad frame magic")
                    last_src = src
                    ty = _read_exact(conn, 1)
                    raw = _read_exact(conn, nbytes)
                    _RECV_MSGS.labels(src).inc()
                    _RECV_BYTES.labels(src).inc(_HDR.size + 1 + nbytes)
                    self._deliver(src, tag, _decode(ty, raw))
        except (ConnectionError, OSError):
            abnormal = True
            return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            if (abnormal and last_src is not None
                    and not self._closed.is_set()
                    and not self._is_drained(last_src)):
                self._schedule_peer_check(last_src)

    def _is_drained(self, src: int) -> bool:
        with self._match_lock:
            return src in self._drained

    def _deliver(self, src: int, tag: int, payload):
        if src in self._partitioned:
            return  # injected partition: inbound half of the cut
        if tag == _DRAIN_TAG:
            self._handle_drain(src)
            return
        with self._match_lock:
            self._peer_gen[src] = self._peer_gen.get(src, 0) + 1
            self._drained.discard(src)  # delivering again — alive
            waiting = self._waiting.get((src, tag))
            while waiting:
                req = waiting.popleft()
                if not req._cancelled:
                    req._finish(payload)
                    return
            self._inbox.setdefault((src, tag),
                                   collections.deque()).append(payload)

    def _handle_drain(self, src: int) -> None:
        """Graceful-drain control frame: fail this source's pending
        irecvs with the typed :class:`PeerDrained`, void any in-flight
        death verdict (the goodbye proves the peer was alive), and
        remember the drain so the EOF that follows is clean."""
        with self._match_lock:
            self._peer_gen[src] = self._peer_gen.get(src, 0) + 1
            self._drained.add(src)
            self._fail_src_locked(src, PeerDrained(
                f"peer rank {src} announced a graceful drain"))
        logger.info("host_p2p rank %d: peer rank %d drained gracefully",
                    self.rank, src)

    # ----------------------------------------------------------- peer death
    def _schedule_peer_check(self, src: int) -> None:
        with self._match_lock:
            gen = self._peer_gen.get(src, 0)
        t = threading.Thread(
            target=self._grace_wait, args=(src, gen), daemon=True,
            name=f"raft-tpu-p2p-grace-{self.rank}-{src}")
        t.start()

    def _grace_wait(self, src: int, gen: int) -> None:
        """Sleep out the grace window on the endpoint clock, observing
        ``_closed`` (a plain threading.Timer observes neither the clock
        seam nor close(), so a fake-clock test could never expire it and
        close() could leak a pending verdict)."""
        deadline = self._clock() + self.peer_grace
        while not self._closed.is_set():
            remaining = deadline - self._clock()
            if remaining <= 0:
                self._peer_check(src, gen)
                return
            # injected clock: short real slices so synthetic time
            # advances are observed promptly
            slice_s = remaining if self._clock is time.monotonic \
                else min(remaining, 0.02)
            if self._closed.wait(slice_s):
                return

    def _peer_check(self, src: int, gen: int) -> None:
        """Grace timer body: if ``src`` has delivered nothing since the
        abnormal drop, presume it dead; a sender retry that reconnected in
        the window bumped the generation and voids the verdict."""
        if self._closed.is_set():
            return
        with self._match_lock:
            if self._peer_gen.get(src, 0) != gen:
                return  # delivered again — alive (retry/reconnect)
            self._fail_src_locked(src, ConnectionError(
                f"peer rank {src} presumed dead: connection dropped "
                f"mid-frame and nothing arrived within "
                f"peer_grace={self.peer_grace}s"))
        _PEER_DEATHS.labels(src).inc()
        logger.warn(
            "host_p2p rank %d: peer rank %d presumed dead (dropped "
            "mid-frame, nothing delivered within peer_grace=%.1fs)",
            self.rank, src, self.peer_grace)

    def mark_peer_dead(self, src: int,
                       error: Optional[BaseException] = None) -> None:
        """Fail every pending ``irecv`` from ``src`` now (an external
        failure detector — a cluster manager, a died subprocess — can
        short-circuit the grace window)."""
        with self._match_lock:
            self._fail_src_locked(src, error or ConnectionError(
                f"peer rank {src} marked dead"))
        _PEER_DEATHS.labels(src).inc()
        logger.warn("host_p2p rank %d: peer rank %d marked dead (%s)",
                    self.rank, src, error or "external failure detector")

    def _fail_src_locked(self, src: int, error: BaseException) -> None:
        for key in [k for k in self._waiting if k[0] == src]:
            for req in self._waiting.pop(key):
                if not req._cancelled:
                    req._finish(error=error)

    def irecv(self, source: int, tag: int = 0) -> Request:
        """Non-blocking receive (comms_t::irecv, core/comms.hpp:140);
        ``req.wait()`` returns the payload. Requests posted earlier match
        earlier messages (non-overtaking)."""
        if self._closed.is_set():
            raise ConnectionError("irecv on a closed HostP2P endpoint")
        req = Request("irecv", self._match_lock,
                      default_timeout=self.timeout, clock=self._clock)
        with self._match_lock:
            box = self._inbox.get((source, tag))
            if box:
                req._finish(box.popleft())
            elif self._closed.is_set():  # raced with close(): fail bounded
                req._finish(error=ConnectionError(
                    "HostP2P closed with receive outstanding"))
            elif source in self._drained:
                # the peer said goodbye: its message can never arrive —
                # fail now, typed, instead of waiting out the timeout
                req._finish(error=PeerDrained(
                    f"peer rank {source} announced a graceful drain"))
            else:
                self._waiting.setdefault(
                    (source, tag), collections.deque()).append(req)
        return req

    def discard(self, source: int, tag: int) -> int:
        """Drop any unclaimed inbox messages and cancelled waiters for
        ``(source, tag)`` — the cleanup half of the correlation-id
        protocol: an RPC client that abandons a request (deadline spent,
        replica written off) calls this so a late reply cannot sit in
        the inbox forever. Returns the number of messages dropped."""
        with self._match_lock:
            box = self._inbox.pop((source, tag), None)
            waiting = self._waiting.get((source, tag))
            if waiting is not None:
                live = collections.deque(
                    r for r in waiting if not r._cancelled)
                if live:
                    self._waiting[(source, tag)] = live
                else:
                    self._waiting.pop((source, tag), None)
        return len(box) if box else 0

    def correlation_id(self) -> int:
        """Allocate a fresh tag from the reserved correlation range —
        the request/response matching primitive: the requester posts
        ``irecv(source=peer, tag=cid)`` before sending, the responder
        echoes the cid as the reply tag, and the reply can match
        nothing else. Wraps inside [2**20, 2**30); user tags should
        stay below the base."""
        span = _CORR_LIMIT - _CORR_BASE
        return _CORR_BASE + (next(self._corr) % span)

    # ---------------------------------------------------------------- send
    def _sender_for(self, dest: int) -> "queue.Queue":
        with self._send_lock:
            q = self._send_queues.get(dest)
            if q is None:
                q = queue.Queue()
                self._send_queues[dest] = q
                threading.Thread(target=self._send_loop, args=(dest, q),
                                 daemon=True,
                                 name=f"raft-tpu-p2p-send-{dest}").start()
            return q

    def _connect(self, dest: int) -> socket.socket:
        """Open the persistent connection to ``dest``. The handshake runs
        as a non-blocking connect polled in short slices that observe
        ``_closed`` — closing an fd from another thread does NOT wake a
        thread already blocked inside poll on Linux, so a plain blocking
        connect could stall an in-flight isend's wait() for up to
        ``timeout`` after close() returned. Sockets register in ``_conns``
        so close() reaps them. Like socket.create_connection, every
        getaddrinfo result (v4 and v6) is tried before giving up."""
        if dest in self._partitioned:
            raise OSError(errno.EHOSTUNREACH,
                          f"rank {dest} partitioned (injected fault)")
        host, port = self.peers[dest]
        last_err: Optional[BaseException] = None
        for family, stype, proto, _, addr in socket.getaddrinfo(
                host, port, socket.AF_UNSPEC, socket.SOCK_STREAM):
            sock = socket.socket(family, stype, proto)
            with self._conns_lock:
                if self._closed.is_set():
                    sock.close()
                    raise _EndpointClosed("HostP2P closed")
                self._conns.add(sock)
            try:
                self._handshake(sock, addr, dest)
                return sock
            except _EndpointClosed:
                self._drop_conn(sock)
                raise  # closed mid-connect: don't try further addresses
            except (OSError, TimeoutError) as e:
                self._drop_conn(sock)
                last_err = e
        raise last_err if last_err is not None else OSError(
            f"getaddrinfo returned no addresses for {host}:{port}")

    def _wait_writable(self, sel: "selectors.BaseSelector") -> bool:
        """One poll slice of the handshake (the socket is registered once
        per connect — not one epoll fd per slice). close() may reap the
        socket concurrently — polling a dead fd maps to _EndpointClosed."""
        try:
            return bool(sel.select(0.25))
        except (ValueError, OSError):
            if self._closed.is_set():
                raise _EndpointClosed("HostP2P closed during connect")
            raise

    def _handshake(self, sock: socket.socket, addr, dest: int) -> None:
        """Sliced non-blocking connect (see _connect). selectors (epoll on
        Linux) rather than select(): no FD_SETSIZE-1024 limit."""
        sock.setblocking(False)
        rc = sock.connect_ex(addr)
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            raise OSError(rc, os.strerror(rc))
        deadline = self._clock() + self.timeout
        sel = selectors.DefaultSelector()
        try:
            if rc != 0:
                try:
                    sel.register(sock, selectors.EVENT_WRITE)
                except (ValueError, OSError):
                    if self._closed.is_set():
                        raise _EndpointClosed(
                            "HostP2P closed during connect")
                    raise
            while rc != 0:
                if self._closed.is_set():
                    raise _EndpointClosed("HostP2P closed during connect")
                if self._clock() > deadline:
                    raise TimeoutError(
                        f"connect to rank {dest} {addr} timed out after "
                        f"{self.timeout}s")
                if self._wait_writable(sel):
                    try:
                        rc = sock.getsockopt(socket.SOL_SOCKET,
                                             socket.SO_ERROR)
                    except OSError:
                        if self._closed.is_set():
                            raise _EndpointClosed(
                                "HostP2P closed during connect")
                        raise
                    if rc != 0:
                        raise OSError(rc, os.strerror(rc))
        finally:
            sel.close()
        sock.setblocking(True)
        sock.settimeout(self.timeout)

    def _drop_conn(self, sock: socket.socket) -> None:
        with self._conns_lock:
            self._conns.discard(sock)
        try:
            sock.close()
        except OSError:
            pass

    def _retry_delay(self, attempt: int) -> float:
        """Exponential backoff with full-range jitter (0.5×–1.5×) so a
        fleet of senders retrying into a restarted peer doesn't
        synchronize into a thundering herd."""
        base = min(self.retry_backoff * (2.0 ** (attempt - 1)),
                   self.retry_backoff_max)
        return base * (0.5 + random.random())

    def _set_active_send(self, dest: int, sock) -> None:
        with self._send_lock:
            if sock is None:
                self._active_send.pop(dest, None)
            else:
                self._active_send[dest] = sock

    def _sever_send(self, dest: int) -> bool:
        """Fault-injection hook (testing.faults.sever_connection): hard-cut
        the live outbound connection to ``dest`` so the next/current send
        fails as a real network partition would. Returns False when no
        connection is live."""
        with self._send_lock:
            sock = self._active_send.get(dest)
        if sock is None:
            return False
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        return True

    def _partition(self, rank: int) -> None:
        """Fault-injection hook (testing.faults.partition_hosts): drop the
        link to/from ``rank`` persistently — outbound connects refuse
        (EHOSTUNREACH), inbound frames are discarded — until
        :meth:`_heal`. Also cuts the live outbound socket so an
        in-flight send fails like a real partition onset."""
        with self._send_lock:
            self._partitioned = self._partitioned | {rank}
        self._sever_send(rank)

    def _heal(self, rank: int) -> None:
        """Undo :meth:`_partition` and clear the send-stream poison so
        traffic can flow again (see :meth:`reset_stream`)."""
        with self._send_lock:
            self._partitioned = self._partitioned - {rank}
        self.reset_stream(rank)

    def _set_link_delay(self, dest: int, delay_s: Optional[float]) -> None:
        """Fault-injection hook (testing.faults.delay_link): sleep
        ``delay_s`` before each frame to ``dest`` (None clears)."""
        with self._send_lock:
            d = dict(self._link_delay)
            if delay_s is None:
                d.pop(dest, None)
            else:
                d[dest] = float(delay_s)
            self._link_delay = d

    def reset_stream(self, dest: int) -> bool:
        """Clear the poison on the send stream to ``dest`` so the next
        send attempts a fresh connection. Poisoning exists to keep the
        non-overtaking stream gap-free — resetting it is the caller
        EXPLICITLY acknowledging that messages may have been lost in the
        gap (safe for the correlation-id RPC layer, which tracks every
        request individually and re-sends whole requests). Returns True
        when a poison was cleared."""
        with self._send_lock:
            return self._poison.pop(dest, None) is not None

    def _send_loop(self, dest: int, q: "queue.Queue"):
        """All sends to ``dest`` go through one connection in post order —
        the non-overtaking half of the contract. A transient failure is
        retried with backoff + jitter (the whole frame is resent on a
        fresh connection — at-least-once, see the class docstring); only
        after ``retries`` are exhausted does the failure POISON the
        stream: every later request to this destination fails with the
        original error, so the receiver can never observe a gap (message i
        lost, i+1 delivered). :meth:`reset_stream` clears the poison for
        callers (the RPC layer, a healed partition) that accept the
        gap explicitly."""
        sock = None
        while not self._closed.is_set():
            try:
                item = q.get(timeout=0.25)
            except queue.Empty:
                continue
            req, tag, ty, raw = item
            with self._send_lock:
                poison = self._poison.get(dest)
            if poison is not None:
                err = ConnectionError(
                    f"send stream to rank {dest} poisoned by earlier "
                    f"failure: {poison!r}")
                err.__cause__ = poison  # keep the class for isinstance
                req._finish(error=err)
                continue
            attempt = 0
            slept_s = 0.0  # cumulative backoff this frame (logged below)
            nbytes = _HDR.size + 1 + len(raw)
            while True:
                try:
                    delay_s = self._link_delay.get(dest)
                    if delay_s and self._closed.wait(delay_s):
                        raise _EndpointClosed("HostP2P closed")
                    if dest in self._partitioned:
                        raise OSError(
                            errno.EHOSTUNREACH,
                            f"rank {dest} partitioned (injected fault)")
                    if sock is None:
                        sock = self._connect(dest)
                        self._set_active_send(dest, sock)
                    sock.sendall(_HDR.pack(_MAGIC, self.rank, tag,
                                           len(raw)))
                    sock.sendall(ty)
                    sock.sendall(raw)
                    req._finish()
                    _SENT_MSGS.labels(dest).inc()
                    _SENT_BYTES.labels(dest).inc(nbytes)
                    break
                except _EndpointClosed as e:  # closed endpoint: terminal
                    req._finish(error=e)
                    with self._send_lock:
                        self._poison[dest] = e
                    break
                except BaseException as e:  # surfaced at wait()
                    if sock is not None:
                        self._set_active_send(dest, None)
                        self._drop_conn(sock)
                        sock = None
                    attempt += 1
                    if attempt > self.retries or self._closed.is_set():
                        req._finish(error=e)
                        with self._send_lock:
                            self._poison[dest] = e
                        _STREAMS_POISONED.labels(dest).inc()
                        logger.error(
                            "host_p2p rank %d: send to rank %d failed "
                            "after %d attempt(s), %.3f s cumulative "
                            "backoff; stream poisoned: %r",
                            self.rank, dest, attempt, slept_s, e)
                        break
                    delay = self._retry_delay(attempt)
                    slept_s += delay
                    _SEND_RETRIES.labels(dest).inc()
                    _BACKOFF_SECONDS.labels(dest).inc(delay)
                    logger.warn(
                        "host_p2p rank %d: send to rank %d failed "
                        "(attempt %d/%d): %r; backing off %.3f s "
                        "(%.3f s cumulative)",
                        self.rank, dest, attempt, self.retries, e,
                        delay, slept_s)
                    # backoff observes _closed so close() stays bounded
                    if self._closed.wait(delay):
                        req._finish(error=e)
                        with self._send_lock:
                            self._poison[dest] = e
                        break
        self._set_active_send(dest, None)
        if sock is not None:
            self._drop_conn(sock)
        _drain_queue(q, ConnectionError(
            f"HostP2P closed before send to rank {dest} completed"))

    def isend(self, payload: Union[bytes, np.ndarray], dest: int,
              tag: int = 0) -> Request:
        """Non-blocking send (comms_t::isend, core/comms.hpp:137)."""
        if not 0 <= dest < self.size:
            raise ValueError(f"dest {dest} out of range")
        if self._closed.is_set():
            raise ConnectionError("isend on a closed HostP2P endpoint")
        req = Request("isend", self._match_lock,
                      default_timeout=self.timeout, clock=self._clock)
        ty, raw = _encode(payload)  # encode eagerly: caller may mutate
        q = self._sender_for(dest)
        q.put((req, tag, ty, raw))
        if self._closed.is_set():
            # lost the race with a concurrent close(): its drain (and the
            # sender loop's exit drain) may already have run, so fail the
            # late put ourselves — double-drain is safe (get is atomic)
            _drain_queue(q, ConnectionError(
                "HostP2P closed before send completed"))
        return req

    def announce_drain(self, dest: int) -> Request:
        """Send the graceful-drain control frame to ``dest`` (module
        docstring): it rides the ordered send stream, so everything
        posted before it is delivered first, then the peer fails its
        pending irecvs from this rank with :class:`PeerDrained` and
        treats the connection EOF that follows as clean. Call before
        :meth:`close` for a polite shutdown (a crash simply doesn't)."""
        return self.isend(b"", dest, tag=_DRAIN_TAG)

    # ---------------------------------------------------------------- wait
    @staticmethod
    def waitall(requests: List[Request],
                timeout: Optional[float] = None) -> list:
        """Block on a mix of send/recv requests (comms_t::waitall,
        core/comms.hpp:141). Returns receive payloads in request order
        (None for sends). ``timeout`` is ONE deadline for the whole batch,
        not per-request: each wait gets only the time remaining.
        ``timeout=None`` falls back to each request's endpoint timeout —
        a real deadline either way, never an unbounded hang. The deadline
        runs on the first request's endpoint clock (one endpoint's
        requests share it), so fake-clock tests drive it too."""
        if timeout is None:
            return [r.wait() for r in requests]
        if not requests:
            return []
        clock = requests[0]._clock
        deadline = clock() + timeout
        return [r.wait(max(deadline - clock(), 0.0)) for r in requests]

    def sendrecv(self, payload, dest: int, source: int, tag: int = 0):
        """Convenience paired exchange (device_sendrecv's host analog)."""
        s = self.isend(payload, dest, tag)
        r = self.irecv(source, tag)
        self.waitall([s], self.timeout)
        return r.wait(self.timeout)

    def close(self):
        self._closed.set()
        # closing an fd does NOT wake a thread blocked in accept() on
        # Linux — poke the listener with a throwaway connection so the
        # accept loop observes _closed and exits (no leaked threads)
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            socket.create_connection(
                (self.peers[self.rank][0], self.peers[self.rank][1]),
                timeout=0.5).close()
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        # unblock _serve threads stuck in recv() on one-sided close;
        # the lock + _closed check in _accept_loop means no connection can
        # be admitted after this reap
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        # fail any isends still queued so no Request.wait() blocks forever
        # (sender loops also drain on exit; double-drain is safe)
        with self._send_lock:
            queues = list(self._send_queues.values())
        for q in queues:
            _drain_queue(q, ConnectionError(
                "HostP2P closed before send completed"))
        # ... and symmetrically, every pending irecv: its message can no
        # longer arrive (matching happens under _match_lock, so a request
        # is either finished by a delivery or failed here, never both)
        with self._match_lock:
            waiting, self._waiting = self._waiting, {}
        for reqs in waiting.values():
            for req in reqs:
                req._finish(error=ConnectionError(
                    "HostP2P closed with receive outstanding"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
