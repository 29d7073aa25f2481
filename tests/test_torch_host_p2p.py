"""raft_tpu_torch.parallel.host_p2p against raft_tpu.parallel.host_p2p.

The frames a port endpoint writes are byte for byte raft_tpu's for the
same payloads (raw bytes, ndarrays of several types and shapes, the drain
control frame), read off a bare TCP listener; a port endpoint and a
raft_tpu endpoint exchange messages both ways in one process. The port's
own endpoints keep the ordering contract (irecvs matched in post order),
the correlation-id range and ``discard``, ``announce_drain`` →
``PeerDrained``, the peer-death verdict after ``peer_grace`` for a
connection cut mid-frame, and the fault seams through
``raft_tpu_torch.testing.faults`` (``sever_connection``,
``partition_hosts``, ``delay_link``). The ``raft_tpu_p2p_*`` families carry
raft_tpu's names. Every port comes from a bind to port 0.
"""

import errno
import socket
import struct
import threading
import time

import numpy as np
import pytest

from raft_tpu.parallel import host_p2p as jp2p
from raft_tpu_torch.parallel import host_p2p as tp2p
from raft_tpu_torch.testing import faults

T = 30  # every wait's bound, seconds

PAYLOADS = [
    b"raw bytes \x00\x01\xff",
    b"",
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.array([[1, -2], [3, 4]], dtype=np.int64),
    np.array([True, False, True]),
    np.float64(2.5),
    np.zeros((0, 7), np.int32),
]


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


def _same(a, b) -> bool:
    if isinstance(a, (bytes, bytearray)):
        return isinstance(b, (bytes, bytearray)) and bytes(a) == bytes(b)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


@pytest.fixture()
def pair():
    peers = [("127.0.0.1", p) for p in _ports(2)]
    a = tp2p.HostP2P(0, 2, peers=peers, timeout=T)
    b = tp2p.HostP2P(1, 2, peers=peers, timeout=T)
    yield a, b
    a.close()
    b.close()


# ------------------------------------------------------------- the wire


def _capture(mod, payloads) -> bytes:
    """Every byte endpoint rank 0 of ``mod`` writes to rank 1 (a bare
    listener) for ``payloads`` on tags 0, 1, ..., then its drain frame."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = []

    def reader():
        conn, _ = srv.accept()
        chunks = []
        with conn:
            while True:
                b = conn.recv(1 << 16)
                if not b:
                    break
                chunks.append(b)
        got.append(b"".join(chunks))

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    peers = [("127.0.0.1", _ports(1)[0]), srv.getsockname()]
    ep = mod.HostP2P(0, 2, peers=peers, timeout=T)
    try:
        reqs = [ep.isend(p, dest=1, tag=t) for t, p in enumerate(payloads)]
        reqs.append(ep.announce_drain(1))
        mod.HostP2P.waitall(reqs, timeout=T)
    finally:
        ep.close()
    th.join(T)
    srv.close()
    return got[0]


def test_frames_byte_for_byte_raft_tpus():
    mine, theirs = _capture(tp2p, PAYLOADS), _capture(jp2p, PAYLOADS)
    assert mine == theirs
    # the layout: [i32 magic][i32 src][i32 tag][u64 nbytes][type][payload]
    magic, src, tag, n = struct.unpack_from("<iiiQ", mine)
    assert (magic, src, tag, n) == (tp2p._MAGIC, 0, 0, len(PAYLOADS[0]))
    assert mine[20:21] == b"B" and mine[21:21 + n] == PAYLOADS[0]
    assert tp2p._HDR.format == jp2p._HDR.format
    assert (tp2p._MAGIC, tp2p._DRAIN_TAG, tp2p._CORR_BASE, tp2p._CORR_LIMIT) \
        == (jp2p._MAGIC, jp2p._DRAIN_TAG, jp2p._CORR_BASE, jp2p._CORR_LIMIT)


@pytest.mark.parametrize("port_rank", [0, 1])
def test_exchange_both_ways_with_raft_tpu(port_rank):
    peers = [("127.0.0.1", p) for p in _ports(2)]
    mods = (tp2p, jp2p) if port_rank == 0 else (jp2p, tp2p)
    a = mods[0].HostP2P(0, 2, peers=peers, timeout=T)
    b = mods[1].HostP2P(1, 2, peers=peers, timeout=T)
    try:
        for src, dst in ((a, b), (b, a)):
            recvs = [dst.irecv(source=src.rank, tag=t)
                     for t in range(len(PAYLOADS))]
            sends = [src.isend(p, dest=dst.rank, tag=t)
                     for t, p in enumerate(PAYLOADS)]
            type(src).waitall(sends, timeout=T)
            for r, want in zip(recvs, PAYLOADS):
                assert _same(r.wait(T), want)
        # an RPC across the packages: the reply rides the request's cid
        cid = a.correlation_id()
        reply = a.irecv(source=1, tag=cid)
        a.isend(np.array([cid], np.int64), dest=1, tag=3).wait(T)
        got = b.irecv(source=0, tag=3).wait(T)
        b.isend(b"pong", dest=0, tag=int(got[0])).wait(T)
        assert reply.wait(T) == b"pong"
    finally:
        a.close()
        b.close()


def test_p2p_family_names_equal_raft_tpus():
    def families(mod):
        return sorted((f.name, type(f).__name__, tuple(f.labelnames))
                      for f in vars(mod).values()
                      if hasattr(f, "labelnames") and hasattr(f, "name"))

    mine, theirs = families(tp2p), families(jp2p)
    assert mine == theirs and len(mine) == 8
    assert all(name.startswith("raft_tpu_p2p_") for name, _, _ in mine)


# ------------------------------------------------------------ matching


def test_same_tag_messages_keep_post_order(pair):
    a, b = pair
    recvs = [b.irecv(source=0, tag=1) for _ in range(16)]
    sends = [a.isend(np.array([i], np.int32), dest=1, tag=1)
             for i in range(16)]
    tp2p.HostP2P.waitall(sends, timeout=T)
    assert [int(r.wait(T)[0]) for r in recvs] == list(range(16))


def test_timed_out_irecv_does_not_steal_message(pair):
    a, b = pair
    r1 = b.irecv(source=0, tag=5)
    with pytest.raises(TimeoutError):
        r1.wait(0.2)
    a.isend(b"late", dest=1, tag=5).wait(T)
    assert b.irecv(source=0, tag=5).wait(T) == b"late"


def test_correlation_id_range_routes_reply_and_discard(pair):
    a, b = pair
    cids = [a.correlation_id() for _ in range(2048)]
    assert all(tp2p._CORR_BASE <= c < tp2p._CORR_LIMIT for c in cids)
    assert len(set(cids)) == len(cids)
    cid = a.correlation_id()
    decoy = a.irecv(source=1, tag=a.correlation_id())
    reply = a.irecv(source=1, tag=cid)
    b.isend(b"the-reply", dest=0, tag=cid).wait(T)
    assert reply.wait(T) == b"the-reply" and not decoy.done()
    decoy._cancelled = True
    # an abandoned cid's late reply is dropped, not matched later
    late = a.correlation_id()
    b.isend(b"too-late", dest=0, tag=late).wait(T)
    deadline, dropped = time.monotonic() + T, 0
    while not dropped and time.monotonic() < deadline:
        dropped = a.discard(1, late)
        time.sleep(0.005)
    assert dropped == 1
    with pytest.raises(TimeoutError):
        a.irecv(source=1, tag=late).wait(0.2)


# ----------------------------------------------------- drain and death


def test_announce_drain_fails_pending_and_later_irecvs(pair):
    a, b = pair
    pending = b.irecv(source=0, tag=4)
    a.announce_drain(1).wait(T)
    with pytest.raises(tp2p.PeerDrained):
        pending.wait(T)
    with pytest.raises(tp2p.PeerDrained):
        b.irecv(source=0, tag=5).wait(T)
    # a delivery after the goodbye clears the verdict
    a.isend(b"back", dest=1, tag=9).wait(T)
    deadline, got = time.monotonic() + T, None
    while got is None and time.monotonic() < deadline:
        try:
            got = b.irecv(source=0, tag=9).wait(0.5)
        except (tp2p.PeerDrained, TimeoutError):
            time.sleep(0.01)
    assert got == b"back"


def test_kill_host_forges_no_drain():
    peers = [("127.0.0.1", p) for p in _ports(2)]
    c = tp2p.HostP2P(0, 2, peers=peers, timeout=T, peer_grace=0.3)
    d = tp2p.HostP2P(1, 2, peers=peers, timeout=T, peer_grace=0.3)
    try:
        c.isend(b"hi", dest=1).wait(T)
        assert d.irecv(source=0).wait(T) == b"hi"
        r = d.irecv(source=0, tag=2)
        faults.kill_host(c)  # a clean EOF at a frame boundary, no goodbye
        with pytest.raises(TimeoutError) as got:
            r.wait(1.0)
        assert not isinstance(got.value, ConnectionError)
    finally:
        c.close()
        d.close()


def test_peer_death_verdict_after_grace_for_a_mid_frame_cut():
    """A sender that dies mid-frame: the receiver fails that source's
    pending irecvs with ConnectionError once ``peer_grace`` passes with
    nothing delivered, and counts the death."""
    port = _ports(1)[0]
    ep = tp2p.HostP2P(1, 2, peers=[("127.0.0.1", _ports(1)[0]),
                                   ("127.0.0.1", port)],
                      timeout=T, peer_grace=0.3)
    deaths = tp2p._PEER_DEATHS.labels(0)
    before = deaths.value
    try:
        r = ep.irecv(source=0, tag=7)
        s = socket.create_connection(("127.0.0.1", port), timeout=T)
        s.sendall(struct.pack("<iiiQ", tp2p._MAGIC, 0, 7, 100) + b"B"
                  + b"x" * 10)
        s.close()  # 90 payload bytes never come
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="presumed dead"):
            r.wait(T)
        assert time.monotonic() - t0 >= 0.25
        assert deaths.value == before + 1
    finally:
        ep.close()


# ------------------------------------------------------------ fault seams


def test_sever_connection_resends_on_a_fresh_connection(pair):
    a, b = pair
    a.isend(b"first", dest=1).wait(T)
    assert b.irecv(source=0).wait(T) == b"first"
    assert faults.sever_connection(a, 1)
    retries = tp2p._SEND_RETRIES.labels(1)
    before = retries.value
    deadline, got = time.monotonic() + T, None
    while got is None and time.monotonic() < deadline:
        a.isend(b"again", dest=1, tag=3).wait(T)
        try:
            got = b.irecv(source=0, tag=3).wait(1.0)
        except TimeoutError:
            pass
    assert got == b"again"
    assert retries.value >= before  # a cut may land between frames
    assert faults.sever_connection(a, 0) is False  # no live connection


def test_partition_refuses_typed_and_heal_restores(pair):
    a, b = pair
    a.isend(b"pre", dest=1).wait(T)
    assert b.irecv(source=0).wait(T) == b"pre"
    heal = faults.partition_hosts(a, b)  # both ways
    with pytest.raises(OSError) as got:
        a.isend(b"lost", dest=1).wait(T)
    causes, e = [], got.value
    while e is not None:
        causes.append(e)
        e = e.__cause__
    assert any(getattr(c, "errno", None) == errno.EHOSTUNREACH
               for c in causes), causes
    a.reset_stream(1)
    with pytest.raises(OSError):
        a.isend(b"still-lost", dest=1).wait(T)
    heal()
    a.isend(b"healed", dest=1, tag=8).wait(T)
    assert b.irecv(source=0, tag=8).wait(T) == b"healed"
    b.isend(b"and back", dest=0, tag=8).wait(T)
    assert a.irecv(source=1, tag=8).wait(T) == b"and back"


def test_delay_link_slows_each_frame_until_restored(pair):
    a, b = pair
    a.isend(b"warm", dest=1).wait(T)
    b.irecv(source=0).wait(T)
    restore = faults.delay_link(a, 1, 0.2)
    t0 = time.monotonic()
    a.isend(b"slow", dest=1, tag=2).wait(T)
    assert b.irecv(source=0, tag=2).wait(T) == b"slow"
    assert time.monotonic() - t0 >= 0.19
    restore()
    t0 = time.monotonic()
    a.isend(b"fast", dest=1, tag=2).wait(T)
    assert b.irecv(source=0, tag=2).wait(T) == b"fast"
    assert time.monotonic() - t0 < 0.19
