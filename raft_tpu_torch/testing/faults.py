"""Fault injectors for chaos tests: counterpart of the parts of
``raft_tpu.testing.faults`` that the ported modules can be hurt by.

- checkpoint bytes — :func:`flip_record_byte`, :func:`truncate_record`,
  :func:`truncate_file` corrupt or cut one framed record of a
  ``core.serialize`` v2 file, exercising the crc and footer checks;
- the mutable write path — :func:`tear_wal_tail` damages the LAST frame of
  a ``MutableIvf`` write-ahead log (cut mid-payload, or a byte flipped),
  the crash-mid-append shape recovery must classify as a typed
  ``IntegrityError(reason="torn_tail")`` and truncate away, and
  :func:`crash_compactor` kills the background compactor between artifact
  write and publish (``CompactorCrashed``);
- checkpoint files — :func:`delete_rank_file` removes one shard's rank
  file, exercising the degraded (``allow_partial``) restore;
- the serving device path — :func:`fail_next_dispatch`,
  :func:`hang_next_dispatch`, :func:`slow_searcher` perturb a serving
  ``Searcher`` handle's search call, exercising the engine's per-batch
  containment, the hang watchdog and the overload shedding;
- the host p2p fabric — :func:`sever_connection` hard-cuts a live
  outbound connection, :func:`partition_hosts` cuts a link both ways
  until healed, :func:`delay_link` slows one, :func:`kill_host` ends a
  replica process (SIGKILL) or an endpoint without a goodbye, exercising
  send retry, the peer-death grace and the remote proxy's typed mapping;
- fleet replicas — :func:`kill_replica` hard-stops one engine of a
  ``Fleet`` mid-traffic, :func:`hang_replica` stalls one replica's next
  search, :func:`trip_breaker` opens a replica's breaker directly;
- memory budget — :func:`shrink_workspace` pins a Resources' workspace
  ceiling low, exercising the tiled paths.

Every injector works on real bytes, sockets or the handle's real search
callable, so the detection paths under test are the ones production runs.
On the card, :func:`hang_replica` wraps the host call before the launch,
so the watchdog fails the batch before anything reaches the device, and
:func:`kill_replica`'s ``Engine.stop(drain=False)`` still settles every
batch already launched.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional, Tuple

from raft_tpu_torch.core.serialize import record_spans


def _span(path: str, record: int) -> Tuple[int, int]:
    spans = record_spans(path)
    if not -len(spans) <= record < len(spans):
        raise IndexError(
            f"{path}: record {record} out of range ({len(spans)} records, "
            f"footer included)")
    return spans[record]


def flip_record_byte(path: str, record: int, offset: int = 0) -> int:
    """XOR one payload byte of record ``record`` (negative indexes from the
    end; -1 is the footer) so the frame's crc32 no longer matches. Returns
    the absolute file offset flipped."""
    off, n = _span(path, record)
    if n == 0:
        raise ValueError(f"{path}: record {record} has an empty payload")
    if not 0 <= offset < n:
        raise IndexError(
            f"{path}: offset {offset} outside record {record}'s {n} "
            f"payload bytes")
    pos = off + offset
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    return pos


def truncate_record(path: str, record: int) -> int:
    """Cut the file mid-way through record ``record``'s payload (half of it
    survives), as a crash mid-write would. Returns the new size."""
    off, n = _span(path, record)
    new_size = off + n // 2
    with open(path, "r+b") as f:
        f.truncate(new_size)
    return new_size


def truncate_file(path: str, drop_bytes: int = 1) -> int:
    """Drop the last ``drop_bytes`` bytes. Returns the new size."""
    size = os.path.getsize(path)
    new_size = max(size - int(drop_bytes), 0)
    with open(path, "r+b") as f:
        f.truncate(new_size)
    return new_size


def delete_rank_file(prefix: str, rank: int) -> str:
    """Remove shard ``rank``'s checkpoint file (``prefix.rank<rank>``), a
    lost disk or object. Returns the removed path."""
    path = f"{prefix}.rank{rank}"
    os.remove(path)
    return path


# ------------------------------------------------------ fabric injectors


def sever_connection(endpoint, dest: int) -> bool:
    """Hard-cut ``endpoint``'s live outbound connection to rank ``dest``.
    False when no connection is open; the endpoint's send retry is
    expected to re-deliver."""
    return endpoint._sever_send(dest)


def partition_hosts(a, b):
    """Partition endpoint ``a`` from peer ``b`` (an endpoint: both ways; a
    bare rank: one-sided, the split-brain shape) until the returned
    ``heal()`` runs; heal also clears stream poison on both sides."""
    b_rank = b if isinstance(b, int) else b.rank
    a._partition(b_rank)
    two_way = not isinstance(b, int)
    if two_way:
        b._partition(a.rank)

    def heal():
        a._heal(b_rank)
        if two_way:
            b._heal(a.rank)
    return heal


def delay_link(endpoint, dest: int, delay_s: float):
    """Add ``delay_s`` before every frame ``endpoint`` sends to ``dest``.
    Returns a zero-argument restore function."""
    endpoint._set_link_delay(dest, float(delay_s))

    def restore():
        endpoint._set_link_delay(dest, None)
    return restore


def kill_host(target) -> None:
    """Abrupt death, no goodbye: SIGKILL for a ``subprocess.Popen`` (a
    ``replica_main`` child), ``close()`` without ``announce_drain`` for an
    endpoint, so peers reach the peer-death verdict, not ``PeerDrained``."""
    if hasattr(target, "kill") and hasattr(target, "pid"):
        target.kill()
        return
    target.close()


# ------------------------------------------------- mutable-WAL injectors


def _resolve_writer(target):
    """An Engine serving a mutable index, a ``MutableIvf`` or a WAL path →
    ``(writer or None, wal path)``."""
    if isinstance(target, (str, os.PathLike)):
        return None, os.fspath(target)
    if hasattr(target, "swap_index") and hasattr(target, "writer"):
        target = target.writer()
    wal_path = getattr(target, "wal_path", None)
    if wal_path is None:
        raise TypeError(
            f"tear_wal_tail wants an Engine serving a mutable index, a "
            f"MutableIvf writer, or a WAL path; got "
            f"{type(target).__name__}")
    return target, wal_path


def tear_wal_tail(target, mode: str = "truncate") -> str:
    """Damage the LAST frame of the write-ahead log: ``"truncate"`` cuts the
    file mid-way through the final record's payload, ``"flip"`` XORs one of
    its payload bytes. Nothing follows the damaged frame, so recovery must
    classify it ``torn_tail``. A writer is synced first, so that the frame
    under attack is on disk. Returns the damaged path."""
    writer, path = _resolve_writer(target)
    if writer is not None:
        writer.sync()
    if not record_spans(path):
        raise ValueError(f"{path}: no WAL records to tear")
    if mode == "truncate":
        truncate_record(path, -1)
    elif mode == "flip":
        flip_record_byte(path, -1)
    else:
        raise ValueError(f"unknown tear mode {mode!r}; "
                         f"expected 'truncate' or 'flip'")
    return path


def _resolve_compactor(target):
    """Engine / MutableIvf / Compactor → the Compactor."""
    if hasattr(target, "swap_index") and hasattr(target, "writer"):
        target = target.writer()
    comp = getattr(target, "compactor", target)
    if not hasattr(comp, "_crash_after_checkpoint"):
        raise TypeError(
            f"crash_compactor wants an Engine serving a mutable index, a "
            f"MutableIvf with an attached Compactor, or a Compactor; got "
            f"{type(target).__name__}")
    return comp


@contextlib.contextmanager
def crash_compactor(target) -> Iterator:
    """While active, any compaction run of ``target``'s compactor dies
    between artifact write (checkpoint durable) and publish (hot swap),
    recording a typed ``CompactorCrashed`` (outcome ``"failed"``). Yields
    the compactor."""
    comp = _resolve_compactor(target)
    comp._crash_after_checkpoint = True
    try:
        yield comp
    finally:
        comp._crash_after_checkpoint = False


# ----------------------------------------------------- serving injectors


class InjectedFault(RuntimeError):
    """What :func:`fail_next_dispatch` raises by default, so a test can
    assert that the engine relayed this cause (``BatchFailed.cause``)."""


def _wrap_search(searcher, wrapper):
    """Replace ``searcher.search`` with ``wrapper(original, queries, k)``;
    returns a zero-argument restore function."""
    original = searcher.search

    def wrapped(queries, k):
        return wrapper(original, queries, k)

    searcher.search = wrapped

    def restore():
        searcher.search = original

    return restore


def fail_next_dispatch(searcher, exc: Optional[BaseException] = None,
                       times: int = 1):
    """Arm ``searcher`` so that its next ``times`` searches raise (default
    :class:`InjectedFault`), then pass through. Returns the disarm
    function."""
    state = {"left": int(times)}
    lock = threading.Lock()

    def wrapper(original, queries, k):
        with lock:
            armed = state["left"] > 0
            if armed:
                state["left"] -= 1
        if armed:
            raise exc if exc is not None else InjectedFault(
                "injected dispatch failure")
        return original(queries, k)

    return _wrap_search(searcher, wrapper)


def hang_next_dispatch(searcher, hang_s: float, times: int = 1):
    """Arm ``searcher`` so that its next ``times`` searches block for
    ``hang_s`` seconds before delegating. Returns the disarm function."""
    state = {"left": int(times)}
    lock = threading.Lock()

    def wrapper(original, queries, k):
        with lock:
            armed = state["left"] > 0
            if armed:
                state["left"] -= 1
        if armed:
            time.sleep(float(hang_s))
        return original(queries, k)

    return _wrap_search(searcher, wrapper)


@contextlib.contextmanager
def slow_searcher(searcher, delay_s: float) -> Iterator:
    """While active, every search on ``searcher`` pays ``delay_s`` more."""
    restore = _wrap_search(
        searcher,
        lambda original, queries, k: (time.sleep(float(delay_s)),
                                      original(queries, k))[1])
    try:
        yield searcher
    finally:
        restore()


# ------------------------------------------------------- fleet injectors


def _resolve_replica(fleet_or_engine, replica):
    """An Engine (``replica`` ignored), or a Fleet and a replica name or
    index → the target engine."""
    engine = fleet_or_engine
    replicas = getattr(fleet_or_engine, "replicas", None)
    if replicas is not None:
        if isinstance(replica, int):
            engine = replicas[replica].engine
        else:
            by_name = {r.name: r.engine for r in replicas}
            if replica not in by_name:
                raise KeyError(
                    f"no replica {replica!r} (have {sorted(by_name)})")
            engine = by_name[replica]
    return engine


def kill_replica(fleet_or_engine, replica=None) -> None:
    """Hard-kill one replica mid-traffic (``Engine.stop(drain=False)``):
    queued riders fail typed, batches already launched still complete, and
    the replica goes ``"unhealthy"`` so the fleet routes around it. A
    killed engine does not come back."""
    _resolve_replica(fleet_or_engine, replica).stop(drain=False)


def hang_replica(fleet_or_engine, replica=None, hang_s: float = 60.0,
                 times: int = 1):
    """Stall one replica's next ``times`` searches for ``hang_s``: the
    watchdog fails the batch, trips the breaker, and the fleet routes
    around the replica until a probe closes it. Returns the disarm
    function."""
    engine = _resolve_replica(fleet_or_engine, replica)
    return hang_next_dispatch(engine.searcher, hang_s, times=times)


def trip_breaker(fleet_or_engine, replica=None) -> None:
    """Open one replica's circuit breaker now, as the watchdog would on a
    hang (``trip()`` and the trip counter)."""
    engine = _resolve_replica(fleet_or_engine, replica)
    engine.breaker.trip()
    engine.stats.record_breaker_trip()


@contextlib.contextmanager
def shrink_workspace(res, limit_bytes: int = 1 << 20,
                     restore: Optional[int] = None) -> Iterator:
    """Pin ``res``'s workspace limit to ``limit_bytes`` (1 MiB by default:
    small enough to force the tiled paths at test sizes) while active;
    the previous explicit limit (or ``restore``) comes back on exit."""
    prev = res._workspace_limit
    res._workspace_limit = int(limit_bytes)
    try:
        yield res
    finally:
        res._workspace_limit = prev if restore is None else int(restore)
