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
- the serving device path — :func:`fail_next_dispatch`,
  :func:`hang_next_dispatch`, :func:`slow_searcher` perturb a serving
  ``Searcher`` handle's search call, exercising the engine's per-batch
  containment, the hang watchdog and the overload shedding.

Every injector works on real bytes or on the handle's real search
callable, so the detection paths under test are the ones production runs.
The fleet injectors (replica kill, hang, breaker trip) come with the
replica fleet.
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
