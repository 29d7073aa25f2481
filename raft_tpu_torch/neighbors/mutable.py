"""Crash-consistent mutable IVF: a WAL, tombstones and background
compaction published through the serving engine's hot swap.

Counterpart of ``raft_tpu.neighbors.mutable``, with its files byte for
byte: the same op stream writes the same ``wal.log``, and a directory
written by either package (checkpoint + WAL tail) opens in the other. A
:class:`MutableIvf` wraps an immutable base index (``ivf_flat`` or
``ivf_pq``) and layers three mutable structures on it:

- a **delta segment**: recent rows kept in a host mirror and scanned
  exactly on the card beside the base lists (a plain fp32 product,
  ``torch.matmul`` with TF32 off, a query chunk at a time within the
  workspace), merged by one ``select_k`` with the base candidates first,
  so ties break the same way on every call and across a crash and replay;
- a **tombstone bitset**: the standing filter of
  :func:`raft_tpu_torch.ops.select_k.select_k_filtered`, so that a base row
  whose id was deleted (or superseded by a delta upsert) never surfaces;
- a **write-ahead log** of ``core.serialize``'s ``[len][payload][crc32]``
  frames: ``add``/``upsert``/``delete`` return only once their frame is
  fsync-durable (fsyncs batch under a group-commit window), so replaying
  the WAL tail onto the last checkpoint loses no acknowledged write. A torn
  tail is truncated and reported as ``IntegrityError(reason="torn_tail")``;
  damage with bytes after it is ``reason="corrupt"``.

The base search is the family's own ``search`` (on the card, its fused
kernels), then ``select_k_filtered`` over the tombstone words; both
selections take ``select_k``'s kernel on the card.

:class:`Compactor` re-clusters delta + tombstones into a fresh base off the
hot path: snapshot under the writer lock, build (the family's ``build`` and
``extend`` on the writer's device, no lock held), install, checkpoint
(atomic) and trim the WAL, then publish through ``Engine.swap_index`` (or a
duck-typed ``rolling_swap`` target). A crash anywhere in it recovers. Each
run emits one ``kind="compaction"`` span on the closed
:data:`COMPACTION_REASONS`, reconciled 1:1 with
``raft_tpu_mutable_compactions_total``.

Locks: one leaf lock, ``MutableIvf._lock``, shared with its
:class:`WriteAheadLog`, so that append and apply commit in lsn order; the
compactor's wake condition is its own leaf lock.
"""

from __future__ import annotations

import dataclasses
import io
import os
import threading
import time
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import IntegrityError, RaftError
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops.distance import (DistanceType, dot_fp32,
                                         is_min_close, resolve_metric)
from raft_tpu_torch.ops.select_k import (SelectAlgo, select_k,
                                         select_k_filtered)

__all__ = [
    "COMPACTION_OUTCOMES", "COMPACTION_REASONS", "Compactor",
    "CompactorCrashed", "MutableIvf", "WalRecord", "WriteAheadLog",
    "WriteStalled", "read_wal", "verify_dir", "verify_wal",
]

WAL_KIND = "mutable_wal"
WAL_VERSION = 1
CKPT_KIND = "mutable_ivf"
CKPT_VERSION = 2
#: file names inside a MutableIvf directory
WAL_FILE = "wal.log"
CKPT_FILE = "checkpoint.idx"

OP_ADD, OP_UPSERT, OP_DELETE = 1, 2, 3
_OP_NAMES = {OP_ADD: "add", OP_UPSERT: "upsert", OP_DELETE: "delete"}

#: closed compaction-trigger vocabulary (anything else is a ValueError)
COMPACTION_REASONS = frozenset(
    {"delta_threshold", "tombstone_ratio", "interval", "manual"})
#: closed per-run outcome vocabulary (the span and counter label)
COMPACTION_OUTCOMES = frozenset({"ok", "failed", "skipped"})

_FAMILIES = ("ivf_flat", "ivf_pq")


class WriteStalled(RaftError):
    """A durability wait exceeded ``ack_timeout_s``. The write is in the
    in-memory index and may be durable: treat it as unacknowledged (add,
    upsert and delete replay idempotently)."""


class CompactorCrashed(RaftError):
    """Injected compactor death (``testing.faults.crash_compactor``): the
    run aborts between artifact write and publish."""


# ===================================================================== WAL


class WalRecord(NamedTuple):
    """One decoded WAL record."""

    lsn: int
    op: int
    ids: np.ndarray  # [n] int32
    vectors: np.ndarray  # [n, dim] float32 ([0, dim] for deletes)


def _encode_record(lsn: int, op: int, ids: np.ndarray,
                   vectors: np.ndarray) -> bytes:
    buf = io.BytesIO()
    ser.serialize_scalar(buf, int(lsn), "<i8")
    ser.serialize_scalar(buf, int(op), "<i4")
    ser.serialize_array(buf, np.asarray(ids, np.int32))
    ser.serialize_array(buf, np.asarray(vectors, np.float32))
    return buf.getvalue()


def _decode_record(payload: bytes) -> WalRecord:
    buf = io.BytesIO(payload)
    lsn = int(ser.deserialize_scalar(buf))
    op = int(ser.deserialize_scalar(buf))
    ids = ser.deserialize_array(buf)
    vectors = ser.deserialize_array(buf)
    if op not in _OP_NAMES:
        raise IntegrityError(f"WAL record lsn={lsn}: unknown op {op}",
                             reason="corrupt")
    return WalRecord(lsn, op, ids, vectors)


def _wal_header() -> bytes:
    return ser.header_bytes(WAL_KIND, WAL_VERSION)


class WalScan(NamedTuple):
    """A WAL read front to back."""

    #: "ok" | "torn_tail" | "corrupt" | "missing"
    status: str
    records: List[WalRecord]
    #: byte offset of the end of the last intact frame (truncation point)
    good_end: int
    #: the typed fault of a non-ok status, else None
    error: Optional[IntegrityError]


def read_wal(path) -> WalScan:
    """Scan a WAL front to back and classify damage by where it sits: every
    frame intact → ``"ok"``; the last frame short or failing its crc with
    nothing after it → ``"torn_tail"`` (truncate at ``good_end``); a bad
    frame with bytes after it → ``"corrupt"``."""
    if not os.path.exists(path):
        return WalScan("missing", [], 0, IntegrityError(
            f"{path}: WAL missing", path=str(path), reason="missing"))
    records: List[WalRecord] = []
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        header = _wal_header()
        if f.read(len(header)) != header:
            return WalScan("corrupt", [], 0, IntegrityError(
                f"{path}: bad WAL header", path=str(path), reason="corrupt"))
        good_end = f.tell()
        n_rec = 0
        while True:
            hdr = f.read(ser.FRAME_LEN.size)
            if not hdr:
                return WalScan("ok", records, good_end, None)

            def torn(detail: str) -> WalScan:
                return WalScan("torn_tail", records, good_end, IntegrityError(
                    f"{path}: record {n_rec}: torn tail ({detail}) — "
                    f"truncating at byte {good_end} recovers every "
                    f"acknowledged write",
                    path=str(path), record=n_rec, reason="torn_tail"))

            if len(hdr) < ser.FRAME_LEN.size:
                return torn("partial length prefix")
            (n,) = ser.FRAME_LEN.unpack(hdr)
            payload = f.read(n)
            if len(payload) < n:
                return torn(f"{len(payload)} of {n} payload bytes")
            crc_raw = f.read(ser.FRAME_CRC.size)
            if len(crc_raw) < ser.FRAME_CRC.size:
                return torn("partial crc")
            (crc,) = ser.FRAME_CRC.unpack(crc_raw)
            if zlib.crc32(payload) != crc:
                if f.tell() >= size:
                    return torn(f"crc mismatch on the final frame "
                                f"({n} bytes)")
                return WalScan("corrupt", records, good_end, IntegrityError(
                    f"{path}: record {n_rec}: crc32 mismatch with "
                    f"{size - f.tell()} bytes after it — damage in the "
                    f"durable prefix, not a torn tail",
                    path=str(path), record=n_rec, reason="corrupt"))
            try:
                records.append(_decode_record(payload))
            except (IntegrityError, ValueError) as e:
                return WalScan("corrupt", records, good_end, IntegrityError(
                    f"{path}: record {n_rec}: {e}", path=str(path),
                    record=n_rec, reason="corrupt"))
            good_end = f.tell()
            n_rec += 1


def verify_wal(path) -> dict:
    """One WAL's status, record count and the lsn range a recovery would
    replay."""
    scan = read_wal(path)
    lsns = [r.lsn for r in scan.records]
    return {
        "path": str(path),
        "status": scan.status,
        "records": len(scan.records),
        "first_lsn": min(lsns) if lsns else None,
        "last_lsn": max(lsns) if lsns else None,
        "good_end": scan.good_end,
        "error": str(scan.error) if scan.error is not None else None,
    }


class WriteAheadLog:
    """Append-only framed log with group-commit fsync batching.

    The header is ``IndexWriter``'s (magic, format v2, kind
    ``mutable_wal``), so ``core.serialize.record_spans`` and the byte-level
    fault injectors work on it; records are v2 frames with no footer.
    ``lock`` may be the owner's (``MutableIvf`` shares its state lock), so
    that "assign lsn + append + apply" is one critical section. A writer
    waits (budgeted) on a condition of that lock until the flusher's fsync
    covers its lsn; the flusher sleeps ``group_window_s`` after the first
    pending append and fsyncs with no lock held."""

    def __init__(self, path, *, lock: Optional[threading.Lock] = None,
                 group_window_s: float = 0.002):
        self.path = str(path)
        self.group_window_s = float(group_window_s)
        self._lock = lock if lock is not None else threading.Lock()
        self._cond = threading.Condition(self._lock)
        fresh = not os.path.exists(self.path) \
            or os.path.getsize(self.path) == 0
        self._file = open(self.path, "ab")  # guarded_by: _lock
        if fresh:
            self._file.write(_wal_header())
            self._file.flush()
            os.fsync(self._file.fileno())
        self._next_lsn = 1  # guarded_by: _lock
        self._appended_lsn = 0  # guarded_by: _lock
        self._durable_lsn = 0  # guarded_by: _lock
        self._appended_bytes = 0  # guarded_by: _lock
        self._closed = False  # guarded_by: _lock
        #: last benign fsync race (the handle rotated or closed mid-sync)
        self.last_sync_error: Optional[BaseException] = None  # guarded_by: atomic
        self._flusher = threading.Thread(
            target=self._flush_loop, name=f"wal-flush:{self.path}",
            daemon=True)
        self._flusher.start()

    def set_next_lsn(self, lsn: int) -> None:
        """Advance the lsn counter past replayed history (recovery)."""
        with self._lock:
            self._next_lsn = max(self._next_lsn, int(lsn))

    def append_locked(self, op: int, ids: np.ndarray,
                      vectors: np.ndarray) -> Tuple[int, int]:
        """Assign the next lsn and buffer one framed record; the caller
        holds the lock. Returns ``(lsn, frame_bytes)``."""
        if self._closed:
            raise ValueError(f"{self.path}: append on a closed WAL")
        lsn = self._next_lsn
        self._next_lsn += 1
        frame = ser.frame(_encode_record(lsn, op, ids, vectors))
        self._file.write(frame)
        self._appended_lsn = lsn
        self._appended_bytes += len(frame)
        self._cond.notify_all()
        return lsn, len(frame)

    def append(self, op: int, ids, vectors) -> int:
        """Standalone append (takes the lock itself)."""
        with self._lock:
            lsn, _ = self.append_locked(op, np.asarray(ids, np.int32),
                                        np.asarray(vectors, np.float32))
        return lsn

    def wait_durable(self, lsn: int, timeout_s: float) -> None:
        """Block until the fsync frontier covers ``lsn`` (budgeted)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while self._durable_lsn < lsn and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise WriteStalled(
                        f"{self.path}: lsn {lsn} not durable within "
                        f"{timeout_s:.3f}s (durable frontier "
                        f"{self._durable_lsn})")
                self._cond.wait(timeout=remaining)
            if self._durable_lsn < lsn:
                raise WriteStalled(
                    f"{self.path}: WAL closed before lsn {lsn} became "
                    f"durable")

    def commit(self, op: int, ids, vectors, timeout_s: float = 30.0) -> int:
        """Append and wait for durability."""
        lsn = self.append(op, ids, vectors)
        self.wait_durable(lsn, timeout_s)
        return lsn

    def _flush_loop(self) -> None:
        while True:
            with self._lock:
                while (not self._closed
                       and self._appended_lsn <= self._durable_lsn):
                    self._cond.wait(timeout=0.05)
                if self._closed and self._appended_lsn <= self._durable_lsn:
                    return
            if self.group_window_s > 0:
                time.sleep(self.group_window_s)
            self._sync()

    def _sync(self) -> None:
        # flush under the lock, fsync outside it (appends are ordered, so
        # the fsync covers every lsn <= target), then advance the frontier
        with self._lock:
            target = self._appended_lsn
            if target <= self._durable_lsn:
                return
            f = self._file
            f.flush()
        try:
            os.fsync(f.fileno())
        except (OSError, ValueError) as e:
            # rotated (trim_locked) or closed under us: both fsync everything
            # appended before swapping the file
            self.last_sync_error = e
        with self._lock:
            self._durable_lsn = max(self._durable_lsn, target)
            self._cond.notify_all()

    def sync(self) -> int:
        """Flush and fsync now; returns the durable lsn."""
        self._sync()
        with self._lock:
            return self._durable_lsn

    def trim_locked(self, keep_gt_lsn: int) -> int:
        """Rewrite the WAL atomically keeping the records with ``lsn >
        keep_gt_lsn``; the caller holds the lock. Returns records kept."""
        self._file.flush()
        os.fsync(self._file.fileno())
        scan = read_wal(self.path)
        keep = [r for r in scan.records if r.lsn > keep_gt_lsn]
        with ser.writer_for(self.path) as stream:
            stream.write(_wal_header())
            for r in keep:
                stream.write(ser.frame(_encode_record(r.lsn, r.op, r.ids,
                                                      r.vectors)))
        self._file.close()
        self._file = open(self.path, "ab")
        self._durable_lsn = max(self._durable_lsn, self._appended_lsn)
        self._cond.notify_all()
        return len(keep)

    @property
    def appended_bytes(self) -> int:
        with self._lock:
            return self._appended_bytes

    @property
    def durable_lsn(self) -> int:
        with self._lock:
            return self._durable_lsn

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._flusher.join(timeout=5.0)
        with self._lock:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._durable_lsn = max(self._durable_lsn, self._appended_lsn)
            self._file.close()
            self._cond.notify_all()


# ================================================================ MutableIvf


class _Mirror:
    """Host source of truth of the mutable overlay (numpy, mutated under
    the writer lock; kept off the index's attributes so that a serving
    ``Searcher.place()`` never moves it)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.rows = np.zeros((0, dim), np.float32)  # [cap, dim]
        self.ids = np.zeros((0,), np.int32)  # [cap], -1 = free
        self.lsns = np.zeros((0,), np.int64)  # [cap] insertion lsn
        self.count = 0  # slots used (dense prefix)
        self.slot_of: dict = {}  # live delta id -> slot
        self.tombs: set = set()  # deleted ids whose base copy must hide
        self.base_ids: frozenset = frozenset()  # ids resident in the base
        self.words = np.zeros((1,), np.uint32)  # base-ok standing filter
        self.applied_lsn = 0
        self.next_id = 0
        self.version = 0

    def _ensure_words(self, max_id: int) -> None:
        need = max_id // 32 + 1
        if need > len(self.words):
            cap = 1 << (need - 1).bit_length()
            grown = np.zeros((cap,), np.uint32)
            grown[: len(self.words)] = self.words
            self.words = grown

    def _set_base_ok(self, id_: int, ok: bool) -> None:
        self._ensure_words(id_)
        w, b = id_ // 32, id_ % 32
        if ok:
            self.words[w] |= np.uint32(1 << b)
        else:
            self.words[w] &= ~np.uint32(1 << b)

    def rebuild_words(self) -> None:
        """Recompute the base-ok bitset: a base row's bit is set iff its id
        is neither deleted nor superseded by a delta copy."""
        ids = np.fromiter(self.base_ids, np.int64, len(self.base_ids))
        self.words = np.zeros((max(len(self.words), 1),), np.uint32)
        if len(ids):
            self._ensure_words(int(ids.max()))
            dead = np.fromiter(self.tombs | set(self.slot_of), np.int64)
            alive = ids[~np.isin(ids, dead)]
            bits = np.zeros(len(self.words) * 32, bool)
            bits[alive] = True
            self.words = np.packbits(bits, bitorder="little").view(np.uint32)

    def _grow(self, need: int) -> None:
        cap = max(64, 1 << (need - 1).bit_length())
        if cap <= len(self.ids):
            return
        rows = np.zeros((cap, self.dim), np.float32)
        rows[: self.count] = self.rows[: self.count]
        ids = np.full((cap,), -1, np.int32)
        ids[: self.count] = self.ids[: self.count]
        lsns = np.zeros((cap,), np.int64)
        lsns[: self.count] = self.lsns[: self.count]
        self.rows, self.ids, self.lsns = rows, ids, lsns

    def put(self, id_: int, row: np.ndarray, lsn: int) -> None:
        """Insert or replace one delta row; hides any base copy."""
        old = self.slot_of.get(id_)
        if old is not None:
            self.rows[old] = row
            self.lsns[old] = lsn
        else:
            self._grow(self.count + 1)
            slot = self.count
            self.rows[slot] = row
            self.ids[slot] = id_
            self.lsns[slot] = lsn
            self.slot_of[id_] = slot
            self.count += 1
        self.tombs.discard(id_)
        if id_ in self.base_ids:
            self._set_base_ok(id_, False)
        self.next_id = max(self.next_id, id_ + 1)

    def drop(self, id_: int) -> bool:
        """Delete one id (its delta slot freed, its base copy tombstoned).
        Returns whether the id was live."""
        live = False
        slot = self.slot_of.pop(id_, None)
        if slot is not None:
            self.ids[slot] = -1
            live = True
        if id_ in self.base_ids and id_ not in self.tombs:
            self._set_base_ok(id_, False)
            live = True
        if live:
            # every live drop is tombstoned: a delta row deleted while a
            # compaction build is in flight is in the build's snapshot, and
            # this tombstone (filtered against the new base at install)
            # keeps it from coming back
            self.tombs.add(id_)
        return live

    def delta_live(self) -> int:
        return len(self.slot_of)

    def masked_base(self) -> int:
        return len(self.base_ids & (self.tombs | set(self.slot_of)))

    def live_ids(self) -> set:
        return (self.base_ids - self.tombs - set(self.slot_of)) \
            | set(self.slot_of)

    def is_live(self, id_: int) -> bool:
        return id_ in self.slot_of or (id_ in self.base_ids
                                       and id_ not in self.tombs)

    def live_count(self) -> int:
        """``len(live_ids())`` without building the set: the base rows not
        masked, plus the delta."""
        return len(self.base_ids) - self.masked_base() + len(self.slot_of)

    def tombstone_live_ratio(self) -> float:
        return self.masked_base() / max(len(self.base_ids), 1)


class _Cache(NamedTuple):
    """Device snapshot of one mirror version (the search path)."""

    version: int
    base: object
    rows: torch.Tensor  # [cap, dim]
    ids: torch.Tensor  # [cap] int32, -1 invalid
    words: torch.Tensor  # the uint32 base-ok filter's words as int64
    cap: int
    masked_base: int
    base_rows: int


class _CompactionSnapshot(NamedTuple):
    """The compactor's build input. For ivf_flat, ``vectors``/``ids`` are
    every live row (a full re-cluster that also sheds tombstoned rows). For
    ivf_pq the base stores codes, so ``vectors`` are the delta rows not
    already resident in the base, encoded into it by ``extend`` (tombstones
    stay filter bits); delta ids that superseded a base row
    (``keep_delta_ids``) stay in the delta, keeping the base copy
    masked."""

    vectors: np.ndarray
    ids: np.ndarray
    lsn: int
    base: object
    full_rebuild: bool
    n_base: int
    n_delta: int
    keep_delta_ids: frozenset


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on CUDA copied from pinned memory without
    blocking, so that the copy never waits on the work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class MutableIvf:
    """Mutable overlay over one immutable IVF base index.

    Construct on a directory: a checkpoint there restores (the WAL tail
    replayed, a torn tail truncated as typed ``torn_tail``); an empty
    directory starts fresh (``dim`` required, ``base`` optional: a built
    family index whose ids become the base id set). The overlay lives on
    ``res``'s device (the base's device when ``res`` is None and a base is
    given; CUDA unless asked for the CPU).

    :meth:`add`/:meth:`upsert`/:meth:`delete` return only once the WAL
    frame is fsync-durable. :meth:`search` merges base and delta with
    deleted ids filtered. :meth:`checkpoint` persists the state atomically
    and trims the WAL; :class:`Compactor` re-clusters in the background."""

    def __init__(self, directory, *, dim: Optional[int] = None,
                 family: str = "ivf_flat", base=None,
                 index_params=None, search_params=None,
                 res: Optional[Resources] = None, device=None,
                 name: Optional[str] = None,
                 registry: Optional[obs_metrics.Registry] = None,
                 span_sink=None, group_window_s: float = 0.002,
                 ack_timeout_s: float = 30.0):
        if family not in _FAMILIES:
            raise ValueError(f"family must be one of {_FAMILIES}, got "
                             f"{family!r}")
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.family = family
        self.index_params = index_params
        self.search_params = search_params
        if res is None and device is None and base is not None:
            device = base.device
        self.res = ensure_resources(res, device)
        self.name = name if name is not None else os.path.basename(
            os.path.normpath(self.directory))
        self.span_sink = span_sink
        self.ack_timeout_s = float(ack_timeout_s)
        self._lock = threading.Lock()
        self._closed = False  # guarded_by: _lock
        self.compactor: Optional["Compactor"] = None
        self._init_metrics(registry)

        ckpt = os.path.join(self.directory, CKPT_FILE)
        self.recovery: Optional[dict] = None
        self._ckpt_metric: Optional[str] = None
        if os.path.exists(ckpt):
            self.base, self._mirror = self._restore_checkpoint(ckpt)
        else:
            if base is not None:
                dim = int(base.dim)
            if dim is None:
                raise ValueError(
                    f"{self.directory}: no checkpoint to restore and no "
                    f"dim given for a fresh index")
            self.base = base  # guarded_by: _lock (compaction install)
            self._mirror = self._fresh_mirror(int(dim), base)
        self.dim = int(self._mirror.dim)
        # the metric of the live base, then a base-less checkpoint's, then
        # the params'
        if self.base is not None:
            self.metric = resolve_metric(self.base.metric)
        elif self._ckpt_metric is not None:
            self.metric = resolve_metric(self._ckpt_metric)
        else:
            self.metric = resolve_metric(
                getattr(index_params, "metric", DistanceType.L2Expanded))
        self._cache: Optional[_Cache] = None  # guarded_by: _lock

        wal_path = os.path.join(self.directory, WAL_FILE)
        self._recover_wal(wal_path)
        # opened after the replay, so that the recovery reads raw bytes
        self._wal = WriteAheadLog(wal_path, lock=self._lock,
                                  group_window_s=group_window_s)
        self._wal.set_next_lsn(self._mirror.applied_lsn + 1)
        self._set_gauges()

    @property
    def device(self) -> torch.device:
        return self.res.device

    # ------------------------------------------------------------- metrics
    def _init_metrics(self, registry) -> None:
        r = registry if registry is not None else obs_metrics.REGISTRY
        self.registry = r
        n = self.name
        writes = r.counter(
            "raft_tpu_mutable_writes_total",
            "Write operations applied to the mutable overlay, by op.",
            ("index", "op"))
        self._m_writes = {op: writes.labels(n, op)
                          for op in _OP_NAMES.values()}
        self._m_acks = r.counter(
            "raft_tpu_mutable_acks_total",
            "Writes acknowledged fsync-durable (ack ⊆ write; the gap is "
            "in-flight or stalled).", ("index",)).labels(n)
        self._m_wal_bytes = r.counter(
            "raft_tpu_mutable_wal_bytes_total",
            "Framed bytes appended to the WAL.", ("index",)).labels(n)
        replays = r.counter(
            "raft_tpu_mutable_replays_total",
            "WAL recovery scans by classification.", ("index", "status"))
        self._m_replays = {s: replays.labels(n, s)
                           for s in ("ok", "torn_tail")}
        self._m_compactions = r.counter(
            "raft_tpu_mutable_compactions_total",
            "Compaction runs by (reason, outcome) — reconciles 1:1 with "
            "kind=\"compaction\" spans.", ("index", "reason", "outcome"))
        self._m_stalls = r.counter(
            "raft_tpu_mutable_compaction_stalls_total",
            "Compaction runs that exceeded stall_timeout_s (each also "
            "emits kind=\"compaction_stall\" and trips the publish "
            "target's flight recorder).", ("index",)).labels(n)
        self._m_filtered = r.counter(
            "raft_tpu_mutable_filtered_rows_total",
            "Candidates removed by the tombstone standing filter in "
            "select_k_filtered.", ("index",)).labels(n)
        self._g_ratio = r.gauge(
            "raft_tpu_mutable_tombstone_live_ratio",
            "Masked base rows (deleted or superseded) / base rows — the "
            "compaction-pressure signal.", ("index",)).labels(n)
        self._g_delta = r.gauge(
            "raft_tpu_mutable_delta_rows",
            "Live rows in the delta segment.", ("index",)).labels(n)

    def _set_gauges(self) -> None:
        with self._lock:
            m = self._mirror
            ratio = m.tombstone_live_ratio()
            delta = float(m.delta_live())
        self._g_ratio.set(ratio)
        self._g_delta.set(delta)

    # ------------------------------------------------------------- restore
    def _fresh_mirror(self, dim: int, base) -> _Mirror:
        m = _Mirror(dim)
        if base is not None:
            ids = _index_ids(base)
            m.base_ids = frozenset(ids.tolist())
            m.next_id = (int(ids.max()) + 1) if len(ids) else 0
            m.rebuild_words()
        return m

    def _restore_checkpoint(self, path):
        with ser.reader_for(path) as stream:
            r = ser.IndexReader(stream, CKPT_KIND, CKPT_VERSION,
                                name=str(path))
            # the directory knows best: adopt the persisted family
            self.family = r.string()
            self._ckpt_metric = r.string()
            dim = int(r.scalar())
            applied = int(r.scalar())
            next_id = int(r.scalar())
            has_base = int(r.scalar())
            d_ids = r.array()
            d_lsns = r.array()
            d_rows = r.array()
            tombs = r.array()
            base = None
            if has_base:
                base = _family_mod(self.family).deserialize(
                    io.BytesIO(r.blob()), res=self.res)
            r.finish()
        m = self._fresh_mirror(dim, base)
        m.applied_lsn = applied
        for i in range(len(d_ids)):
            m.put(int(d_ids[i]), d_rows[i], int(d_lsns[i]))
        for t in tombs:
            m.drop(int(t))
        m.next_id = max(m.next_id, next_id)
        m.version += 1
        return base, m

    def _recover_wal(self, wal_path: str) -> int:
        """Classify and repair the WAL and replay its tail onto the restored
        state: a torn tail is truncated (typed, recorded), mid-file damage
        raises."""
        if not os.path.exists(wal_path):
            return 0
        scan = read_wal(wal_path)
        if scan.status == "corrupt":
            raise scan.error
        if scan.status == "torn_tail":
            with open(wal_path, "r+b") as f:
                f.truncate(scan.good_end)
                f.flush()
                os.fsync(f.fileno())
        replayed = 0
        with self._lock:
            for rec in scan.records:
                if rec.lsn <= self._mirror.applied_lsn:
                    continue
                self._apply_locked(rec.op, rec.ids, rec.vectors, rec.lsn)
                replayed += 1
        status = scan.status if scan.status in ("ok", "torn_tail") else "ok"
        self._m_replays[status].inc()
        self.recovery = {
            "status": scan.status, "replayed": replayed,
            "error": scan.error,
            "applied_lsn": self._mirror.applied_lsn,
        }
        obs_spans.safe_emit(self.span_sink, {
            "kind": "wal_replay", "index": self.name,
            "status": scan.status, "replayed": replayed,
            "applied_lsn": self._mirror.applied_lsn,
        })
        return replayed

    # -------------------------------------------------------------- writes
    def _check_vectors(self, vectors) -> np.ndarray:
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        v = np.asarray(vectors, np.float32)
        if v.ndim == 1:
            v = v[None, :]
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"vectors must be [n, {self.dim}], got "
                             f"{v.shape}")
        return v

    def _apply_locked(self, op: int, ids: np.ndarray, vectors: np.ndarray,
                      lsn: int) -> None:
        m = self._mirror
        if op == OP_DELETE:
            for id_ in ids:
                m.drop(int(id_))
        else:
            for i, id_ in enumerate(ids):
                m.put(int(id_), vectors[i], lsn)
        m.applied_lsn = max(m.applied_lsn, lsn)
        m.version += 1

    def _write(self, op: int, ids, vectors: np.ndarray,
               timeout_s: Optional[float]) -> Tuple[int, np.ndarray]:
        """Id resolution, WAL append and in-memory apply in one critical
        section; ``ids`` may be a callable of the mirror (``add`` assigns
        fresh ids under the lock)."""
        budget = self.ack_timeout_s if timeout_s is None else timeout_s
        with self._lock:
            resolved = ids(self._mirror) if callable(ids) else ids
            lsn, nbytes = self._wal.append_locked(op, resolved, vectors)
            self._apply_locked(op, resolved, vectors, lsn)
        self._m_writes[_OP_NAMES[op]].inc()
        self._m_wal_bytes.inc(nbytes)
        self._set_gauges()
        self._wal.wait_durable(lsn, budget)
        self._m_acks.inc()
        return lsn, resolved

    def add(self, vectors, ids=None, timeout_s: Optional[float] = None
            ) -> np.ndarray:
        """Append new rows (ids assigned when not given; explicit ids must
        not be live). Returns the int32 ids once fsync-durable."""
        v = self._check_vectors(vectors)
        explicit = None
        if ids is not None:
            explicit = np.asarray(ids, np.int32).reshape(-1)
            if len(explicit) != len(v):
                raise ValueError(f"{len(explicit)} ids for {len(v)} vectors")

        def assign(m: _Mirror) -> np.ndarray:
            if explicit is None:
                return np.arange(m.next_id, m.next_id + len(v),
                                 dtype=np.int32)
            clash = [int(i) for i in explicit if m.is_live(int(i))]
            if clash:
                raise ValueError(
                    f"add() of live ids {clash[:8]} — use upsert() "
                    f"to replace")
            return explicit

        _, out = self._write(OP_ADD, assign, v, timeout_s)
        return out

    def upsert(self, vectors, ids, timeout_s: Optional[float] = None) -> int:
        """Insert or replace rows by id; the old copy never surfaces again.
        Returns the commit lsn."""
        v = self._check_vectors(vectors)
        out = np.asarray(ids, np.int32).reshape(-1)
        if len(out) != len(v):
            raise ValueError(f"{len(out)} ids for {len(v)} vectors")
        lsn, _ = self._write(OP_UPSERT, out, v, timeout_s)
        return lsn

    def delete(self, ids, timeout_s: Optional[float] = None) -> int:
        """Tombstone rows by id (unknown ids are a durable no-op, so replay
        stays idempotent). Returns the commit lsn."""
        out = np.asarray(ids, np.int32).reshape(-1)
        lsn, _ = self._write(OP_DELETE, out,
                             np.zeros((0, self.dim), np.float32), timeout_s)
        return lsn

    # -------------------------------------------------------------- search
    def _snapshot(self) -> _Cache:
        """The device copy of the current mirror version: host copies taken
        under the lock, the upload outside it."""
        with self._lock:
            m = self._mirror
            cache = self._cache
            if cache is not None and cache.version == m.version:
                return cache
            version = m.version
            base = self.base
            rows = m.rows.copy()
            ids = m.ids.copy()
            words = m.words.copy()
            masked = m.masked_base()
            n_base = len(m.base_ids)
        dev = self.device
        built = _Cache(version, base, _to_device(rows, dev),
                       _to_device(ids, dev),
                       _to_device(words.astype(np.int64), dev), len(ids),
                       masked, n_base)
        with self._lock:
            if self._mirror.version == version:
                self._cache = built
        return built

    def search(self, queries, k: int, params=None,
               res: Optional[Resources] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k over base and delta with the tombstone filter.

        The base is over-fetched by a power-of-two slack sized to the masked
        row count, folded through ``select_k_filtered`` (a deleted or
        superseded id never surfaces; counted as ``filtered_rows``), then
        merged with the delta scan by one ``select_k`` with the base
        candidates first, so ties break the same way on every call and
        across a crash and replay."""
        c = self._snapshot()
        dev = self.device
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=dev, dtype=torch.float32)
        else:
            q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
        if q.dim() == 1:
            q = q[None, :]
        q = q.contiguous()
        k = int(k)
        minimize = is_min_close(self.metric)
        sentinel = torch.inf if minimize else -torch.inf
        algo = SelectAlgo.PALLAS if k <= gk.MAX_K else SelectAlgo.AUTO
        parts_v: List[torch.Tensor] = []
        parts_i: List[torch.Tensor] = []
        if c.base is not None and c.base_rows > 0:
            k_base = min(k, c.base_rows)
            slack = 0
            if c.masked_base:
                slack = min(1 << (c.masked_base - 1).bit_length(), 1024)
            k_fetch = min(k_base + slack, c.base_rows)
            p = params if params is not None else self.search_params
            bv, bi = _family_mod(self.family).search(
                c.base, q, k_fetch, p, res=res if res is not None
                else self.res)
            bv, bi, n_filt = select_k_filtered(
                bv, k_base, bi, c.words, select_min=minimize,
                algo=algo if k_base <= gk.MAX_K else SelectAlgo.AUTO,
                pad_rules=False)
            self._m_filtered.inc(int(n_filt))
            parts_v.append(bv)
            parts_i.append(bi)
        if c.cap:
            dv = _delta_distances(q, c.rows, self.metric,
                                  self.res.workspace_limit_bytes)
            dv = torch.where((c.ids >= 0)[None, :], dv, sentinel)
            parts_v.append(dv)
            parts_i.append(c.ids[None, :].expand(q.shape[0], c.cap))
        if not parts_v:
            return (torch.full((q.shape[0], k), sentinel, dtype=torch.float32,
                               device=dev),
                    torch.full((q.shape[0], k), -1, dtype=torch.int32,
                               device=dev))
        all_v = torch.cat(parts_v, dim=1)
        all_i = torch.cat(parts_i, dim=1)
        k_sel = min(k, all_v.shape[1])
        v, i = select_k(all_v, k_sel, minimize, indices=all_i, algo=algo,
                        pad_rules=False)
        if k_sel < k:
            pad = k - k_sel
            v = torch.cat([v, v.new_full((q.shape[0], pad), sentinel)], dim=1)
            i = torch.cat([i, i.new_full((q.shape[0], pad), -1)], dim=1)
        return v, i

    # ----------------------------------------------------------- lifecycle
    @property
    def size(self) -> int:
        with self._lock:
            return self._mirror.live_count()

    @property
    def applied_lsn(self) -> int:
        with self._lock:
            return self._mirror.applied_lsn

    @property
    def wal_path(self) -> str:
        return os.path.join(self.directory, WAL_FILE)

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.directory, CKPT_FILE)

    def live_ids(self) -> np.ndarray:
        """The live ids, sorted (base rows not masked, plus the delta)."""
        with self._lock:
            live = self._mirror.live_ids()
        return np.fromiter(sorted(live), np.int64, len(live))

    def default_search_params(self):
        """The constructor's SearchParams, or the family's defaults: what
        ``mutable_ivf_searcher`` applies."""
        if self.search_params is not None:
            return self.search_params
        return _family_mod(self.family).SearchParams()

    def stats(self) -> dict:
        with self._lock:
            m = self._mirror
            return {
                "base_rows": len(m.base_ids),
                "delta_rows": m.delta_live(),
                "masked_base": m.masked_base(),
                "tombstone_live_ratio": m.tombstone_live_ratio(),
                "applied_lsn": m.applied_lsn,
                "live_rows": m.live_count(),
            }

    def checkpoint(self) -> str:
        """Persist the full state atomically and trim the WAL to the records
        the checkpoint does not cover. An old checkpoint with the untrimmed
        WAL and the new one with the trimmed WAL recover the same state."""
        with self._lock:
            m = self._mirror
            base = self.base
            valid = m.ids[: m.count] >= 0
            d_ids = m.ids[: m.count][valid].copy()
            d_lsns = m.lsns[: m.count][valid].copy()
            d_rows = m.rows[: m.count][valid].copy()
            tombs = np.fromiter(sorted(m.tombs), np.int32, len(m.tombs))
            applied = m.applied_lsn
            next_id = m.next_id
        base_blob = b""
        if base is not None:
            buf = io.BytesIO()
            _family_mod(self.family).serialize(base, buf)
            base_blob = buf.getvalue()
        path = self.checkpoint_path
        with ser.writer_for(path) as stream:
            w = ser.IndexWriter(stream, CKPT_KIND, CKPT_VERSION)
            w.string(self.family)
            w.string(self.metric.name)
            w.scalar(self.dim, "<i4")
            w.scalar(applied, "<i8")
            w.scalar(next_id, "<i8")
            w.scalar(1 if base is not None else 0, "<i4")
            w.array(d_ids)
            w.array(d_lsns)
            w.array(d_rows)
            w.array(tombs)
            if base is not None:
                w.blob(base_blob)
            w.finish()
        with self._lock:
            self._wal.trim_locked(applied)
        return path

    def sync(self) -> int:
        """Force the WAL durable now; returns the durable lsn."""
        return self._wal.sync()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._wal.close()

    # ---------------------------------------------------------- compaction
    def _compaction_snapshot(self) -> _CompactionSnapshot:
        """The compactor's build input, gathered under the lock (the rows of
        flat storage are read after it is released)."""
        with self._lock:
            m = self._mirror
            snap_lsn = m.applied_lsn
            keep_base = m.base_ids - m.tombs - set(m.slot_of)
            base_resident = m.base_ids
            valid = m.ids[: m.count] >= 0
            d_ids = m.ids[: m.count][valid].copy()
            d_rows = m.rows[: m.count][valid].copy()
            base = self.base
        full_rebuild = self.family == "ivf_flat" or base is None
        keep_delta: frozenset = frozenset()
        if not full_rebuild and len(d_ids):
            # extend does not dedupe ids: a delta id already in the base (an
            # upsert of a base row) stays in the delta instead
            keep_delta = frozenset(int(i) for i in d_ids
                                   if int(i) in base_resident)
            if keep_delta:
                sel = np.fromiter((int(i) not in keep_delta for i in d_ids),
                                  bool, len(d_ids))
                d_ids, d_rows = d_ids[sel], d_rows[sel]
        base_rows = np.zeros((0, self.dim), np.float32)
        base_ids = np.zeros((0,), np.int32)
        if full_rebuild and keep_base and base is not None:
            rows, ids = _index_rows(base)
            keep = np.fromiter(keep_base, np.int64, len(keep_base))
            sel = np.isin(ids, keep)
            base_rows, base_ids = rows[sel], ids[sel]
        vectors = np.concatenate([base_rows, d_rows], axis=0)
        ids = np.concatenate([base_ids, d_ids], axis=0).astype(np.int32)
        return _CompactionSnapshot(vectors, ids, snap_lsn, base,
                                   full_rebuild, len(base_ids), len(d_ids),
                                   keep_delta)

    def _install_base(self, new_base, snap: _CompactionSnapshot) -> None:
        """Swap in the compacted base and drop the delta slots it absorbed
        (lsn <= the snapshot's, but for ``keep_delta_ids``); later writes
        carry over and the base-ok bitset is rebuilt."""
        new_ids = (frozenset(_index_ids(new_base).tolist())
                   if new_base is not None else frozenset())
        with self._lock:
            m = self._mirror
            m.base_ids = new_ids
            survivors = [(int(m.ids[s]), m.rows[s].copy(), int(m.lsns[s]))
                         for s in range(m.count)
                         if m.ids[s] >= 0
                         and (m.lsns[s] > snap.lsn
                              or int(m.ids[s]) in snap.keep_delta_ids)]
            m.rows = np.zeros((0, self.dim), np.float32)
            m.ids = np.zeros((0,), np.int32)
            m.lsns = np.zeros((0,), np.int64)
            m.count = 0
            m.slot_of = {}
            m.tombs = {t for t in m.tombs if t in m.base_ids}
            for id_, row, lsn in survivors:
                m.put(id_, row, lsn)
            m.rebuild_words()
            m.version += 1
            self.base = new_base
            self._cache = None
        self._set_gauges()


def _family_mod(family: str):
    if family == "ivf_flat":
        from raft_tpu_torch.neighbors import ivf_flat
        return ivf_flat
    from raft_tpu_torch.neighbors import ivf_pq
    return ivf_pq


def _index_ids(index) -> np.ndarray:
    """Every live row id of a family index (lists and overflow)."""
    ids = index.list_indices.reshape(-1).cpu().numpy()
    out = [ids[ids >= 0]]
    over = index.overflow_indices.reshape(-1).cpu().numpy()
    if len(over):
        out.append(over[over >= 0])
    return np.concatenate(out).astype(np.int32)


def _index_rows(index) -> Tuple[np.ndarray, np.ndarray]:
    """(rows [n, dim] f32, ids [n]) of every live row of an ivf_flat index:
    the compaction's gather."""
    data = index.list_data.to(torch.float32)
    ids = index.list_indices.reshape(-1).cpu().numpy()
    rows = data.reshape(-1, data.shape[-1]).cpu().numpy()
    keep = ids >= 0
    rows, ids = rows[keep], ids[keep]
    over_ids = index.overflow_indices.reshape(-1).cpu().numpy()
    if len(over_ids):
        over_rows = index.overflow_data.to(torch.float32).reshape(
            -1, data.shape[-1]).cpu().numpy()
        ok = over_ids >= 0
        rows = np.concatenate([rows, over_rows[ok]], axis=0)
        ids = np.concatenate([ids, over_ids[ok]], axis=0)
    return rows, ids.astype(np.int32)


def _delta_distances(q: torch.Tensor, rows: torch.Tensor,
                     metric: DistanceType,
                     workspace_limit_bytes: int = 2 << 30) -> torch.Tensor:
    """Exact [n_q, cap] distances in the family's space (raw dots for
    InnerProduct, 1 − cos for Cosine, clamped squared L2 otherwise), a plain
    fp32 product a query chunk at a time: about three [chunk, cap] fp32
    temporaries fit the workspace."""
    qf = q.to(torch.float32)
    rf = rows.to(torch.float32)
    cap = rf.shape[0]
    chunk = max(1, int(workspace_limit_bytes) // max(cap * 4 * 3, 1))
    if metric == DistanceType.CosineExpanded:
        rn = torch.sqrt(torch.clamp_min((rf * rf).sum(-1), 1e-20))
    elif metric != DistanceType.InnerProduct:
        rn2 = (rf * rf).sum(-1)
    out = []
    for s in range(0, qf.shape[0], chunk):
        qt = qf[s:s + chunk]
        dots = dot_fp32(qt, rf)
        if metric == DistanceType.InnerProduct:
            d = dots
        elif metric == DistanceType.CosineExpanded:
            qn = torch.sqrt(torch.clamp_min((qt * qt).sum(-1), 1e-20))
            d = 1.0 - dots / (rn[None, :] * qn[:, None])
        else:
            qn2 = (qt * qt).sum(-1)
            d = torch.clamp_min(qn2[:, None] + rn2[None, :] - 2.0 * dots, 0.0)
            if metric == DistanceType.L2SqrtExpanded:
                d = torch.sqrt(d)
        out.append(d)
    return out[0] if len(out) == 1 else torch.cat(out)


# ================================================================ Compactor


class Compactor:
    """Background re-cluster and hot-swap publisher for one writer.

    Wakes on a poll cadence and runs when a closed-vocabulary trigger fires
    (``delta_threshold`` live delta rows, ``tombstone_ratio`` of masked base
    rows, ``interval`` seconds since the last run, or :meth:`request`,
    ``manual``). Each run emits one ``kind="compaction"`` span and one
    ``raft_tpu_mutable_compactions_total{reason,outcome}`` increment.
    ``publish`` is the hot-swap target: an ``Engine`` (``swap_index``), a
    target with ``rolling_swap`` and ``replicas``, or None. A run past
    ``stall_timeout_s`` counts a stall, emits ``kind="compaction_stall"``
    and trips the target's ``dump_diagnostics``; the run goes on."""

    def __init__(self, writer: MutableIvf, *, publish=None,
                 delta_threshold: int = 4096,
                 tombstone_ratio: float = 0.25,
                 interval_s: Optional[float] = None,
                 stall_timeout_s: float = 30.0,
                 poll_s: float = 0.05,
                 min_rows: int = 2,
                 clock=time.monotonic):
        self.writer = writer
        self.publish = publish
        self.delta_threshold = int(delta_threshold)
        self.tombstone_ratio = float(tombstone_ratio)
        self.interval_s = interval_s
        self.stall_timeout_s = float(stall_timeout_s)
        self.poll_s = float(poll_s)
        self.min_rows = int(min_rows)
        self.clock = clock
        self._wake = threading.Condition()
        self._pending: Optional[str] = None  # guarded_by: _wake
        self._running = False  # guarded_by: _wake
        self._runs = 0  # guarded_by: _wake
        self._thread: Optional[threading.Thread] = None  # guarded_by: atomic
        self._stall_timer: Optional[threading.Timer] = None  # guarded_by: _wake
        self._last_run_t = clock()  # guarded_by: atomic (loop-only rebind)
        self.last_error: Optional[BaseException] = None  # guarded_by: atomic
        #: fault hook (testing.faults.crash_compactor)
        self._crash_after_checkpoint = False
        writer.compactor = self

    def start(self) -> "Compactor":
        with self._wake:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name=f"compactor:{self.writer.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        with self._wake:
            self._running = False
            if self._stall_timer is not None:
                self._stall_timer.cancel()
                self._stall_timer = None
            self._wake.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)

    def request(self, reason: str = "manual") -> None:
        """Queue a run for ``reason`` (closed vocabulary)."""
        if reason not in COMPACTION_REASONS:
            raise ValueError(f"unknown compaction reason {reason!r}; "
                             f"expected one of {sorted(COMPACTION_REASONS)}")
        with self._wake:
            self._pending = reason
            self._wake.notify_all()

    @property
    def runs(self) -> int:
        with self._wake:
            return self._runs

    def _loop(self) -> None:
        while True:
            with self._wake:
                while self._running and self._pending is None:
                    if not self._wake.wait(timeout=self.poll_s):
                        break  # poll tick: evaluate the automatic triggers
                if not self._running:
                    return
                reason = self._pending
                self._pending = None
            if reason is None:
                reason = self._auto_reason()
            if reason is not None:
                self.run_once(reason)

    def _auto_reason(self) -> Optional[str]:
        stats = self.writer.stats()
        if stats["delta_rows"] >= self.delta_threshold:
            return "delta_threshold"
        if stats["base_rows"] and \
                stats["tombstone_live_ratio"] >= self.tombstone_ratio:
            return "tombstone_ratio"
        if self.interval_s is not None and \
                self.clock() - self._last_run_t >= self.interval_s:
            return "interval"
        return None

    def run_once(self, reason: str = "manual") -> str:
        """One compaction: snapshot → build → install → checkpoint →
        publish. Returns the outcome (closed vocabulary); failures are
        typed, counted and kept on ``last_error``, never raised."""
        if reason not in COMPACTION_REASONS:
            raise ValueError(f"unknown compaction reason {reason!r}; "
                             f"expected one of {sorted(COMPACTION_REASONS)}")
        writer = self.writer
        t0 = self.clock()
        timer = threading.Timer(self.stall_timeout_s, self._on_stall,
                                args=(reason,))
        timer.daemon = True
        with self._wake:
            self._stall_timer = timer
        timer.start()
        outcome = "failed"
        detail = ""
        gen = None
        try:
            snap = writer._compaction_snapshot()
            if len(snap.ids) < self.min_rows:
                outcome = "skipped"
                detail = f"{len(snap.ids)} live rows < min_rows"
                return outcome
            new_base = self._build(snap)
            writer._install_base(new_base, snap)
            writer.checkpoint()
            if self._crash_after_checkpoint:
                raise CompactorCrashed(
                    f"{writer.name}: injected crash between artifact "
                    f"write and publish")
            gen = self._publish()
            outcome = "ok"
            detail = (f"{snap.n_base} base + {snap.n_delta} delta rows "
                      f"-> {len(snap.ids)} live")
            return outcome
        except CompactorCrashed as e:
            self.last_error = e
            detail = str(e)
            return outcome
        except (RaftError, ValueError, OSError) as e:
            self.last_error = e
            detail = f"{type(e).__name__}: {e}"
            return outcome
        finally:
            with self._wake:
                if self._stall_timer is timer:
                    self._stall_timer = None
                self._runs += 1
            timer.cancel()
            self._last_run_t = self.clock()
            dur = self.clock() - t0
            writer._m_compactions.labels(writer.name, reason, outcome).inc()
            span = {
                "kind": "compaction", "index": writer.name,
                "trace": obs_spans.new_trace_id(), "reason": reason,
                "outcome": outcome, "duration_s": round(dur, 6),
                "detail": detail,
            }
            if gen is not None:
                span["searcher_gen"] = gen
            obs_spans.safe_emit(writer.span_sink, span)

    def _build(self, snap: _CompactionSnapshot):
        """The compacted base. A full rebuild (ivf_flat, or no base yet)
        re-clusters every live row with its id (``build`` without data, then
        ``extend``) on the writer's device. ivf_pq with a base encodes the
        new delta rows into it by ``extend``; tombstoned base rows stay and
        stay filtered."""
        mod = _family_mod(self.writer.family)
        res = self.writer.res
        if not snap.full_rebuild:
            if len(snap.ids) == 0:
                return snap.base  # every delta row superseded a base id
            return mod.extend(snap.base, snap.vectors,
                              new_indices=snap.ids, res=res)
        params = self.writer.index_params
        if params is None:
            params = mod.IndexParams()
        n_lists = max(1, min(int(params.n_lists), len(snap.ids)))
        # the writer's metric is pinned: a reopened writer has no params
        params = dataclasses.replace(params, n_lists=n_lists,
                                     metric=self.writer.metric,
                                     add_data_on_build=False)
        base = mod.build(snap.vectors, params, res=res)
        return mod.extend(base, snap.vectors, new_indices=snap.ids, res=res)

    def _publish(self):
        """A fresh searcher through ``Engine.swap_index`` (or a
        ``rolling_swap`` target); returns the post-swap generation (a list
        per replica for a rolling target, None without a target)."""
        target = self.publish
        if target is None:
            return None
        from raft_tpu_torch.serving import searchers as serving_searchers

        def handle():
            return serving_searchers.make_searcher(
                "mutable_ivf", self.writer,
                params=self.writer.search_params, res=self.writer.res)

        if hasattr(target, "rolling_swap"):
            target.rolling_swap([handle() for _ in target.replicas])
            return [int(r.engine.searcher_generation)
                    for r in target.replicas
                    if hasattr(getattr(r, "engine", None),
                               "searcher_generation")]
        target.swap_index(handle())
        return int(target.searcher_generation)

    def _on_stall(self, reason: str) -> None:
        """Stall timer: count, span, and trip the target's flight recorder
        (on the timer thread, no lock held)."""
        writer = self.writer
        writer._m_stalls.inc()
        obs_spans.safe_emit(writer.span_sink, {
            "kind": "compaction_stall", "index": writer.name,
            "reason": reason, "stall_timeout_s": self.stall_timeout_s,
        })
        target = self.publish
        engines = []
        if target is not None and hasattr(target, "dump_diagnostics"):
            engines = [target]
        elif target is not None and hasattr(target, "replicas"):
            engines = [r.engine for r in target.replicas
                       if hasattr(getattr(r, "engine", None),
                                  "dump_diagnostics")]
        for eng in engines:
            try:
                eng.dump_diagnostics(reason="compaction_stall")
            except (RaftError, OSError, ValueError) as e:
                self.last_error = e


# ============================================================== verification


def verify_dir(directory) -> dict:
    """Classify a MutableIvf directory: the checkpoint's status, the WAL's
    (ok / torn_tail / corrupt / missing) and the lsn range a recovery would
    replay onto the checkpoint."""
    directory = str(directory)
    ckpt_path = os.path.join(directory, CKPT_FILE)
    wal_path = os.path.join(directory, WAL_FILE)
    ckpt: dict = {"path": ckpt_path, "status": "ok", "applied_lsn": None}
    if not os.path.exists(ckpt_path):
        ckpt["status"] = "missing"
    else:
        try:
            with ser.reader_for(ckpt_path) as stream:
                r = ser.IndexReader(stream, CKPT_KIND, CKPT_VERSION,
                                    name=ckpt_path)
                r.string()  # family
                r.string()  # metric
                r.scalar()  # dim
                ckpt["applied_lsn"] = int(r.scalar())
                r.scalar()  # next_id
                has_base = int(r.scalar())
                for _ in range(4):  # delta ids/lsns/rows + tombstones
                    r.array()
                if has_base:
                    r.blob()
                r.finish()
        except IntegrityError as e:
            ckpt["status"] = e.reason or "corrupt"
            ckpt["error"] = str(e)
        except ValueError as e:
            ckpt["status"] = "corrupt"
            ckpt["error"] = str(e)
    scan = read_wal(wal_path)
    wal = verify_wal(wal_path)
    applied = ckpt.get("applied_lsn")
    replay = [r for r in scan.records
              if applied is None or r.lsn > applied] \
        if wal["status"] in ("ok", "torn_tail") else []
    replay_range = None
    if replay:
        replay_range = {"first_lsn": replay[0].lsn,
                        "last_lsn": replay[-1].lsn,
                        "records": len(replay)}
    # a missing checkpoint is healthy when the WAL stands alone; both
    # missing means the directory is not a mutable index's home
    ckpt_ok = ckpt["status"] == "ok" or (
        ckpt["status"] == "missing" and wal["status"] != "missing")
    if ckpt_ok and wal["status"] in ("ok", "missing"):
        status = "ok"
    elif ckpt_ok and wal["status"] == "torn_tail":
        status = "torn_tail"
    elif ckpt["status"] == "missing" and wal["status"] == "missing":
        status = "missing"
    else:
        status = "corrupt"
    return {
        "directory": directory,
        "status": status,
        "checkpoint": ckpt,
        "wal": wal,
        "replay": replay_range,
    }
