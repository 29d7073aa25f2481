"""Array and index (de)serialization, numpy-``.npy`` compatible.

Counterpart of ``raft_tpu.core.serialize``, byte for byte: a file written
by either package reads in the other. Arrays travel in numpy's ``.npy``
format (tensors through ``.detach().cpu().numpy()``; a bfloat16 tensor as
the two-byte records ``np.save`` gives a bfloat16 array), scalars as tagged
little-endian values, and an index file is a magic + named-version header
followed by an ordered sequence of scalars and arrays
(``IndexWriter``/``IndexReader``).

Integrity (container format v2): every record is framed
``[u64 payload_len][payload][u32 crc32]`` and the writer's ``finish()``
appends a length-prefixed footer carrying the record count and total payload
bytes. The reader verifies each record's crc as it is consumed and
``finish()`` verifies the footer, so a restore can tell apart

- **missing** — the file is not there at all (``FileNotFoundError`` /
  manifest check),
- **truncated** — the stream ends mid-record or before the footer, and
- **corrupt** — a record's bytes do not match its crc,

each raised as a typed :class:`~raft_tpu_torch.core.errors.IntegrityError`
naming the file and the record. v1 files (unframed, no footer) are still
readable: the header's format version selects the decode path.

``writer_for(path)`` makes file writes atomic (tmp + ``os.replace``): a
crash mid-serialize leaves the previous checkpoint intact instead of a
half-written file that only fails at the next restore.
"""

from __future__ import annotations

import contextlib
import io
import os
import struct
import zlib
from typing import BinaryIO, List, Optional, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core.errors import IntegrityError

_MAGIC = b"RAFT_TPU_IDX"
# v2: per-record [u64 len][payload][u32 crc32] framing + footer
_SERIALIZATION_VERSION = 2
_FOOTER_MAGIC = b"RTFT"
_FRAME_LEN = struct.Struct("<Q")
_FRAME_CRC = struct.Struct("<I")
#: public aliases for append-only consumers (the mutable-index WAL)
#: that parse frames themselves to classify damage by file position.
FRAME_LEN = _FRAME_LEN
FRAME_CRC = _FRAME_CRC

ArrayLike = Union[np.ndarray, torch.Tensor]

#: how ``np.save`` records a bfloat16 array (ml_dtypes' bfloat16, which
#: the JAX package writes; numpy has no bfloat16 of its own): an opaque
#: two-byte record an element. Read back, its dtype is ``V2``.
_BF16_DESCR = "<V2"
_BF16_NPY = np.dtype("V2")


def _to_numpy(a: ArrayLike) -> np.ndarray:
    """A C-contiguous host array of ``a`` (a bfloat16 tensor: its int16
    bits)."""
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a)
    t = a.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A tensor on ``device`` from an array read back from a file; the
    two-byte records of a bfloat16 array become bfloat16 again."""
    a = np.ascontiguousarray(a)
    if a.dtype == _BF16_NPY:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def serialize_array(stream: BinaryIO, a: ArrayLike) -> None:
    """Write one array or tensor in .npy format (the JAX package's and the
    reference's serialize_mdspan wire format); a bfloat16 tensor with the
    header ``np.save`` gives a bfloat16 array."""
    if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
        bits = _to_numpy(a)
        np.lib.format.write_array_header_1_0(
            stream, {"descr": _BF16_DESCR, "fortran_order": False,
                     "shape": bits.shape})
        stream.write(bits.tobytes())
        return
    np.save(stream, _to_numpy(a), allow_pickle=False)


def deserialize_array(stream: BinaryIO) -> np.ndarray:
    return np.load(stream, allow_pickle=False)


def serialize_scalar(stream: BinaryIO, value, dtype: str) -> None:
    """Write a tagged little-endian scalar (dtype in numpy str form)."""
    dt = np.dtype(dtype).newbyteorder("<")
    tag = dt.str.encode()
    stream.write(struct.pack("<B", len(tag)))
    stream.write(tag)
    stream.write(np.asarray(value, dtype=dt).tobytes())


def deserialize_scalar(stream: BinaryIO):
    head = stream.read(1)
    if len(head) < 1:
        raise IntegrityError("scalar truncated: no dtype-tag length byte",
                             reason="truncated")
    (tag_len,) = struct.unpack("<B", head)
    tag = stream.read(tag_len)
    if len(tag) < tag_len:
        raise IntegrityError("scalar truncated mid dtype tag",
                             reason="truncated")
    try:
        dt = np.dtype(tag.decode())
    except (TypeError, ValueError, UnicodeDecodeError) as e:
        raise IntegrityError(
            f"bad scalar dtype tag {tag!r}: not a numpy dtype "
            f"(corrupt stream?)", reason="corrupt") from e
    raw = stream.read(dt.itemsize)
    if len(raw) < dt.itemsize:
        raise IntegrityError(
            f"scalar truncated: {len(raw)} of {dt.itemsize} value bytes",
            reason="truncated")
    return np.frombuffer(raw, dtype=dt)[0].item()


# ------------------------------------------------------------ file helpers


def _is_pathlike(file_or_stream) -> bool:
    return (isinstance(file_or_stream, (str, bytes))
            or hasattr(file_or_stream, "__fspath__"))


def open_for(file_or_stream, mode: str):
    """Return (stream, should_close) for a path or an already-open stream."""
    if _is_pathlike(file_or_stream):
        return open(file_or_stream, mode), True
    return file_or_stream, False


@contextlib.contextmanager
def writer_for(file_or_stream):
    """Binary-write context for a path or stream. Paths are written
    ATOMICALLY: bytes go to ``<path>.tmp.<pid>`` and ``os.replace`` installs
    them only after the body (including any ``IndexWriter.finish()``)
    succeeded — a crash mid-serialize can truncate only the tmp file, never
    an existing checkpoint. Streams pass through unchanged (caller owns
    their lifetime)."""
    if not _is_pathlike(file_or_stream):
        yield file_or_stream
        return
    path = os.fsdecode(file_or_stream if not hasattr(
        file_or_stream, "__fspath__") else os.fspath(file_or_stream))
    tmp = f"{path}.tmp.{os.getpid()}"
    stream = open(tmp, "wb")
    try:
        yield stream
        stream.flush()
        os.fsync(stream.fileno())
        stream.close()
        os.replace(tmp, path)
    except BaseException:
        stream.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


@contextlib.contextmanager
def reader_for(file_or_stream):
    """Binary-read context symmetric with :func:`writer_for`."""
    stream, close = open_for(file_or_stream, "rb")
    try:
        yield stream
    finally:
        if close:
            stream.close()


def frame(payload: bytes) -> bytes:
    """One v2 record frame (``[u64 len][payload][u32 crc32]``) as raw
    bytes — for append-only files (the mutable-index WAL) that write
    frames past a :func:`header_bytes` header with no footer."""
    return _FRAME_LEN.pack(len(payload)) + payload \
        + _FRAME_CRC.pack(zlib.crc32(payload))


def header_bytes(kind: str, version: int) -> bytes:
    """The v2 container header (magic + format version + kind +
    version) as raw bytes. Files headed this way are recognized by
    :func:`record_spans` and the byte-level fault injectors even when
    they frame their own records (the mutable-index WAL)."""
    buf = io.BytesIO()
    IndexWriter(buf, kind, version)
    return buf.getvalue()


def _stream_name(stream, name: Optional[str]) -> str:
    if name is not None:
        return name
    got = getattr(stream, "name", None)
    return got if isinstance(got, str) else "<stream>"


class IndexWriter:
    """Header + ordered payload writer used by every index's serialize().

    Format v2 frames each record with a length prefix and crc32; call
    :meth:`finish` after the last record to append the footer (readers use
    it to tell a complete file from one truncated at a record boundary).
    """

    def __init__(self, stream: BinaryIO, kind: str, version: int):
        self.stream = stream
        stream.write(_MAGIC)
        stream.write(struct.pack("<I", _SERIALIZATION_VERSION))
        kind_b = kind.encode()
        stream.write(struct.pack("<I", len(kind_b)))
        stream.write(kind_b)
        stream.write(struct.pack("<I", version))
        self._n_records = 0
        self._payload_bytes = 0

    def _record(self, payload: bytes) -> None:
        self.stream.write(_FRAME_LEN.pack(len(payload)))
        self.stream.write(payload)
        self.stream.write(_FRAME_CRC.pack(zlib.crc32(payload)))
        self._n_records += 1
        self._payload_bytes += len(payload)

    def scalar(self, value, dtype: str) -> "IndexWriter":
        buf = io.BytesIO()
        serialize_scalar(buf, value, dtype)
        self._record(buf.getvalue())
        return self

    def string(self, s: str) -> "IndexWriter":
        self._record(s.encode())
        return self

    def array(self, a: ArrayLike) -> "IndexWriter":
        buf = io.BytesIO()
        serialize_array(buf, a)
        self._record(buf.getvalue())
        return self

    def blob(self, b: bytes) -> "IndexWriter":
        """One opaque byte record — e.g. a whole nested index file
        (the mutable-index checkpoint embeds its base's serialization
        as a single crc-framed record)."""
        self._record(bytes(b))
        return self

    def finish(self) -> "IndexWriter":
        """Append the length-prefixed footer (record count + payload bytes).
        A file without it reads as truncated under ``IndexReader.finish``."""
        payload = _FOOTER_MAGIC + struct.pack(
            "<IQ", self._n_records, self._payload_bytes)
        self.stream.write(_FRAME_LEN.pack(len(payload)))
        self.stream.write(payload)
        self.stream.write(_FRAME_CRC.pack(zlib.crc32(payload)))
        return self


class IndexReader:
    def __init__(self, stream: BinaryIO, kind: str, max_version: int,
                 name: Optional[str] = None):
        self.stream = stream
        self.name = _stream_name(stream, name)
        magic = stream.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(
                f"{self.name}: bad magic {magic!r}: not a raft_tpu index "
                f"file")
        (fmt_ver,) = struct.unpack("<I", stream.read(4))
        if fmt_ver > _SERIALIZATION_VERSION:
            raise ValueError(
                f"{self.name}: serialization format v{fmt_ver} is newer "
                f"than supported")
        self.fmt_version = fmt_ver
        (kind_len,) = struct.unpack("<I", stream.read(4))
        found = stream.read(kind_len).decode()
        if found != kind:
            raise ValueError(
                f"{self.name}: index kind mismatch: file has {found!r}, "
                f"expected {kind!r}")
        (self.version,) = struct.unpack("<I", stream.read(4))
        if self.version > max_version:
            raise ValueError(
                f"{self.name}: {kind} index version {self.version} is newer "
                f"than supported {max_version}"
            )
        self._n_records = 0
        self._payload_bytes = 0

    # ----------------------------------------------------------- v2 frames
    def _truncated(self, detail: str) -> IntegrityError:
        return IntegrityError(
            f"{self.name}: record {self._n_records}: truncated ({detail})",
            path=self.name, record=self._n_records, reason="truncated")

    def _next_record(self) -> bytes:
        hdr = self.stream.read(_FRAME_LEN.size)
        if len(hdr) < _FRAME_LEN.size:
            raise self._truncated(
                "stream ends before the record's length prefix — file cut "
                "at a record boundary, or footer missing")
        (n,) = _FRAME_LEN.unpack(hdr)
        payload = self.stream.read(n)
        if len(payload) < n:
            raise self._truncated(
                f"{len(payload)} of {n} payload bytes present")
        crc_raw = self.stream.read(_FRAME_CRC.size)
        if len(crc_raw) < _FRAME_CRC.size:
            raise self._truncated("stream ends inside the record's crc")
        (crc,) = _FRAME_CRC.unpack(crc_raw)
        if zlib.crc32(payload) != crc:
            raise IntegrityError(
                f"{self.name}: record {self._n_records}: crc32 mismatch "
                f"(corrupt payload, {n} bytes)",
                path=self.name, record=self._n_records, reason="corrupt")
        self._n_records += 1
        self._payload_bytes += n
        return payload

    # -------------------------------------------------------------- records
    def scalar(self):
        if self.fmt_version < 2:
            return deserialize_scalar(self.stream)
        try:
            return deserialize_scalar(io.BytesIO(self._next_record()))
        except IntegrityError as e:
            if e.path is None:  # scalar-level fault inside a valid frame
                raise IntegrityError(
                    f"{self.name}: record {self._n_records - 1}: {e}",
                    path=self.name, record=self._n_records - 1,
                    reason=e.reason) from e
            raise

    def string(self) -> str:
        if self.fmt_version < 2:
            (n,) = struct.unpack("<I", self.stream.read(4))
            return self.stream.read(n).decode()
        return self._next_record().decode()

    def array(self) -> np.ndarray:
        if self.fmt_version < 2:
            return deserialize_array(self.stream)
        payload = self._next_record()
        try:
            return np.load(io.BytesIO(payload), allow_pickle=False)
        except ValueError as e:
            raise IntegrityError(
                f"{self.name}: record {self._n_records - 1}: npy payload "
                f"failed to parse despite matching crc: {e}",
                path=self.name, record=self._n_records - 1,
                reason="corrupt") from e

    def blob(self) -> bytes:
        """One opaque byte record (see :meth:`IndexWriter.blob`). v2
        only — v1 files carry no self-describing record boundaries."""
        if self.fmt_version < 2:
            raise ValueError(
                f"{self.name}: blob records need v2 framing; this file "
                f"is format v{self.fmt_version}")
        return self._next_record()

    def finish(self) -> None:
        """Verify the footer (v2 files): record count and payload bytes must
        match what was read. No-op for v1 files (they carry no footer)."""
        if self.fmt_version < 2:
            return
        n_read, bytes_read = self._n_records, self._payload_bytes
        payload = self._next_record()
        self._n_records, self._payload_bytes = n_read, bytes_read
        if (len(payload) != len(_FOOTER_MAGIC) + 12
                or payload[:len(_FOOTER_MAGIC)] != _FOOTER_MAGIC):
            raise IntegrityError(
                f"{self.name}: footer record is malformed (extra records "
                f"after the expected field set?)",
                path=self.name, record=n_read, reason="corrupt")
        n_records, payload_bytes = struct.unpack(
            "<IQ", payload[len(_FOOTER_MAGIC):])
        if n_records != n_read or payload_bytes != bytes_read:
            raise IntegrityError(
                f"{self.name}: footer declares {n_records} records / "
                f"{payload_bytes} payload bytes but {n_read} / {bytes_read} "
                f"were read — reader/writer field-set mismatch",
                path=self.name, record=n_read, reason="corrupt")


def record_spans(path) -> List[Tuple[int, int]]:
    """[(payload_offset, payload_len)] of every framed record in a v2 index
    file, footer included as the last entry. The fault-injection harness
    uses this to flip or truncate a specific record; raises ValueError for
    v1 (unframed) files whose record boundaries are not self-describing."""
    spans: List[Tuple[int, int]] = []
    with open(path, "rb") as stream:
        magic = stream.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a raft_tpu index file")
        (fmt_ver,) = struct.unpack("<I", stream.read(4))
        if fmt_ver < 2:
            raise ValueError(
                f"{path}: format v{fmt_ver} records are unframed; spans are "
                f"only recoverable for v2+ files")
        (kind_len,) = struct.unpack("<I", stream.read(4))
        stream.read(kind_len)
        stream.read(4)  # kind version
        while True:
            hdr = stream.read(_FRAME_LEN.size)
            if not hdr:
                return spans
            if len(hdr) < _FRAME_LEN.size:
                return spans  # trailing garbage / truncation: stop cleanly
            (n,) = _FRAME_LEN.unpack(hdr)
            off = stream.tell()
            spans.append((off, n))
            stream.seek(n + _FRAME_CRC.size, os.SEEK_CUR)
            if stream.tell() > os.fstat(stream.fileno()).st_size:
                return spans


def file_crc32(path, chunk: int = 1 << 20) -> int:
    """Whole-file crc32 (the manifest digest)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)
