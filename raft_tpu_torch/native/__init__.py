"""Native C++ host runtime (counterpart of ``raft_tpu.native``).

The mmap'd fbin/ibin/u8bin dataset reader and writer, with a prefetching
batch reader; the CAGRA → hnswlib serializer; hnswlib's layer-0 ef-search
on the CPU; the agglomerative union-find labelling; and the IVF list fill.
The C++ source is a copy of the JAX package's (``src/raft_tpu_native.cpp``);
this module builds its own library from it with ``g++`` on first use, into
``build/raft_tpu_torch/native/`` at the repository root (keyed by a hash of
the source), never beside the package, and binds it with ``ctypes``. Every
entry point has the JAX package's numpy fallback, which runs when the
library cannot be built; ``CALLS`` counts the calls the library served.
These are host pieces, off the card's path."""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "raft_tpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raft_tpu_torch" \
    / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

#: calls that ran in the C++ library, by entry point (the numpy fallbacks
#: are not counted)
CALLS: collections.Counter = collections.Counter()

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


@functools.lru_cache(maxsize=1)
def _compiler_id() -> str:
    """The machine and ``g++ --version``'s first line ("" without g++)."""
    try:
        out = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    return f"{platform.machine()} {out.splitlines()[0] if out else ''}"


def library_path() -> Path:
    """Where the library is built: a hash of the source, the flags, the
    machine and the compiler, so that a library built elsewhere is never
    loaded."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_compiler_id().encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libraft_tpu_native-{h.hexdigest()[:16]}.so"


def ensure_built() -> bool:
    """Compile the library with ``g++`` into ``BUILD_DIR`` unless it is
    there (written to a temporary name, then moved into place, so that
    processes building at once never load a half-written file); returns
    whether it is available. A failed build is not retried in this
    process, and the numpy fallbacks take over."""
    global _build_failed
    path = library_path()
    if path.exists():
        return True
    if _build_failed:
        return False
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        _build_failed = True
        if tmp.exists():
            tmp.unlink()
        return path.exists()


def _get_lib():
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not ensure_built():
            return None
        try:
            lib = ctypes.CDLL(str(library_path()))
        except OSError:
            # a foreign-arch artifact: the numpy fallbacks take over
            _build_failed = True
            return None
        lib.bin_read_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.bin_read_header.restype = ctypes.c_int
        lib.bin_read_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.bin_read_rows.restype = ctypes.c_int
        lib.bin_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64]
        lib.bin_write.restype = ctypes.c_int
        lib.hnswlib_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64]
        lib.hnswlib_write.restype = ctypes.c_int
        lib.agglomerative_label.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        lib.agglomerative_label.restype = ctypes.c_int
        lib.pack_lists.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.pack_lists.restype = ctypes.c_int
        lib.prefetch_open_v2.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.prefetch_open_v2.restype = ctypes.c_void_p
        lib.prefetch_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.prefetch_next.restype = ctypes.c_int64
        lib.prefetch_close.argtypes = [ctypes.c_void_p]
        lib.prefetch_close.restype = None
        lib.graph_greedy_search.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.graph_greedy_search.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


# ------------------------------------------------------------------- bin IO


_DTYPES = {"fbin": np.float32, "ibin": np.int32, "u8bin": np.uint8}


def _dtype_for(path: str, dtype=None):
    if dtype is not None:
        return np.dtype(dtype)
    ext = path.rsplit(".", 1)[-1]
    if ext in _DTYPES:
        return np.dtype(_DTYPES[ext])
    return np.dtype(np.float32)


def read_bin_header(path: str) -> Tuple[int, int]:
    """(n_rows, dim) of an fbin/ibin/u8bin file."""
    lib = _get_lib()
    if lib is not None:
        n = ctypes.c_int64()
        d = ctypes.c_int64()
        rc = lib.bin_read_header(path.encode(), ctypes.byref(n),
                                 ctypes.byref(d))
        CALLS["bin_read_header"] += 1
        if rc != 0:
            raise IOError(f"bin_read_header({path}) failed rc={rc}")
        return n.value, d.value
    with open(path, "rb") as f:
        hdr = np.fromfile(f, np.int32, 2)
    return int(hdr[0]), int(hdr[1])


def read_bin(path: str, row_start: int = 0, n_rows: Optional[int] = None,
             dtype=None) -> np.ndarray:
    """Read a row range of an ANN-benchmark bin file (header int32 n, dim).
    The C path uses pread (thread-safe, no Python buffering); out-of-core
    pipelines stream batches through this."""
    total, dim = read_bin_header(path)
    dt = _dtype_for(path, dtype)
    if n_rows is None:
        n_rows = total - row_start
    n_rows = max(min(n_rows, total - row_start), 0)
    out = np.empty((n_rows, dim), dt)
    lib = _get_lib()
    if lib is not None and n_rows:
        rc = lib.bin_read_rows(path.encode(), row_start, n_rows, dt.itemsize,
                               out.ctypes.data_as(ctypes.c_void_p))
        CALLS["bin_read_rows"] += 1
        if rc != 0:
            raise IOError(f"bin_read_rows({path}) failed rc={rc}")
        return out
    with open(path, "rb") as f:
        f.seek(8 + row_start * dim * dt.itemsize)
        out = np.fromfile(f, dt, n_rows * dim).reshape(n_rows, dim)
    return out


def write_bin(path: str, data: np.ndarray) -> None:
    data = np.ascontiguousarray(data)
    lib = _get_lib()
    if lib is not None:
        rc = lib.bin_write(path.encode(),
                           data.ctypes.data_as(ctypes.c_void_p),
                           data.shape[0], data.shape[1], data.itemsize)
        CALLS["bin_write"] += 1
        if rc != 0:
            raise IOError(f"bin_write({path}) failed rc={rc}")
        return
    with open(path, "wb") as f:
        np.asarray(data.shape, np.int32).tofile(f)
        data.tofile(f)


def iter_bin_batches(path: str, batch_rows: int, dtype=None):
    """Stream a bin file in row batches (the host-to-device staging loop)."""
    total, _ = read_bin_header(path)
    for s in range(0, total, batch_rows):
        yield s, read_bin(path, s, min(batch_rows, total - s), dtype)


def iter_bin_batches_prefetch(path: str, batch_rows: int, dtype=None,
                              row_range=None):
    """Like :func:`iter_bin_batches` but IO-overlapped: a native reader
    thread preads batch i+1 while the consumer processes batch i (the
    reference bench harness's mmap+thread-pool staging role). Falls back to
    the synchronous iterator when the native library is unavailable.
    ``row_range=(lo, hi)`` streams only that row span (shard builds);
    yielded offsets are file-absolute."""
    lib = _get_lib()
    dt = _dtype_for(path, dtype)
    total, dim = read_bin_header(path)
    lo, hi = (0, total) if row_range is None else row_range
    lo = int(lo)
    hi = int(max(lo, min(hi, total)))  # empty range behaves like the sync path
    if lib is None:
        for s in range(lo, hi, batch_rows):
            yield s, read_bin(path, s, min(batch_rows, hi - s), dt)
        return
    handle = lib.prefetch_open_v2(path.encode(), batch_rows, dt.itemsize,
                                  lo, hi - lo)
    CALLS["prefetch_open_v2"] += 1 if handle else 0
    if not handle:
        for s in range(lo, hi, batch_rows):
            yield s, read_bin(path, s, min(batch_rows, hi - s), dt)
        return
    try:
        start = lo
        while True:
            buf = np.empty((batch_rows, dim), dt)
            rows = lib.prefetch_next(
                handle, buf.ctypes.data_as(ctypes.c_void_p))
            if rows == 0:
                break
            if rows < 0:
                raise IOError(f"prefetch_next({path}) failed rc={rows}")
            yield start, buf[:rows]
            start += rows
    finally:
        lib.prefetch_close(handle)


# -------------------------------------------------------------- hnsw export


def hnswlib_write(path: str, dataset: np.ndarray, graph: np.ndarray,
                  space: str = "l2", compat: str = "hnswlib") -> None:
    """Write a base-layer-only hnswlib index file: header in saveIndex
    order, per-element level-0 block [link_count u32][maxM0 u32 links]
    [dim f32][label u64], zero upper-level link lists.

    ``compat="hnswlib"`` (default) emits max_level=0/enterpoint=0 — safe
    for stock hnswlib's loadIndex **and** search (no upper-layer descent).
    ``compat="raft"`` reproduces the reference serializer byte-for-byte
    (cagra_serialize.cuh:113-154; the base_layer_only loader contract of
    hnsw_types.hpp:60-86) — stock hnswlib would crash *searching* that
    variant, exactly as it does on the reference's own output."""
    dataset = np.ascontiguousarray(dataset, np.float32)
    graph = np.ascontiguousarray(graph, np.int32)
    n, dim = dataset.shape
    if graph.shape[0] != n:
        raise ValueError("graph rows must match dataset rows")
    degree = graph.shape[1]
    sp = {"l2": 0, "ip": 1}[space]
    rc_compat = {"hnswlib": 0, "raft": 1}[compat]
    lib = _get_lib()
    if lib is not None:
        rc = lib.hnswlib_write(path.encode(),
                               dataset.ctypes.data_as(ctypes.c_void_p),
                               graph.ctypes.data_as(ctypes.c_void_p),
                               n, dim, degree, sp, rc_compat)
        CALLS["hnswlib_write"] += 1
        if rc != 0:
            raise IOError(f"hnswlib_write({path}) failed rc={rc}")
        return
    _hnswlib_write_py(path, dataset, graph, compat)


def _hnswlib_write_py(path: str, dataset: np.ndarray, graph: np.ndarray,
                      compat: str = "hnswlib") -> None:
    import struct

    n, dim = dataset.shape
    degree = graph.shape[1]
    size_links0 = degree * 4 + 4
    data_size = dim * 4
    size_per_elem = size_links0 + data_size + 8
    m = max(degree // 2, 1)
    # header constants must stay identical to the C++ writer (see
    # hnswlib_write for the compat semantics) —
    # test_hnswlib_python_fallback_writer gates this
    raft = compat == "raft"
    with open(path, "wb") as f:
        f.write(struct.pack(
            "<QQQQQQiiQQQdQ",
            0, n, n, size_per_elem,
            size_links0 + data_size, size_links0,
            1 if raft else 0, n // 2 if raft else 0, m, degree, m,
            0.42424242 if raft else 1.0 / np.log(max(m, 2)),
            500 if raft else 200))
        for i in range(n):
            links = graph[i][graph[i] >= 0].astype(np.uint32)
            buf = bytearray(size_per_elem)
            buf[0:4] = struct.pack("<I", len(links))
            buf[4 : 4 + 4 * len(links)] = links.tobytes()
            buf[size_links0 : size_links0 + data_size] = (
                dataset[i].astype(np.float32).tobytes())
            buf[size_links0 + data_size :] = struct.pack("<Q", i)
            f.write(bytes(buf))
        f.write(b"\x00\x00\x00\x00" * n)


def graph_greedy_search(dataset: np.ndarray, graph: np.ndarray,
                        queries: np.ndarray, k: int, ef: int = 128,
                        entry: int = 0, n_threads: int = 0):
    """CPU ef-search over a fixed-degree graph — hnswlib's layer-0
    searchBaseLayerST algorithm, searching exactly the indexes
    :func:`hnswlib_write` emits (entry point 0). The external-competitor
    row of the bench harness (hnswlib wrapper role, bench/ann/src/
    hnswlib/hnswlib_wrapper.h), without a dependency on hnswlib.

    Returns (distances [nq, k] squared-L2, ids [nq, k]); -1/inf pads when
    a query's reachable component is smaller than k.
    """
    dataset = np.ascontiguousarray(dataset, np.float32)
    graph = np.ascontiguousarray(graph, np.int32)
    queries = np.ascontiguousarray(queries, np.float32)
    n, dim = dataset.shape
    nq = queries.shape[0]
    ef = max(int(ef), int(k))
    lib = _get_lib()
    if lib is None:
        return _graph_greedy_search_py(dataset, graph, queries, k, ef,
                                       entry)
    out_i = np.empty((nq, k), np.int32)
    out_d = np.empty((nq, k), np.float32)
    rc = lib.graph_greedy_search(
        dataset.ctypes.data_as(ctypes.c_void_p), n, dim,
        graph.ctypes.data_as(ctypes.c_void_p), graph.shape[1],
        queries.ctypes.data_as(ctypes.c_void_p), nq,
        int(k), ef, int(entry),
        out_i.ctypes.data_as(ctypes.c_void_p),
        out_d.ctypes.data_as(ctypes.c_void_p), int(n_threads))
    CALLS["graph_greedy_search"] += 1
    if rc != 0:
        raise ValueError(f"graph_greedy_search failed rc={rc}")
    return out_d, out_i


def _graph_greedy_search_py(dataset, graph, queries, k, ef, entry):
    """Reference-rate numpy fallback (same algorithm, one query at a
    time) — the path where the library cannot be built."""
    import heapq

    n, dim = dataset.shape
    nq = queries.shape[0]
    out_i = np.full((nq, k), -1, np.int32)
    out_d = np.full((nq, k), np.inf, np.float32)
    for qi in range(nq):
        q = queries[qi]
        d0 = float(((q - dataset[entry]) ** 2).sum())
        visited = {entry}
        cand = [(d0, entry)]  # min-heap frontier
        res = [(-d0, entry)]  # max-heap of top-ef (negated)
        while cand:
            d, c = heapq.heappop(cand)
            if d > -res[0][0] and len(res) >= ef:
                break
            nbrs = graph[c]
            nbrs = nbrs[nbrs >= 0]
            # dedupe while filtering: a row may repeat an id, and a
            # double-push would put the node in the result heap twice
            new = []
            for b in nbrs:
                b = int(b)
                if b not in visited:
                    visited.add(b)
                    new.append(b)
            if not new:
                continue
            dists = ((queries[qi][None] - dataset[new]) ** 2).sum(1)
            for b, db in zip(new, dists):
                db = float(db)
                if len(res) < ef or db < -res[0][0]:
                    heapq.heappush(cand, (db, int(b)))
                    heapq.heappush(res, (-db, int(b)))
                    if len(res) > ef:
                        heapq.heappop(res)
        top = sorted((-d, i) for d, i in res)[:k]
        for j, (d, i) in enumerate(top):
            out_d[qi, j], out_i[qi, j] = d, i
    return out_d, out_i


# --------------------------------------------------- agglomerative labeling


def agglomerative_label(src: np.ndarray, dst: np.ndarray, n: int,
                        n_clusters: int) -> np.ndarray:
    """Union-find dendrogram labeling over weight-sorted MST edges
    (cluster/detail/agglomerative.cuh analog). Returns labels [n]."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    lib = _get_lib()
    if lib is not None:
        labels = np.empty((n,), np.int32)
        lib.agglomerative_label(
            src.ctypes.data_as(ctypes.c_void_p),
            dst.ctypes.data_as(ctypes.c_void_p),
            len(src), n, n_clusters,
            labels.ctypes.data_as(ctypes.c_void_p))
        CALLS["agglomerative_label"] += 1
        return labels
    # numpy fallback
    parent = np.arange(n, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    target = n - n_clusters
    merges = 0
    for e in range(len(src)):
        if merges >= target:
            break
        if src[e] < 0 or dst[e] < 0:
            continue
        ra, rb = find(int(src[e])), find(int(dst[e]))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
            merges += 1
    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


# ------------------------------------------------------------- list packing


def pack_lists(rows: np.ndarray, labels: np.ndarray, n_lists: int,
               list_pad: int, ids: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack rows into padded per-list storage (host half of the IVF list
    fill, detail/ivf_flat_build.cuh:123-160) in the C++ library, or in
    :func:`pack_lists_numpy` when it cannot be built. Returns (data
    [L, pad, ...], ids [L, pad] int32, sizes [L] int32)."""
    lib = _get_lib()
    if lib is None:
        return pack_lists_numpy(rows, labels, n_lists, list_pad, ids)
    rows = np.ascontiguousarray(rows)
    labels = np.ascontiguousarray(labels, np.int32)
    n = len(rows)
    row_bytes = rows.dtype.itemsize * int(np.prod(rows.shape[1:]))
    out = np.zeros((n_lists, list_pad) + rows.shape[1:], rows.dtype)
    out_ids = np.empty((n_lists, list_pad), np.int32)
    sizes = np.zeros((n_lists,), np.int32)
    ids_c = np.ascontiguousarray(ids, np.int32) if ids is not None else None
    rc = lib.pack_lists(
        rows.ctypes.data_as(ctypes.c_void_p),
        labels.ctypes.data_as(ctypes.c_void_p),
        ids_c.ctypes.data_as(ctypes.c_void_p) if ids_c is not None else None,
        n, row_bytes, n_lists, list_pad,
        out.ctypes.data_as(ctypes.c_void_p),
        out_ids.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p))
    CALLS["pack_lists"] += 1
    if rc != 0:
        raise ValueError(f"pack_lists failed rc={rc} (bad label or "
                         f"list_pad too small)")
    return out, out_ids, sizes


def pack_lists_numpy(rows: np.ndarray, labels: np.ndarray, n_lists: int,
                     list_pad: int, ids: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`pack_lists` in numpy, rows in row order within each list; the
    packer of the IVF builds, which need no compiler."""
    rows = np.ascontiguousarray(rows)
    labels = np.ascontiguousarray(labels, np.int32)
    n = len(rows)
    out = np.zeros((n_lists, list_pad) + rows.shape[1:], rows.dtype)
    out_ids = np.full((n_lists, list_pad), -1, np.int32)
    src_ids = ids if ids is not None else np.arange(n, dtype=np.int32)
    order = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=n_lists).astype(np.int32)
    if sizes.max(initial=0) > list_pad:
        raise ValueError("list_pad too small")
    starts = np.zeros(n_lists + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    rs = rows[order]
    si = np.asarray(src_ids)[order]
    for l in range(n_lists):
        s, e = starts[l], starts[l + 1]
        out[l, : e - s] = rs[s:e]
        out_ids[l, : e - s] = si[s:e]
    return out, out_ids, sizes
