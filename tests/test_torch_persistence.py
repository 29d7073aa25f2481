"""raft_tpu_torch's persistence against raft_tpu's, on the CPU.

- Framing (``core.serialize``): the same records give the same bytes in both
  packages; a file written by either and then truncated, stripped of its
  footer, given an extra record or flipped in one byte raises
  ``IntegrityError`` with the same ``reason`` and record in both; a v1
  file reads; a failed atomic write leaves the previous file.
- Each family (brute force, IVF-Flat, IVF-PQ with and without overflow,
  CAGRA with and without its dataset): a raft_tpu index carried over by
  ``interop`` is written to the same bytes by both packages; the port reads
  raft_tpu's file and searches it bitwise like the carried index; raft_tpu
  reads the file of the port's own build and its search is within
  ``assert_topk_close``'s tolerance of the port's (distances rtol 1e-5 and
  atol 1e-4·max‖x‖², as ``test_torch_ivf_pq.py`` holds IVF-PQ against JAX
  too; ids equal away from near-ties).
- HNSW and the native layer: ``from_cagra`` writes raft_tpu's bytes in both
  ``compat`` modes, ``load`` round-trips, ``engine="cpu"`` is bitwise
  raft_tpu's (the same C++), ``engine="xla"`` is ``cagra.search`` at
  ``itopk_size=max(ef, k)``; the bin reader and writer, the prefetching
  reader, the graph search's C++ and Python paths, and the fallbacks.
- Core: the logger's levels and callback, ``tracing.profile``'s trace.
"""

import io
import json
import logging
import os
import struct
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from raft_tpu import native as jnative
from raft_tpu.core import errors as jerrors
from raft_tpu.core import serialize as jser
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcg
from raft_tpu.neighbors import hnsw as jhnsw
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import interop, native
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.core import errors, logger, tracing
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcg
from raft_tpu_torch.neighbors import hnsw as thnsw
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.testing import assert_topk_close

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    rows = low_rank_clusters(np.random.default_rng(3), 2050, 16)
    return rows[:2000], rows[2000:]


@pytest.fixture(scope="module")
def scale(data):
    return float((data[0] ** 2).sum(1).max())


def _overflow_rows(n=2000, dim=16):
    """One tight blob coarse k-means cannot split: with a tight
    ``list_pad_expansion`` the hot lists spill to the overflow block
    (tests/test_serialize_integrity.py's generator)."""
    rng = np.random.default_rng(21)
    hot = rng.standard_normal((n // 2, dim)).astype(np.float32) * 0.05
    rest = rng.standard_normal((n - n // 2, dim)).astype(np.float32) * 0.05
    rest += rng.standard_normal((n - n // 2, 1)).astype(np.float32) * 3.0
    out = np.concatenate([hot, rest])
    rng.shuffle(out)
    return out


def _bytes(write, index) -> bytes:
    buf = io.BytesIO()
    write(index, buf)
    return buf.getvalue()


def _equal(a, b):
    """Bitwise equality of two (distances, ids) results."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


def _np(result):
    return tuple(np.asarray(x) for x in result)


# -------------------------------------------------------------- framing


def _records(pkg, bf16_array):
    """The same record sequence through ``pkg``'s IndexWriter."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = np.arange(-3, 9, dtype=np.int32)
    u8 = rng.integers(0, 256, (2, 3, 4), dtype=np.uint8)
    buf = io.BytesIO()
    w = pkg.IndexWriter(buf, "kind", 3)
    w.scalar(7, "<i4").scalar(-2.5, "<f8").scalar(2 ** 40, "<i8")
    w.string("hello")
    if pkg is ser:
        f32, i32, u8 = (torch.from_numpy(a) for a in (f32, i32, u8))
    w.array(f32).array(i32).array(u8).array(bf16_array)
    w.blob(b"\x00nested\xff")
    w.finish()
    return buf.getvalue()


def test_writer_bytes_match_jax():
    x = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    want = _records(jser, x.astype(ml_dtypes.bfloat16))
    got = _records(ser, torch.from_numpy(x).to(torch.bfloat16))
    assert got == want
    assert ser.header_bytes("wal", 2) == jser.header_bytes("wal", 2)
    assert ser.frame(b"abc") == jser.frame(b"abc")
    r = ser.IndexReader(io.BytesIO(got), "kind", 3)
    assert (r.scalar(), r.scalar(), r.scalar(), r.string()) == (
        7, -2.5, 2 ** 40, "hello")
    for _ in range(3):
        r.array()
    bf = ser.to_tensor(r.array(), "cpu")
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, torch.from_numpy(x).to(torch.bfloat16))
    assert r.blob() == b"\x00nested\xff"
    r.finish()


def _damage(path, kind):
    data = open(path, "rb").read()
    spans = ser.record_spans(path)
    assert spans == jser.record_spans(path)
    if kind == "truncated":  # cut inside the dataset's record
        off, n = spans[2]
        data = data[:off + n // 2]
    elif kind == "no_footer":
        off, _ = spans[-1]
        data = data[:off - 8]
    elif kind == "extra_record":  # one more record before the footer
        off, _ = spans[-1]
        data = data[:off - 8] + ser.frame(b"extra") + data[off - 8:]
    else:  # one byte flipped in the dataset's record
        off, n = spans[2]
        data = bytearray(data)
        data[off + n // 2] ^= 0x40
        data = bytes(data)
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["truncated", "no_footer", "extra_record",
                                  "flipped"])
def test_damaged_files_raise_alike(tmp_path, data, writer, kind):
    db, _ = data
    path = str(tmp_path / "bf.idx")
    if writer == "jax":
        jbf.serialize(jbf.build(db, "sqeuclidean"), path)
    else:
        tbf.serialize(tbf.build(db, "sqeuclidean", device="cpu"), path)
    _damage(path, kind)
    with pytest.raises(jerrors.IntegrityError) as je:
        jbf.deserialize(path)
    with pytest.raises(errors.IntegrityError) as te:
        tbf.deserialize(path, device="cpu")
    assert (te.value.reason, te.value.record, te.value.path) == (
        je.value.reason, je.value.record, je.value.path)
    assert str(te.value) == str(je.value)


def _v1_ivf_flat_file(j) -> bytes:
    """An ivf_flat file in container format v1 (unframed records, no
    footer) at kind version 1 (no pad cap, no overflow block)."""
    buf = io.BytesIO()
    buf.write(b"RAFT_TPU_IDX" + struct.pack("<I", 1))
    buf.write(struct.pack("<I", 8) + b"ivf_flat" + struct.pack("<I", 1))
    for value, dt in ((int(j.metric), "<i4"), (j.params.n_lists, "<i8"),
                      (j.params.kmeans_n_iters, "<i4"),
                      (j.params.kmeans_trainset_fraction, "<f8"), (0, "<i4"),
                      (j.n_rows, "<i8")):
        jser.serialize_scalar(buf, value, dt)
    for a in (j.centers, j.list_data, j.list_indices, j.list_sizes):
        jser.serialize_array(buf, np.asarray(a))
    return buf.getvalue()


def test_v1_file_reads_as_in_jax(data):
    db, q = data
    j = jflat.build(db, jflat.IndexParams(n_lists=16, list_pad_expansion=1e30),
                    res=JResources(seed=0))
    raw = _v1_ivf_flat_file(j)
    jj = jflat.deserialize(io.BytesIO(raw))
    t = tflat.deserialize(io.BytesIO(raw), device="cpu")
    assert t.params.list_pad_expansion == jj.params.list_pad_expansion == 1e30
    assert t.overflow_indices.shape == (0,)
    for name in ("centers", "list_data", "list_indices", "list_sizes"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(jj, name)))
    sp = tflat.SearchParams(n_probes=16)
    _equal(tflat.search(t, q, 10, sp),
           tflat.search(_carry_flat(j), q, 10, sp))


def test_failed_atomic_write_keeps_the_previous_file(tmp_path, data):
    db, _ = data
    path = tmp_path / "bf.idx"
    index = tbf.build(db, "sqeuclidean", device="cpu")
    tbf.serialize(index, path)
    good = path.read_bytes()
    with pytest.raises(RuntimeError, match="crash"), \
            ser.writer_for(path) as stream:
        stream.write(b"half of the next file")
        raise RuntimeError("crash mid-serialize")
    assert path.read_bytes() == good
    assert sorted(os.listdir(tmp_path)) == ["bf.idx"]  # no tmp file left
    assert ser.file_crc32(path) == jser.file_crc32(path) == zlib.crc32(good)


# ------------------------------------------------------------- families


def _carry_bf(j):
    return interop.brute_force_index_from_numpy(
        np.asarray(j.dataset), j.metric,
        None if j.norms is None else np.asarray(j.norms), j.metric_arg,
        device="cpu")


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_brute_force_files_cross(tmp_path, data, scale, metric):
    db, q = data
    j = jbf.build(db, metric)
    carried = _carry_bf(j)
    assert _bytes(tbf.serialize, carried) == _bytes(jbf.serialize, j)
    jbf.serialize(j, tmp_path / "jax.idx")
    restored = tbf.deserialize(tmp_path / "jax.idx", res=CPU)
    assert restored.device.type == "cpu"
    _equal(tbf.search(restored, q, 10), tbf.search(carried, q, 10))
    own = tbf.build(db, metric, device="cpu")
    tbf.serialize(own, tmp_path / "port.idx")
    assert_topk_close(_np(jbf.search(jbf.deserialize(tmp_path / "port.idx"),
                                     q, 10)),
                      tbf.search(own, q, 10), 1e-4 * scale, 1e-5)


def _carry_flat(j):
    p = j.params
    return interop.ivf_flat_index_from_numpy(
        tflat.IndexParams(n_lists=p.n_lists, metric=int(p.metric),
                          kmeans_n_iters=p.kmeans_n_iters,
                          kmeans_trainset_fraction=p.kmeans_trainset_fraction,
                          adaptive_centers=p.adaptive_centers,
                          list_pad_expansion=p.list_pad_expansion),
        *(np.asarray(a) for a in (j.centers, j.list_data, j.list_indices,
                                  j.list_sizes)), j.n_rows,
        np.asarray(j.overflow_data), np.asarray(j.overflow_indices),
        device="cpu")


@pytest.mark.parametrize("overflow", [False, True])
def test_ivf_flat_files_cross(tmp_path, data, overflow):
    db, q = data
    if overflow:
        db, q = _overflow_rows(), _overflow_rows()[:40] + 0.01
    params = dict(n_lists=16, kmeans_n_iters=4,
                  list_pad_expansion=1.01 if overflow else 1.5)
    j = jflat.build(db, jflat.IndexParams(**params), res=JResources(seed=0))
    assert (int((np.asarray(j.overflow_indices) >= 0).sum()) > 0) == overflow
    carried = _carry_flat(j)
    assert _bytes(tflat.serialize, carried) == _bytes(jflat.serialize, j)
    jflat.serialize(j, tmp_path / "jax.idx")
    restored = tflat.deserialize(tmp_path / "jax.idx", res=CPU)
    sp = tflat.SearchParams(n_probes=6)
    _equal(tflat.search(restored, q, 10, sp), tflat.search(carried, q, 10, sp))
    own = tflat.build(db, tflat.IndexParams(**params), device="cpu")
    tflat.serialize(own, tmp_path / "port.idx")
    back = jflat.deserialize(tmp_path / "port.idx")
    assert_topk_close(
        _np(jflat.search(back, q, 10, jflat.SearchParams(n_probes=6,
                                                         scan_mode="xla"))),
        tflat.search(own, q, 10, sp),
        1e-4 * float((db ** 2).sum(1).max()), 1e-5)


def _carry_pq(j):
    p = j.params
    return interop.ivf_pq_index_from_numpy(
        tpq.IndexParams(n_lists=p.n_lists, metric=int(p.metric),
                        kmeans_n_iters=p.kmeans_n_iters,
                        kmeans_trainset_fraction=p.kmeans_trainset_fraction,
                        pq_bits=p.pq_bits, pq_dim=j.pq_dim,
                        codebook_kind=int(p.codebook_kind),
                        force_random_rotation=p.force_random_rotation,
                        list_pad_expansion=p.list_pad_expansion),
        j.pq_dim, *(np.asarray(a) for a in (
            j.centers, j.rotation, j.codebooks, j.list_codes, j.list_indices,
            j.list_sizes)), j.n_rows,
        *(np.asarray(a) for a in (j.overflow_codes, j.overflow_labels,
                                  j.overflow_indices)), device="cpu")


def _lut_res(index):
    """CPU Resources whose stated device memory puts ``index`` in the LUT
    regime."""
    return Resources(device="cpu",
                     device_memory_bytes=sum(tpq.scan_memory_bytes(index)))


@pytest.mark.parametrize("overflow", [False, True])
def test_ivf_pq_files_cross(tmp_path, data, overflow):
    db, q = data
    if overflow:
        db, q = _overflow_rows(), _overflow_rows()[:40] + 0.01
    params = dict(n_lists=16, pq_dim=8, kmeans_n_iters=4,
                  list_pad_expansion=1.01 if overflow else 1.5)
    j = jpq.build(db, jpq.IndexParams(**params), res=JResources(seed=0))
    assert (int((np.asarray(j.overflow_indices) >= 0).sum()) > 0) == overflow
    carried = _carry_pq(j)
    assert _bytes(tpq.serialize, carried) == _bytes(jpq.serialize, j)
    jpq.serialize(j, tmp_path / "jax.idx")
    restored = tpq.deserialize(tmp_path / "jax.idx", res=CPU)
    assert restored.list_decoded is None  # the file holds no cache
    sp = tpq.SearchParams(n_probes=6)
    for res in (CPU, _lut_res(carried)):  # both memory regimes
        got = tpq.search(restored, q, 10, sp, res=res, explain=True)
        want = tpq.search(carried, q, 10, sp, res=res)
        assert got[2].engine == ("pallas_cache" if res is CPU
                                 else "pallas_lut")
        _equal(got[:2], want)
    own = tpq.build(db, tpq.IndexParams(**params), device="cpu")
    tpq.serialize(own, tmp_path / "port.idx")
    back = jpq.deserialize(tmp_path / "port.idx")
    got = tpq.search(own, q, 10, tpq.SearchParams(n_probes=6,
                                                  scan_mode="lut"))
    want = _np(jpq.search(back, q, 10, jpq.SearchParams(n_probes=6,
                                                        scan_mode="lut")))
    assert_topk_close(got, want, 1e-4 * float((db ** 2).sum(1).max()), 1e-5)


@pytest.fixture(scope="module")
def jcagra(data):
    """A raft_tpu CAGRA index over a random graph (search needs no build)."""
    db, _ = data
    graph = np.random.default_rng(5).integers(0, len(db), (len(db), 16),
                                              dtype=np.int32)
    return jcg.Index(jcg.IndexParams(graph_degree=16), jnp.asarray(db),
                     jnp.asarray(graph))


def _carry_cagra(j):
    return interop.cagra_index_from_numpy(
        tcg.IndexParams(graph_degree=j.graph_degree, metric=int(j.metric)),
        np.asarray(j.dataset), np.asarray(j.graph), device="cpu")


@pytest.fixture(scope="module")
def own_cagra(data):
    return tcg.build(data[0], tcg.IndexParams(
        intermediate_graph_degree=32, graph_degree=16, nn_descent_niter=6),
        res=Resources(device="cpu", seed=0))


@pytest.mark.parametrize("include_dataset", [True, False])
def test_cagra_files_cross(tmp_path, data, scale, jcagra, own_cagra,
                           include_dataset):
    db, q = data
    carried = _carry_cagra(jcagra)

    def write(pkg, index):
        return lambda i, f: pkg.serialize(index, f, include_dataset)

    assert _bytes(write(tcg, carried), None) == \
        _bytes(write(jcg, jcagra), None)
    jcg.serialize(jcagra, tmp_path / "jax.idx", include_dataset)
    ds = None if include_dataset else db
    restored = tcg.deserialize(tmp_path / "jax.idx", dataset=ds, res=CPU)
    sp = tcg.SearchParams(itopk_size=32)
    _equal(tcg.search(restored, q, 10, sp), tcg.search(carried, q, 10, sp))
    tcg.serialize(own_cagra, tmp_path / "port.idx", include_dataset)
    back = jcg.deserialize(tmp_path / "port.idx", dataset=ds)
    assert_topk_close(
        _np(jcg.search(back, q, 10, jcg.SearchParams(itopk_size=32))),
        tcg.search(own_cagra, q, 10, sp), 1e-4 * scale, 1e-5)
    if not include_dataset:
        with pytest.raises(ValueError, match="dataset="):
            tcg.deserialize(tmp_path / "port.idx", res=CPU)


def test_restores_land_on_cuda_unless_asked_for_cpu(tmp_path, data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    db, _ = data
    tbf.serialize(tbf.build(db, device="cpu"), tmp_path / "bf.idx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbf.deserialize(tmp_path / "bf.idx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thnsw.load(str(tmp_path / "missing.hnsw"))


def test_decoded_only_pq_index_refuses_what_needs_codes(data):
    """An IVF-PQ index restored without its codes (a cache-regime sharded
    checkpoint's rank) searches in the cache regime only and cannot be
    written, extended or re-decoded."""
    db, q = data
    own = tpq.build(db, tpq.IndexParams(n_lists=16, pq_dim=8,
                                        kmeans_n_iters=4), device="cpu")
    tpq.ensure_scan_cache(own)
    part = tpq.index_from_parts(
        own.params, own.pq_dim, own.centers, own.rotation, own.list_indices,
        own.list_sizes, own.n_rows, list_decoded=own.list_decoded,
        decoded_norms=own.decoded_norms)
    assert part.lists_decoded_only
    sp = tpq.SearchParams(n_probes=6)
    # the LUT regime's stated memory does not move it off the cache
    _equal(tpq.search(part, q, 10, sp, res=_lut_res(own)),
           tpq.search(own, q, 10, sp))
    with pytest.raises(ValueError, match="packed codes"):
        tpq.search(part, q, 10, tpq.SearchParams(scan_mode="lut"))
    with pytest.raises(ValueError, match="without its codes"):
        tpq.serialize(part, io.BytesIO())
    with pytest.raises(ValueError, match="without its codes"):
        tpq.extend(part, db[:5])
    with pytest.raises(ValueError, match="scan_cache_dtype"):
        tpq.ensure_scan_cache(part, torch.float32)


# -------------------------------------------------------- hnsw, native


@pytest.mark.parametrize("compat", ["hnswlib", "raft"])
def test_hnsw_export_matches_jax(tmp_path, jcagra, compat):
    carried = _carry_cagra(jcagra)
    thnsw.from_cagra(carried, str(tmp_path / "port.hnsw"), compat=compat)
    jhnsw.from_cagra(jcagra, str(tmp_path / "jax.hnsw"), compat=compat)
    want = (tmp_path / "jax.hnsw").read_bytes()
    assert (tmp_path / "port.hnsw").read_bytes() == want
    native._hnswlib_write_py(str(tmp_path / "py.hnsw"),
                             np.asarray(jcagra.dataset),
                             np.asarray(jcagra.graph), compat)
    assert (tmp_path / "py.hnsw").read_bytes() == want
    loaded = thnsw.load(str(tmp_path / "port.hnsw"), device="cpu")
    jl = jhnsw.load(str(tmp_path / "jax.hnsw"))
    np.testing.assert_array_equal(loaded.graph, jl.graph)
    np.testing.assert_array_equal(loaded.dataset, jl.dataset)
    np.testing.assert_array_equal(loaded.graph, np.asarray(jcagra.graph))


def test_hnsw_search_engines(tmp_path, data, jcagra):
    db, q = data
    carried = _carry_cagra(jcagra)
    path = str(tmp_path / "g.hnsw")
    thnsw.from_cagra(carried, path)
    loaded = thnsw.load(path, device="cpu")
    native.CALLS.clear()
    got = thnsw.search(loaded, q, 10, ef=24, engine="cpu")
    assert native.CALLS["graph_greedy_search"] == 1
    want = jhnsw.search(jhnsw.load(path), q, 10, ef=24, engine="cpu")
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    py = native._graph_greedy_search_py(db, np.asarray(jcagra.graph), q, 10,
                                        24, 0)
    np.testing.assert_array_equal(py[1], want[1])
    np.testing.assert_allclose(py[0], want[0], rtol=1e-5,
                               atol=1e-5 * float((db ** 2).sum(1).max()))
    for ef in (8, 40):  # itopk_size = max(ef, k)
        _equal(thnsw.search(loaded, q, 10, ef=ef),
               tcg.search(carried, q, 10,
                          tcg.SearchParams(itopk_size=max(ef, 10))))
    with pytest.raises(ValueError, match="engine"):
        thnsw.search(loaded, q, 10, engine="gpu")


def test_bin_files_and_readers(tmp_path):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1000, 12)).astype(np.float32)
    path = str(tmp_path / "x.fbin")
    native.write_bin(path, x)
    jpath = str(tmp_path / "j.fbin")
    jnative.write_bin(jpath, x)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    assert native.read_bin_header(path) == (1000, 12)
    np.testing.assert_array_equal(native.read_bin(path, 100, 50), x[100:150])
    sync = list(native.iter_bin_batches(path, 128))
    pre = list(native.iter_bin_batches_prefetch(path, 128))
    assert [s for s, _ in pre] == [s for s, _ in sync]
    for (_, a), (_, b) in zip(pre, sync):
        np.testing.assert_array_equal(a, b)
    ranged = list(native.iter_bin_batches_prefetch(path, 96,
                                                   row_range=(130, 500)))
    assert ranged[0][0] == 130
    np.testing.assert_array_equal(np.concatenate([b for _, b in ranged]),
                                  x[130:500])
    ids = rng.integers(0, 50, (300, 3)).astype(np.int32)
    native.write_bin(str(tmp_path / "i.ibin"), ids)
    np.testing.assert_array_equal(native.read_bin(str(tmp_path / "i.ibin")),
                                  ids)


def test_native_library_and_fallbacks_agree(monkeypatch):
    assert native.available()
    assert "build" in native.library_path().parts
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((300, 6)).astype(np.float32)
    labels = rng.integers(0, 7, 300).astype(np.int32)
    src = rng.integers(0, 80, 200).astype(np.int32)
    dst = rng.integers(0, 80, 200).astype(np.int32)
    native.CALLS.clear()
    packed = native.pack_lists(rows, labels, 7, 64)
    agg = native.agglomerative_label(src, dst, 80, 5)
    assert native.CALLS["pack_lists"] == native.CALLS[
        "agglomerative_label"] == 1
    monkeypatch.setattr(native, "_get_lib", lambda: None)
    for a, b in zip(packed, native.pack_lists(rows, labels, 7, 64)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(agg, native.agglomerative_label(
        src, dst, 80, 5))
    np.testing.assert_array_equal(agg, jnative.agglomerative_label(
        src, dst, 80, 5))



def test_library_is_keyed_by_machine_and_compiler(monkeypatch):
    path = native.library_path()
    monkeypatch.setattr(native, "_compiler_id", lambda: "other-arch g++ 0")
    assert native.library_path() != path
    assert native.library_path().parent == path.parent


def test_ivf_builds_pack_in_numpy(data):
    """The builds take the numpy packer, never the C++ library, and it
    packs as the library does."""
    db, _ = data
    native.CALLS.clear()
    flat = tflat.build(db, tflat.IndexParams(n_lists=16), res=CPU)
    tpq.build(db, tpq.IndexParams(n_lists=16, pq_dim=8), res=CPU)
    assert native.CALLS["pack_lists"] == 0
    labels = np.random.default_rng(5).integers(0, 16, 2000).astype(np.int32)
    ids = np.arange(7, 2007, dtype=np.int32)
    pad = int(np.bincount(labels).max())
    for a, b in zip(native.pack_lists(db, labels, 16, pad, ids),
                    native.pack_lists_numpy(db, labels, 16, pad, ids)):
        np.testing.assert_array_equal(a, b)
    assert native.CALLS["pack_lists"] == 1
    assert int(flat.size) == len(db)

# ---------------------------------------------------------------- core


def test_logger_levels_and_callback():
    seen = []
    logger.set_callback(lambda level, msg: seen.append((level, msg)))
    old = logger.get_logger().level
    try:
        logger.set_level(logging.ERROR)
        logger.trace("t %d", 1)
        logger.debug("d")
        logger.info("i")
        logger.warn("w %s", "x")
        logger.error("e")
    finally:
        logger.set_callback(None)
        logger.set_level(old)
    assert seen == [(logging.DEBUG - 5, "t 1"), (logging.DEBUG, "d"),
                    (logging.INFO, "i"), (logging.WARNING, "w x"),
                    (logging.ERROR, "e")]
    assert logger.get_logger().name == "raft_tpu"


def test_tracing_profile_writes_a_trace(tmp_path, data):
    db, q = data
    index = tbf.build(db, device="cpu")

    @tracing.annotate()
    def run():
        with logger.annotate("inner"):
            return tbf.search(index, q, 5)

    with tracing.profile(str(tmp_path)) as log_dir:
        run()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert log_dir == str(tmp_path)
    assert {"brute_force.search", "inner"} <= names
    assert any(n and n.endswith("run") for n in names)
