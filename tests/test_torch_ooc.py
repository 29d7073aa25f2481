"""raft_tpu_torch's streamed (out-of-core) builds against raft_tpu's, on the
CPU.

- ``sample_rows_from_file`` returns raft_tpu's rows for the same seed, also
  over a ``row_range``.
- The streamed IVF-Flat and IVF-PQ builds: every row id stored exactly once,
  each IVF-Flat row its dataset row, recall@10 against exact search (all
  lists probed: IVF-Flat 1.0; IVF-PQ >= 0.80 at half the lists).
- With the same centres given to both packages (the k-means fit replaced,
  or the trained IVF-PQ index passed as ``trained_index``), the labels
  equal raft_tpu's away from near-ties (the gap between the two nearest
  centres above 1e-5 of the largest squared norm), so do the lists'
  contents, and the IVF-PQ codes agree on all but a ``1e-3`` share.
"""

import numpy as np
import pytest
import torch

from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ooc as jooc

from raft_tpu_torch import interop, native
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, ooc
from raft_tpu_torch.stats import neighborhood_recall

ROWS, DIM = 4000, 32


@pytest.fixture(scope="module")
def fbin(tmp_path_factory):
    rows = low_rank_clusters(np.random.default_rng(7), ROWS + 64, DIM)
    db, q = rows[:ROWS], rows[ROWS:]
    path = str(tmp_path_factory.mktemp("ooc") / "base.fbin")
    native.write_bin(path, db)
    return path, db, q


def _cpu(seed=2):
    return Resources(device="cpu", seed=seed)


@pytest.mark.parametrize("row_range", [None, (500, 3100)])
def test_sample_rows_equal_raft_tpu(fbin, row_range):
    path, db, _ = fbin
    got = ooc.sample_rows_from_file(path, 700, seed=3, batch_rows=900,
                                    row_range=row_range)
    want = jooc.sample_rows_from_file(path, 700, seed=3, batch_rows=900,
                                      row_range=row_range)
    np.testing.assert_array_equal(got, want)
    lo, hi = row_range or (0, ROWS)
    assert got.shape == (700, DIM)
    assert np.isin(got[:, 0], db[lo:hi, 0]).all()


def _gt(db, q):
    bf = brute_force.build(db, metric="sqeuclidean", device="cpu")
    return brute_force.search(bf, q, 10)[1]


def _assert_ids_once(list_indices, list_sizes, overflow_indices, n):
    ids = list_indices.numpy()
    sizes = list_sizes.numpy()
    stored = [ids[l, :sizes[l]] for l in range(len(sizes))]
    over = overflow_indices.numpy()
    stored.append(over[over >= 0])
    allid = np.concatenate(stored)
    assert np.array_equal(np.sort(allid), np.arange(n))


def test_streamed_ivf_flat_ids_and_recall(fbin):
    path, db, q = fbin
    index = ooc.build_ivf_flat_from_file(
        path, ivf_flat.IndexParams(n_lists=16, list_pad_expansion=1.1),
        res=_cpu(), batch_rows=700)
    assert index.size == ROWS
    _assert_ids_once(index.list_indices, index.list_sizes,
                     index.overflow_indices, ROWS)
    data, idxs = index.list_data.numpy(), index.list_indices.numpy()
    for l in range(16):
        s = int(index.list_sizes[l])
        np.testing.assert_array_equal(data[l, :s], db[idxs[l, :s]])
    _, i = ivf_flat.search(index, q, 10, ivf_flat.SearchParams(n_probes=16))
    assert float(neighborhood_recall(i, _gt(db, q))) >= 0.999


def test_streamed_ivf_pq_ids_and_recall(fbin):
    path, db, q = fbin
    index = ooc.build_ivf_pq_from_file(
        path, ivf_pq.IndexParams(n_lists=16, pq_dim=16, kmeans_n_iters=8),
        res=_cpu(), batch_rows=900, max_train_rows=2000)
    assert index.size == ROWS
    _assert_ids_once(index.list_indices, index.list_sizes,
                     index.overflow_indices, ROWS)
    _, i = ivf_pq.search(index, q, 10, ivf_pq.SearchParams(n_probes=8))
    assert float(neighborhood_recall(i, _gt(db, q))) >= 0.80


def _clear_rows(db, centers):
    """Rows whose two nearest centres are further apart than 1e-5 of the
    largest squared norm (float64)."""
    d = ((db[:, None, :].astype(np.float64)
          - centers[None, :, :].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) > 1e-5 * float((db * db).sum(1).max())


def _placement(list_indices, list_sizes, rows=None):
    """id → (list, the id's row of ``rows`` [L, pad, ...] or None)."""
    ids, sizes = np.asarray(list_indices), np.asarray(list_sizes)
    out = {}
    for l in range(len(sizes)):
        for s in range(int(sizes[l])):
            out[int(ids[l, s])] = (l, None if rows is None
                                   else np.asarray(rows)[l, s].tobytes())
    return out


def test_flat_labels_and_lists_equal_raft_tpu_with_injected_centres(
        fbin, monkeypatch):
    path, db, _ = fbin
    centers = db[np.random.default_rng(0).choice(ROWS, 16, replace=False)]
    monkeypatch.setattr(jooc.kmeans_balanced, "fit",
                        lambda *a, **k: np.asarray(centers))
    monkeypatch.setattr(ooc.kmeans_balanced, "fit",
                        lambda *a, **k: torch.from_numpy(centers.copy()))
    j = jooc.build_ivf_flat_from_file(
        path, jflat.IndexParams(n_lists=16, list_pad_expansion=3.0),
        res=JResources(seed=0), batch_rows=700)
    t = ooc.build_ivf_flat_from_file(
        path, ivf_flat.IndexParams(n_lists=16, list_pad_expansion=3.0),
        res=_cpu(), batch_rows=700)
    jl = jooc._labels_pass(path, j.centers, j.metric, 700, None,
                           JResources(seed=0))
    tl = ooc._labels_pass(path, t.centers, t.metric, 700, None)
    clear = _clear_rows(db, centers)
    assert clear.mean() > 0.99
    assert np.array_equal(jl[clear], tl[clear])
    jp = _placement(j.list_indices, j.list_sizes, j.list_data)
    tp = _placement(t.list_indices, t.list_sizes, t.list_data)
    assert set(jp) == set(tp)
    assert set(np.asarray(j.overflow_indices).tolist()) == \
        set(t.overflow_indices.tolist())
    for id_ in np.flatnonzero(clear):
        assert jp.get(int(id_)) == tp.get(int(id_))


def test_pq_lists_equal_raft_tpu_with_a_trained_index(fbin):
    path, db, _ = fbin
    params = dict(n_lists=16, pq_dim=16, kmeans_n_iters=6,
                  add_data_on_build=False, list_pad_expansion=3.0)
    jt = jpq.build(db[:2000], jpq.IndexParams(**params),
                   res=JResources(seed=0))
    tt = interop.ivf_pq_index_from_numpy(
        ivf_pq.IndexParams(**params), jt.pq_dim, np.asarray(jt.centers),
        np.asarray(jt.rotation), np.asarray(jt.codebooks),
        np.zeros((16, 0, jt.pq_dim), np.uint8),
        np.zeros((16, 0), np.int32), np.zeros((16,), np.int32), 0,
        np.zeros((0, jt.pq_dim), np.uint8), np.zeros((0,), np.int32),
        np.zeros((0,), np.int32), device="cpu")
    j = jooc.build_ivf_pq_from_file(
        path, jpq.IndexParams(**params), res=JResources(seed=0),
        batch_rows=900, trained_index=jt)
    t = ooc.build_ivf_pq_from_file(
        path, ivf_pq.IndexParams(**params), res=_cpu(), batch_rows=900,
        trained_index=tt)
    clear = _clear_rows(db, np.asarray(jt.centers))
    assert clear.mean() > 0.99
    jp = _placement(j.list_indices, j.list_sizes, j.list_codes)
    tp = _placement(t.list_indices, t.list_sizes, t.list_codes)
    assert set(jp) == set(tp)
    ids = [int(i) for i in np.flatnonzero(clear) if int(i) in jp]
    assert len(ids) > 0.9 * ROWS
    assert all(jp[i][0] == tp[i][0] for i in ids)
    agree = np.mean([jp[i][1] == tp[i][1] for i in ids])
    assert agree >= 1 - 1e-3


def test_row_range_builds_keep_file_row_ids(fbin):
    path, db, _ = fbin
    lo, hi = 1000, 3100
    index = ooc.build_ivf_flat_from_file(
        path, ivf_flat.IndexParams(n_lists=8), res=_cpu(), batch_rows=700,
        row_range=(lo, hi))
    assert index.size == hi - lo
    sizes = index.list_sizes.numpy()
    ids = np.concatenate([index.list_indices.numpy()[l, :sizes[l]]
                          for l in range(8)]
                         + [index.overflow_indices.numpy()])
    ids = ids[ids >= 0]
    assert np.array_equal(np.sort(ids), np.arange(lo, hi))
    data = index.list_data.numpy()
    for l in range(8):
        s = int(sizes[l])
        np.testing.assert_array_equal(
            data[l, :s], db[index.list_indices.numpy()[l, :s]])


def test_tiered_from_file_is_the_streamed_build_demoted(fbin):
    from raft_tpu_torch.neighbors import tiered

    path, db, q = fbin
    params = ivf_pq.IndexParams(n_lists=16, pq_dim=16, kmeans_n_iters=4)
    t = tiered.TieredIvfPq.from_file(path, params, res=_cpu(seed=5),
                                     batch_rows=900, max_train_rows=1500,
                                     arena_slots=16)
    idx = ooc.build_ivf_pq_from_file(path, params, res=_cpu(seed=5),
                                     batch_rows=900, max_train_rows=1500)
    sp = ivf_pq.SearchParams(n_probes=6)
    got = t.search(q, 10, sp)
    want = ivf_pq.search(idx, q, 10, sp, res=_cpu(), memory_mode="cache")
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert t.tier.n_lists == 16 and t.n_rows == ROWS
