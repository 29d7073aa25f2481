"""raft_tpu_torch's IVF-Flat path against raft_tpu's, on the CPU.

Search is held on identical state: the JAX package builds the index and
``interop.ivf_flat_index_from_numpy`` carries it over; the port's fused path
(the plain version of fused_ivf_topk) and its tiled path are held against
the JAX XLA engine and the JAX fused kernel in interpret mode, with and
without an overflow block and a filter. Builds cannot match bit for bit
(jax.random and torch draw different numbers), so the build is held by
injected state (labels at fixed centers; the packed layout of an extend into
JAX-trained centers) and by recall against the exact neighbours.

Tolerances: distances rtol 1e-5 and atol 1e-4·max‖x‖² (‖x‖ for L2Sqrt, 1 for
cosine); ids equal away from near-ties, near-ties as sets; build recall
within 0.02 of the JAX build's.
"""

import importlib

import jax.numpy as jnp

import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import list_packing as jlp
from raft_tpu_torch import interop
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.cluster import kmeans_balanced as tkm
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import list_packing as tlp
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.stats import neighborhood_recall
from raft_tpu_torch.testing import assert_topk_close

jkm = importlib.import_module("raft_tpu.cluster.kmeans_balanced")

METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    db = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    return db, q


@pytest.fixture(scope="module")
def jindex(data):
    return jivf.build(data[0], jivf.IndexParams(n_lists=16))


def _atol(metric, db):
    scale = float((db ** 2).sum(1).max())
    return 1e-4 * {"sqeuclidean": scale, "euclidean": np.sqrt(scale),
                   "inner_product": scale, "cosine": 1.0}[metric]


def _with_metric(jidx, metric):
    """The JAX index's state under another metric, in both packages."""
    jparams = jivf.IndexParams(n_lists=jidx.n_lists, metric=metric,
                               list_pad_expansion=jidx.params.list_pad_expansion)
    j = jivf.Index(jparams, jidx.centers, jidx.list_data, jidx.list_indices,
                   jidx.list_sizes, jidx.n_rows, jidx.overflow_data,
                   jidx.overflow_indices)
    t = interop.ivf_flat_index_from_numpy(
        tivf.IndexParams(n_lists=jidx.n_lists, metric=metric),
        np.asarray(jidx.centers), np.asarray(jidx.list_data),
        np.asarray(jidx.list_indices), np.asarray(jidx.list_sizes),
        jidx.n_rows, np.asarray(jidx.overflow_data),
        np.asarray(jidx.overflow_indices), device="cpu")
    return j, t


@pytest.mark.parametrize("scan_mode", ["auto", "xla"])
@pytest.mark.parametrize("metric", METRICS)
def test_search_on_carried_index_matches_jax(data, jindex, metric, scan_mode):
    db, q = data
    j, t = _with_metric(jindex, metric)
    want = jivf.search(j, q, 10, jivf.SearchParams(n_probes=4, scan_mode="xla"))
    got = tivf.search(t, q, 10, tivf.SearchParams(n_probes=4,
                                                  scan_mode=scan_mode))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_topk_close(got, want, _atol(metric, db), 1e-5)


@pytest.mark.parametrize("k", [1, 10, 64])
def test_fused_path_matches_jax_pallas_interpret(data, jindex, monkeypatch, k):
    monkeypatch.setenv("RAFT_TPU_PALLAS_INTERPRET", "1")
    db, q = data
    j, t = _with_metric(jindex, "sqeuclidean")
    want = jivf.search(j, q, k, jivf.SearchParams(n_probes=3,
                                                  scan_mode="pallas"))
    got = tivf.search(t, q, k, tivf.SearchParams(n_probes=3))
    assert_topk_close(got, want, _atol("sqeuclidean", db), 1e-5)


@pytest.mark.parametrize("scan_mode", ["auto", "xla"])
def test_search_with_overflow_matches_jax(monkeypatch, scan_mode):
    # tight pad budget forces spill (the setup of raft_tpu's
    # test_ivf_flat_pallas_interpret_parity_with_overflow)
    rng = np.random.default_rng(5)
    db = np.concatenate([
        rng.standard_normal((500, 16)).astype(np.float32),
        rng.standard_normal((150, 16)).astype(np.float32) * 0.05 + 2.0])
    q = rng.standard_normal((9, 16)).astype(np.float32)
    idx = jivf.build(db, jivf.IndexParams(n_lists=8, list_pad_expansion=1.01))
    assert idx.overflow_data.shape[0] > 0
    _, t = _with_metric(idx, "sqeuclidean")
    got = tivf.search(t, q, 10, tivf.SearchParams(n_probes=4,
                                                  scan_mode=scan_mode))
    want_x = jivf.search(idx, q, 10, jivf.SearchParams(n_probes=4,
                                                       scan_mode="xla"))
    monkeypatch.setenv("RAFT_TPU_PALLAS_INTERPRET", "1")
    want_p = jivf.search(idx, q, 10, jivf.SearchParams(n_probes=4,
                                                       scan_mode="pallas"))
    for want in (want_x, want_p):
        assert_topk_close(got, want, _atol("sqeuclidean", db), 1e-5)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_filtered_search_matches_jax(data, jindex, metric):
    db, q = data
    j, t = _with_metric(jindex, metric)
    mask = np.random.default_rng(22).random(len(db)) < 0.6
    want = jivf.search(j, q, 10, jivf.SearchParams(n_probes=6),
                       filter=JBitset.from_mask(mask))
    got = tivf.search(t, q, 10, tivf.SearchParams(n_probes=6),
                      filter=Bitset.from_mask(torch.from_numpy(mask)))
    assert_topk_close(got, want, _atol(metric, db), 1e-5)
    ids = got[1].numpy()
    assert mask[ids[ids >= 0]].all()


def test_bf16_lists_fused_matches_tiled(data):
    db, q = data
    index = tivf.build(torch.from_numpy(db).to(torch.bfloat16),
                       tivf.IndexParams(n_lists=16), device="cpu")
    assert index.list_data.dtype == torch.bfloat16
    got = tivf.search(index, q, 10, tivf.SearchParams(n_probes=5))
    want = tivf.search(index, q, 10, tivf.SearchParams(n_probes=5,
                                                       scan_mode="xla"))
    assert_topk_close(got, want, _atol("sqeuclidean", db), 1e-5)


# -------------------------------------------------------------------- build


def test_predict_at_fixed_centers_gives_equal_labels(data, jindex):
    db, _ = data
    centers = np.asarray(jindex.centers)
    want = np.asarray(jkm.predict(centers, db))
    got = tkm.predict(torch.from_numpy(centers.copy()), db).numpy()
    d = ((db[:, None, :] - centers[None]) ** 2).sum(-1)
    top2 = np.sort(d, axis=1)[:, :2]
    clear = top2[:, 1] - top2[:, 0] > 1e-4 * d.max()
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.mean() > 0.99


def test_calc_centers_and_sizes_matches(data):
    db, _ = data
    labels = np.random.default_rng(23).integers(0, 10, len(db)).astype(np.int32)
    w = np.random.default_rng(24).random(len(db)).astype(np.float32)
    for weights in (None, w):
        jc, js = jkm.calc_centers_and_sizes(db, labels, 10, weights)
        tc, ts = tkm.calc_centers_and_sizes(
            torch.from_numpy(db), torch.from_numpy(labels), 10,
            None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_extend_into_jax_centers_gives_the_same_layout(data, jindex):
    db, _ = data
    centers = np.asarray(jindex.centers)
    jp = jivf.IndexParams(n_lists=16, list_pad_expansion=1.05)
    tp = tivf.IndexParams(n_lists=16, list_pad_expansion=1.05)
    half = len(db) // 2
    j = jivf.extend(jivf.Index(jp, jindex.centers, None, None, None, 0),
                    db[:half])
    j = jivf.extend(j, db[half:])
    t = tivf.extend(tivf.Index(tp, torch.from_numpy(centers.copy()), None, None, None,
                               0), db[:half])
    t = tivf.extend(t, db[half:])
    for name in ("list_sizes", "list_indices", "list_data", "overflow_indices",
                 "overflow_data"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    assert t.size == j.size == len(db)


def test_extend_takes_res_as_the_compactor_calls_it(data, jindex):
    """raft_tpu's Compactor extends a base with ``new_indices=`` and
    ``res=`` (neighbors/mutable.py): the port takes the same call and gives
    the same layout; a ``res`` on another device is refused."""
    from raft_tpu.core.resources import Resources as JResources
    from raft_tpu_torch.core.resources import Resources

    db, _ = data
    j, t = _with_metric(jindex, "sqeuclidean")
    ids = np.arange(10_000, 10_000 + 200, dtype=np.int32)
    want = jivf.extend(j, db[:200], new_indices=ids, res=JResources(seed=0))
    got = tivf.extend(t, db[:200], new_indices=ids,
                      res=Resources(device="cpu", seed=0))
    for name in ("list_sizes", "list_indices", "list_data",
                 "overflow_indices", "overflow_data"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.size == want.size

    class Elsewhere:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="disagrees"):
        tivf.extend(t, db[:4], res=Elsewhere())


def test_build_recall_within_002_of_jax():
    # clustered data of low intrinsic dimension (the benchmark generator) at
    # recall ~0.93-0.96, where 2000 query-neighbour pairs resolve 0.02
    rows = low_rank_clusters(np.random.default_rng(31), 3200, 32)
    db, q = rows[:3000], rows[3000:]
    d = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    gt = torch.from_numpy(np.argsort(d, axis=1, kind="stable")[:, :10])
    j = jivf.build(db, jivf.IndexParams(n_lists=16))
    t = tivf.build(db, tivf.IndexParams(n_lists=16), device="cpu")
    assert int(t.list_sizes.sum()) + int((t.overflow_indices >= 0).sum()) \
        == len(db)
    for n_probes in (3, 4):
        _, ji = jivf.search(j, q, 10, jivf.SearchParams(n_probes=n_probes))
        _, ti = tivf.search(t, q, 10, tivf.SearchParams(n_probes=n_probes))
        j_rec = float(neighborhood_recall(torch.from_numpy(np.array(ji)), gt))
        t_rec = float(neighborhood_recall(ti, gt))
        assert abs(t_rec - j_rec) <= 0.02, (n_probes, t_rec, j_rec)


def test_kmeans_fit_is_balanced_and_seeded(data):
    db, _ = data
    x = torch.from_numpy(db)
    c1 = tkm.fit(torch.Generator().manual_seed(0), x, 16)
    c2 = tkm.fit(torch.Generator().manual_seed(0), x, 16)
    assert torch.equal(c1, c2)
    sizes = np.bincount(tkm.predict(c1, x).numpy(), minlength=16)
    assert sizes.min() > 0 and sizes.std() / sizes.mean() < 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_list_packing_rules_match_jax(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 12, 500)
    labels[:80] = 3  # one hot list
    sizes = np.bincount(labels, minlength=12)
    for expansion in (1.01, 1.5):
        assert tlp.choose_list_pad(sizes, expansion) == \
            jlp.choose_list_pad(sizes, expansion)
    np.testing.assert_array_equal(tlp.fit_mask(labels, 12, 40),
                                  jlp.fit_mask(labels, 12, 40))
    np.testing.assert_array_equal(
        tlp.fit_mask(labels, 12, 40, sizes=sizes // 2),
        jlp.fit_mask(labels, 12, 40, sizes=sizes // 2))
    rows = rng.standard_normal((13, 4)).astype(np.float32)
    ids = np.arange(13, dtype=np.int32)
    for a, b in zip(tlp.pad_overflow_block(rows, ids),
                    jlp.pad_overflow_block(rows, ids)):
        np.testing.assert_array_equal(a, b)


def test_grow_pad_and_append_lists_match_jax():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((4, 8, 3)).astype(np.float32)
    idxs = np.full((4, 8), -1, np.int32)
    sizes = np.array([2, 0, 5, 1], np.int32)
    new_rows = rng.standard_normal((9, 3)).astype(np.float32)
    new_ids = np.arange(100, 109, dtype=np.int32)
    labels = rng.integers(0, 4, 9).astype(np.int32)
    jd, ji = jlp.grow_pad(data, idxs, 14)
    td, ti = tlp.grow_pad(torch.from_numpy(data), torch.from_numpy(idxs), 14)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    want = jlp.append_lists(jd, ji, sizes, new_rows, new_ids, labels, 4)
    got = tlp.append_lists(td, ti, torch.from_numpy(sizes),
                           torch.from_numpy(new_rows), torch.from_numpy(new_ids),
                           torch.from_numpy(labels), 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_deferred_pieces_raise(data, jindex):
    db, q = data
    _, t = _with_metric(jindex, "sqeuclidean")
    with pytest.raises(NotImplementedError, match="fast scan"):
        tivf.search(t, q, 5, tivf.SearchParams(scan_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="int8"):
        tivf.build(db.astype(np.int8), tivf.IndexParams(n_lists=4),
                   device="cpu")
    with pytest.raises(ValueError, match="scan_mode"):
        tivf.search(t, q, 5, tivf.SearchParams(scan_mode="mosaic"))


def test_cpu_search_launches_no_kernel(data, jindex):
    _, q = data
    _, t = _with_metric(jindex, "sqeuclidean")
    gk.reset_launch_counts()
    tivf.search(t, q, 10)
    assert sum(gk.LAUNCHES.values()) == 0


# ------------------------------------------------------ the unfused scan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rot", [8, 100])
def test_plain_ivf_scan_matches_pallas_interpret(dtype, rot):
    from raft_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(rot)
    L, pad, nq, P = 6, 40, 5, 3
    data = rng.standard_normal((L, pad, rot)).astype(np.float32)
    data_t = torch.from_numpy(data).to(getattr(torch, dtype))
    norms = (data_t.float() ** 2).sum(-1)
    probes = rng.integers(0, L, (nq, P)).astype(np.int32)
    qres = rng.standard_normal((nq, P, rot)).astype(np.float32)
    want = pk.ivf_scan(probes, qres, jnp.asarray(data_t.float().numpy()).astype(
        getattr(jnp, dtype)), norms.numpy(), interpret=True)
    got = gk.ivf_scan(torch.from_numpy(probes), torch.from_numpy(qres),
                      data_t, norms)
    assert got.shape == (nq, P, pad) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4 * float(norms.max()))


def test_plain_ivf_scan_writes_inf_for_a_probe_out_of_range():
    data = torch.randn(3, 5, 4, generator=torch.Generator().manual_seed(0))
    norms = (data ** 2).sum(-1)
    probes = torch.tensor([[0, 3], [-1, 2]], dtype=torch.int32)
    got = gk.ivf_scan(probes, torch.ones(2, 2, 4), data, norms)
    assert torch.isinf(got[0, 1]).all() and torch.isinf(got[1, 0]).all()
    torch.testing.assert_close(got[1, 1], norms[2] - 2.0 * data[2].sum(-1))


def _jax_scan_search(j, q, k, n_probes, mask=None):
    """JAX's tiled search through its unfused scan kernel (``use_pallas``) in
    interpret mode, one query tile."""
    words = (JBitset.from_mask(mask).words if mask is not None
             else jnp.zeros((0,), jnp.uint32))
    return jivf.search_core(
        q, j.centers, j.list_data, j.list_indices, j.list_sizes, words,
        j.metric, k, n_probes, q.shape[0], mask is not None,
        row_norms=j.ensure_row_norms(), use_pallas=True,
        pallas_interpret=True, overflow_data=j.overflow_data,
        overflow_indices=j.overflow_indices,
        has_overflow=j.overflow_data.shape[0] > 0)


_SCAN_CASES = [("filter", "sqeuclidean", 10), ("filter", "euclidean", 10),
               ("filter", "inner_product", 10), (None, "inner_product", 10),
               (None, "cosine", 10), (None, "sqeuclidean", 1100),
               ("filter", "cosine", 1100)]


@pytest.mark.parametrize("filt,metric,k", _SCAN_CASES)
def test_auto_route_scans_like_jax_use_pallas(data, jindex, monkeypatch,
                                              filt, metric, k):
    db, q = data
    q = q[:8]
    j, t = _with_metric(jindex, metric)
    mask = (np.random.default_rng(23).random(len(db)) < 0.7
            if filt else None)
    want = _jax_scan_search(j, q, k, 6, mask)
    calls = []
    real_scan = gk.ivf_scan
    monkeypatch.setattr(gk, "ivf_scan",
                        lambda *a: calls.append(a[0].shape) or real_scan(*a))
    got = tivf.search(t, q, k, tivf.SearchParams(n_probes=6),
                      filter=(Bitset.from_mask(torch.from_numpy(mask))
                              if filt else None))
    assert calls  # the auto route went through the scan
    assert_topk_close(got, want, _atol(metric, db), 1e-5)
    if filt:  # past the valid candidates both packages return bad-fill slots
        ids, fin = got[1].numpy(), np.isfinite(got[0].numpy())
        assert mask[ids[fin]].all()
    calls.clear()
    tivf.search(t, q, k, tivf.SearchParams(n_probes=6, scan_mode="xla"))
    assert not calls  # the forced tiled path keeps its gather


def test_auto_route_with_overflow_scans_like_jax_use_pallas():
    rng = np.random.default_rng(5)
    db = np.concatenate([
        rng.standard_normal((500, 16)).astype(np.float32),
        rng.standard_normal((150, 16)).astype(np.float32) * 0.05 + 2.0])
    q = rng.standard_normal((9, 16)).astype(np.float32)
    idx = jivf.build(db, jivf.IndexParams(n_lists=8, list_pad_expansion=1.01))
    assert idx.overflow_data.shape[0] > 0
    j, t = _with_metric(idx, "inner_product")
    want = _jax_scan_search(j, q, 10, 4)
    got = tivf.search(t, q, 10, tivf.SearchParams(n_probes=4))
    assert_topk_close(got, want, _atol("inner_product", db), 1e-5)
