"""The rest of the families' public surface in raft_tpu_torch against
raft_tpu, on the CPU, on the same inputs.

- ``select_k_filtered``: values, ids and ``n_filtered`` equal (random
  values, no ties); ``select_k``'s ``recall_target`` (exact in the port)
  and ``pad_rules`` (a selection of k' >= k cut to k is exact) give
  raft_tpu's selection.
- ``select_k_plan`` equal once both packages hold the same crossover table
  and k-pad rules for the platform (``set_auto_table``, ``set_pad_rules``),
  and back to each package's own default once they are dropped.
- ``ivf_flat.helpers`` and ``ivf_pq.helpers``: unpacked lists equal, and a
  list packed again searches as raft_tpu's packed index does (IVF-Flat:
  ids equal, distances rtol 1e-5, atol 1e-4·max‖x‖²) or holds the same
  codes (IVF-PQ); ``reconstruct_list_data`` rtol 1e-5, atol 1e-5·max|x|.
- ``kmeans_balanced.fit_predict`` with the centres injected into both
  packages' ``fit``: labels equal.
- ``brute_force.make_batch_k_query``: the batches, joined, equal one wide
  search and raft_tpu's batches; ``planned_peak_bytes`` equal numbers.
- ``ops.rng``: jax.random streams cannot be replayed in torch, so each draw
  is held to its law (moments within 5 standard errors, or a
  Kolmogorov-Smirnov test at p > 1e-3 with scipy) and to its determinism
  per seed.
"""

import importlib

import numpy as np
import pytest
import torch
from scipy import stats as sstats

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import interop
from raft_tpu_torch import ops as tops
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.ops import rng as trng
from raft_tpu_torch.testing import assert_topk_close

jsel = importlib.import_module("raft_tpu.ops.select_k")
tsel = importlib.import_module("raft_tpu_torch.ops.select_k")
jkb = importlib.import_module("raft_tpu.cluster.kmeans_balanced")


@pytest.fixture(scope="module")
def rows():
    x = low_rank_clusters(np.random.default_rng(51), 2100, 16)
    return x[:2000], x[2000:]


# ---------------------------------------------------------------- select_k


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("shared_ids", [False, True])
def test_select_k_filtered_matches_jax(select_min, shared_ids):
    rng = np.random.default_rng(52)
    b, n, k = 6, 300, 12
    v = rng.standard_normal((b, n)).astype(np.float32)
    v[:, ::17] = np.inf if select_min else -np.inf
    ids = (rng.permutation(n).astype(np.int32) if shared_ids
           else rng.integers(0, 400, (b, n)).astype(np.int32))
    if shared_ids:
        ids[::23] = -1
    else:
        ids[:, ::23] = -1
    mask = rng.random(400) < 0.6
    jv, ji, jn = jsel.select_k_filtered(v, k, ids, JBitset.from_mask(mask)
                                        .words, select_min=select_min)
    tv, ti, tn = tops.select_k_filtered(
        torch.from_numpy(v), k, torch.from_numpy(ids),
        Bitset.from_mask(torch.from_numpy(mask)).words,
        select_min=select_min)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tn.dtype == torch.int32 and tn.dim() == 0
    assert int(tn) == int(jn) > 0
    sel = ti.numpy()
    assert mask[sel[sel >= 0]].all()


@pytest.mark.parametrize("recall_target", [0.5, 0.95])
@pytest.mark.parametrize("pad_rules", [True, False])
def test_select_k_keywords_select_as_jax(recall_target, pad_rules):
    v = np.random.default_rng(53).standard_normal((5, 4096)).astype(
        np.float32)
    want = jsel.select_k(v, 10, recall_target=recall_target,
                         pad_rules=pad_rules)
    got = tsel.select_k(torch.from_numpy(v), 10, recall_target=recall_target,
                        pad_rules=pad_rules)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


_TABLE = {"two_phase": {"32": 8192, "inf": 65536}, "screen": {"16": 2048}}
_RULES = [{"n": 4096, "k": 10, "k_pad": 32}, {"n": 2000, "k": 7, "k_pad": 7}]
_PLANS = [(4096, 10, True, True), (5000, 10, True, True),
          (4096, 10, True, False), (3000, 16, True, True),
          (3000, 16, False, True), (10000, 32, True, True),
          (100000, 100, True, True), (30, 10, True, True), (2000, 7, True,
                                                            True)]


def test_select_k_plan_and_tables_match_jax():
    before = [tsel.select_k_plan(n, k, f, p, device="cpu")
              for n, k, f, p in _PLANS]
    try:
        jsel.set_auto_table("cpu", _TABLE)
        jsel.set_pad_rules("cpu", _RULES)
        tsel.set_auto_table("cpu", _TABLE)
        tsel.set_pad_rules("cpu", _RULES)
        assert tsel._INSTALLED
        for n, k, floating, pad in _PLANS:
            assert tsel.select_k_plan(n, k, floating, pad, device="cpu") == \
                jsel.select_k_plan(n, k, floating, pad), (n, k, floating, pad)
        # a padded selection is still raft_tpu's selection
        v = np.random.default_rng(54).standard_normal((4, 4096)).astype(
            np.float32)
        for algo in ("DIRECT", "AUTO"):
            want = jsel.select_k(v, 10, algo=getattr(jsel.SelectAlgo, algo))
            got = tsel.select_k(torch.from_numpy(v), 10,
                                algo=getattr(tsel.SelectAlgo, algo))
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))
    finally:
        tsel.set_auto_table("cpu", None)
        tsel.set_pad_rules("cpu", None)
        jsel._auto_table_cache = None
        jsel._pad_rules_cache = None
    after = [tsel.select_k_plan(n, k, f, p, device="cpu")
             for n, k, f, p in _PLANS]
    assert after == before  # dropped: the port's default again
    # with nothing installed select_k skips the parsing: its shortcut
    # resolves as the default table does
    assert not tsel._INSTALLED
    for n, k, floating, _ in _PLANS + [(200000, 300, True, True)]:
        assert tsel._resolve_default(n, k).name == tsel._resolve_auto(
            n, k, floating, "cpu").name
    assert tsel.platform_key("cpu") == "cpu"
    assert tsel.platform_key(torch.device("cuda", 0)) == "cuda"


# ----------------------------------------------------------------- helpers


def test_ivf_flat_helpers_round_trip_as_jax(rows):
    db, q = rows
    j = jivf.build(db, jivf.IndexParams(n_lists=8), res=JResources(seed=5))
    assert j.overflow_data.shape[0] == 0
    t = interop.ivf_flat_index_from_numpy(
        tivf.IndexParams(n_lists=8), *(np.asarray(a) for a in (
            j.centers, j.list_data, j.list_indices, j.list_sizes)), j.n_rows,
        np.asarray(j.overflow_data), np.asarray(j.overflow_indices),
        device="cpu")
    for label in (0, 5):
        np.testing.assert_array_equal(tivf.helpers.unpack_list_data(t, label),
                                      jivf.helpers.unpack_list_data(j, label))
        np.testing.assert_array_equal(tivf.helpers.unpack_list_ids(t, label),
                                      jivf.helpers.unpack_list_ids(j, label))
    rows3 = jivf.helpers.unpack_list_data(j, 3)[:-5] * 1.5
    ids3 = np.arange(50000, 50000 + len(rows3), dtype=np.int32)
    j2 = jivf.helpers.pack_list_data(j, 3, rows3, ids3)
    t2 = tivf.helpers.pack_list_data(t, 3, rows3, ids3)
    assert t2.n_rows == j2.n_rows == j.n_rows - 5
    np.testing.assert_array_equal(t2.list_data.numpy(),
                                  np.asarray(j2.list_data))
    np.testing.assert_array_equal(t2.list_indices.numpy(),
                                  np.asarray(j2.list_indices))
    want = jivf.search(j2, q, 10, jivf.SearchParams(n_probes=3,
                                                    scan_mode="xla"))
    got = tivf.search(t2, q, 10, tivf.SearchParams(n_probes=3))
    assert_topk_close(got, want, 1e-4 * float((db ** 2).sum(1).max()), 1e-5)
    with pytest.raises(ValueError, match="capacity"):
        tivf.helpers.pack_list_data(t, 0, np.zeros((t.list_data.shape[1] + 1,
                                                    16), np.float32))


@pytest.mark.parametrize("kind", ["PER_SUBSPACE", "PER_CLUSTER"])
def test_ivf_pq_helpers_round_trip_as_jax(rows, kind):
    db, _ = rows
    j = jpq.build(db, jpq.IndexParams(
        n_lists=8, pq_dim=8, pq_bits=6,
        codebook_kind=getattr(jpq.CodebookGen, kind)), res=JResources(seed=6))
    t = interop.ivf_pq_index_from_numpy(
        tpq.IndexParams(n_lists=8, pq_dim=8, pq_bits=6,
                        codebook_kind=int(j.params.codebook_kind)),
        j.pq_dim, *(np.asarray(a) for a in (
            j.centers, j.rotation, j.codebooks, j.list_codes, j.list_indices,
            j.list_sizes)), j.n_rows, *(np.asarray(a) for a in (
                j.overflow_codes, j.overflow_labels, j.overflow_indices)),
        device="cpu")
    for label in (0, 7):
        codes = tpq.helpers.unpack_list_codes(t, label)
        assert codes.dtype == np.uint8
        np.testing.assert_array_equal(codes,
                                      jpq.helpers.unpack_list_codes(j, label))
        np.testing.assert_allclose(
            tpq.helpers.reconstruct_list_data(t, label),
            jpq.helpers.reconstruct_list_data(j, label), rtol=1e-5,
            atol=1e-5 * float(np.abs(db).max()))
    codes = jpq.helpers.unpack_list_codes(j, 2)[::-1][:-3]
    ids = np.arange(9000, 9000 + len(codes), dtype=np.int32)
    j2 = jpq.helpers.pack_list_codes(j, 2, codes, ids)
    t2 = tpq.helpers.pack_list_codes(t, 2, codes, ids)
    assert t2.n_rows == j2.n_rows
    np.testing.assert_array_equal(t2.list_codes.numpy(),
                                  np.asarray(j2.list_codes))
    np.testing.assert_array_equal(t2.list_indices.numpy(),
                                  np.asarray(j2.list_indices))
    np.testing.assert_array_equal(tpq.helpers.unpack_list_codes(t2, 2), codes)


# ------------------------------------------------------------ fit_predict


def test_kmeans_balanced_fit_predict_labels_from_injected_centres(
        rows, monkeypatch):
    db, _ = rows
    centres = db[np.random.default_rng(55).choice(len(db), 12,
                                                  replace=False)]
    monkeypatch.setattr(jkb, "fit", lambda *a, **kw: centres)
    monkeypatch.setattr(tkb, "fit",
                        lambda *a, **kw: torch.from_numpy(centres))
    jc, jl = jkb.fit_predict(None, db, 12)
    tc, tl = tkb.fit_predict(torch.Generator(), torch.from_numpy(db), 12)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# ------------------------------------------------------------ brute force


def test_make_batch_k_query_matches_one_search_and_jax(rows):
    db, q = rows
    db, q = db[:500], q[:20]
    t = tbf.build(db, metric="sqeuclidean", device="cpu")
    j = jbf.build(db, metric="sqeuclidean")
    it = tbf.make_batch_k_query(t, q, batch_size=7)
    jit_ = jbf.make_batch_k_query(j, q, batch_size=7)
    batches, jbatches = [], []
    for _ in range(5):
        d, i = next(it)
        assert i.shape == (20, 7)
        batches.append(i.numpy())
        jbatches.append(np.asarray(next(jit_)[1]))
    wide = tbf.search(t, q, 35)[1].numpy()
    np.testing.assert_array_equal(np.concatenate(batches, 1), wide)
    np.testing.assert_array_equal(np.concatenate(batches, 1),
                                  np.concatenate(jbatches, 1))
    rest = sum(b.shape[1] for _, b in it)  # the iterator ends at the dataset
    assert 35 + rest == len(db)
    with pytest.raises(ValueError, match="batch_size"):
        next(tbf.make_batch_k_query(t, q, batch_size=0))


@pytest.mark.parametrize("args", [(19, 700, 128, 10, 2 << 30),
                                  (10000, 10 ** 6, 128, 10, 1 << 30),
                                  (5, 50, 16, 3, 1000),
                                  (4096, 250000, 96, 64, 256 << 20)])
def test_planned_peak_bytes_matches_jax(args):
    assert tbf.planned_peak_bytes(*args) == jbf.planned_peak_bytes(*args)


# ------------------------------------------------------------------- rng


N = 40000


def _moments(x, mean, var):
    """Sample mean within 5 standard errors, variance within 10%."""
    x = x.double().flatten()
    assert abs(float(x.mean()) - mean) <= 5 * np.sqrt(var / x.numel())
    assert abs(float(x.var()) - var) <= 0.1 * var


_LAWS = {
    "uniform": (lambda k: trng.uniform(k, (N,), -2.0, 3.0, device="cpu"),
                ("uniform", (-2.0, 5.0))),
    "normal": (lambda k: trng.normal(k, (N,), 1.5, 2.0, device="cpu"),
               ("norm", (1.5, 2.0))),
    "laplace": (lambda k: trng.laplace(k, (N,), -1.0, 0.5, device="cpu"),
                ("laplace", (-1.0, 0.5))),
    "gumbel": (lambda k: trng.gumbel(k, (N,), 0.5, 2.0, device="cpu"),
               ("gumbel_r", (0.5, 2.0))),
    "lognormal": (lambda k: trng.lognormal(k, (N,), 0.2, 0.5, device="cpu"),
                  ("lognorm", (0.5, 0, np.exp(0.2)))),
    "exponential": (lambda k: trng.exponential(k, (N,), 2.5, device="cpu"),
                    ("expon", (0, 1 / 2.5))),
    "rayleigh": (lambda k: trng.rayleigh(k, (N,), 1.7, device="cpu"),
                 ("rayleigh", (0, 1.7))),
}


@pytest.mark.parametrize("name", sorted(_LAWS))
def test_rng_distribution_laws_and_determinism(name):
    draw, (law, params) = _LAWS[name]
    x = draw(trng.RngState(7))
    assert x.dtype == torch.float32 and x.shape == (N,)
    assert sstats.kstest(x.double().numpy(), law, args=params).pvalue > 1e-3
    assert torch.equal(x, draw(trng.RngState(7)))  # the same seed
    assert torch.equal(x, draw(7))                 # an int is a seed
    assert not torch.equal(x, draw(trng.RngState(7).advance()))


@pytest.mark.parametrize("draw", [
    lambda d: trng.uniform(7, (4,), device=d),
    lambda d: trng.RngState(7).generator(d),
    lambda d: trng.make_blobs(7, 10, 2, device=d),
    lambda d: trng.multi_variable_gaussian(7, [0.0, 1.0], [[1.0, 0.0],
                                                           [0.0, 1.0]], 5,
                                           device=d)])
def test_rng_draws_on_the_card_unless_asked(draw, monkeypatch):
    """No device means the card, as everywhere in the port: with no card
    it raises instead of drawing on the CPU; a CPU generator as the key
    keeps its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        draw(None)
    draw("cpu")
    g = trng.RngState(7).generator("cpu")
    assert trng.uniform(g, (4,)).device.type == "cpu"


def test_rng_bernoulli_permute_and_sample():
    b = trng.bernoulli(3, (N,), 0.3, device="cpu")
    assert b.dtype == torch.bool
    _moments(b.float(), 0.3, 0.21)
    p = trng.permute(trng.RngState(4), 1000, device="cpu")
    assert torch.equal(torch.sort(p).values, torch.arange(1000))
    assert torch.equal(p, trng.permute(trng.RngState(4), 1000, device="cpu"))
    s = trng.sample_without_replacement(5, 10000, 300, device="cpu")
    assert s.shape == (300,) and torch.unique(s).numel() == 300
    assert int(s.min()) >= 0 and int(s.max()) < 10000
    # uniform over the population: each decile draws about a tenth
    counts = torch.bincount(
        trng.sample_without_replacement(6, 10000, 5000, device="cpu") // 1000,
        minlength=10).numpy()
    assert sstats.chisquare(counts).pvalue > 1e-3
    with pytest.raises(ValueError):
        trng.sample_without_replacement(5, 10, 11, device="cpu")


def test_rng_make_blobs_by_its_law():
    x, labels, centers = trng.make_blobs(8, 30000, 3, n_clusters=4,
                                         cluster_std=0.7,
                                         center_box=(-5.0, 5.0),
                                         return_centers=True, device="cpu")
    assert x.shape == (30000, 3) and labels.dtype == torch.int32
    assert bool(((centers >= -5) & (centers <= 5)).all())
    for c in range(4):
        members = x[labels == c]
        assert abs(members.shape[0] / 30000 - 0.25) < 0.02
        _moments(members[:, 0] - centers[c, 0], 0.0, 0.49)
    again = trng.make_blobs(8, 30000, 3, n_clusters=4, cluster_std=0.7,
                            center_box=(-5.0, 5.0), device="cpu")
    assert torch.equal(x, again[0]) and torch.equal(labels, again[1])


def test_rng_make_regression_by_its_law():
    x, y, coef = trng.make_regression(9, 5000, 6, n_informative=3,
                                      noise=0.0, bias=2.0, device="cpu")
    assert bool((coef[3:] == 0).all()) and bool((coef[:3] >= 0).all())
    assert bool((coef[:3] < 100).all())
    torch.testing.assert_close(y, x @ coef + 2.0)
    _moments(x, 0.0, 1.0)
    _, y2, _ = trng.make_regression(9, 5000, 6, n_informative=3, noise=0.5,
                                    bias=2.0, device="cpu")
    _moments(y2 - (x @ coef + 2.0), 0.0, 0.25)


def test_rng_rmat_by_its_law():
    theta = (0.57, 0.19, 0.19, 0.05)
    e = trng.rmat(10, 6, 4, 50000, theta, device="cpu")
    assert e.shape == (50000, 2) and e.dtype == torch.int32
    assert int(e[:, 0].max()) < 2 ** 6 and int(e[:, 1].max()) < 2 ** 4
    # the top level: src's top bit set with P(c) + P(d), dst's (where the
    # columns take a bit at that level) never above its own scale
    top_src = (e[:, 0] >> 5) & 1
    _moments(top_src.float(), 0.24, 0.24 * 0.76)
    # a column bit at a level both sides share: P(b) + P(d)
    low_dst = e[:, 1] & 1
    _moments(low_dst.float(), 0.24, 0.24 * 0.76)
    assert torch.equal(e, trng.rmat(10, 6, 4, 50000, theta, device="cpu"))


def test_rng_multi_variable_gaussian_by_its_law():
    mean = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    a = torch.tensor([[1.0, 0.0, 0.0], [0.5, 1.2, 0.0], [-0.3, 0.2, 0.8]],
                     dtype=torch.float64)
    cov = a @ a.T
    x = trng.multi_variable_gaussian(11, mean, cov, 60000,
                                      device="cpu")
    assert x.shape == (60000, 3) and x.dtype == torch.float64
    torch.testing.assert_close(x.mean(0), mean, atol=0.03, rtol=0)
    torch.testing.assert_close(torch.cov(x.T), cov, atol=0.05, rtol=0)
    assert torch.equal(x, trng.multi_variable_gaussian(11, mean, cov, 60000,
                                      device="cpu"))


# ------------------------------------------------- the packages' surface

#: names raft_tpu exports that the port does not yet, by subpackage: none
#: since ROADMAP Queue A item 14b
QUEUE_A_HOLDS = {}
#: names only the port exports: the carry-over helpers, the file format's
#: error, the elastic restores' classes and the host channel's drain error
PORT_ONLY = {"": {"interop"}, "core": {"IntegrityError", "errors"},
             "parallel": {"ElasticIvfFlat", "ElasticIvfPq", "PeerDrained",
                          "SearchResult"}}


@pytest.mark.parametrize("name", ["", "bench", "cluster", "core",
                                  "neighbors", "obs", "ops", "parallel",
                                  "planner", "serving", "sparse", "stats",
                                  "utils"])
def test_package_all_matches_jax_less_queue_a(name):
    suffix = "." + name if name else ""
    jpkg = importlib.import_module("raft_tpu" + suffix)
    tpkg = importlib.import_module("raft_tpu_torch" + suffix)
    want = (set(jpkg.__all__) - QUEUE_A_HOLDS.get(name, set())) | \
        PORT_ONLY.get(name, set())
    assert set(tpkg.__all__) == want
    assert QUEUE_A_HOLDS.get(name, set()) <= set(jpkg.__all__)
    for attr in tpkg.__all__:
        assert hasattr(tpkg, attr), attr


def test_ops_select_k_is_the_function():
    import raft_tpu.ops as jops

    v = np.random.default_rng(4).standard_normal((5, 300)).astype(np.float32)
    got = tops.select_k(torch.from_numpy(v), 7)
    want = jops.select_k(v, 7)
    assert torch.equal(got[0], torch.from_numpy(np.array(want[0])))
    assert torch.equal(got[1].long(), torch.from_numpy(
        np.array(want[1])).long())
    assert tops.SelectAlgo.PALLAS.name == "PALLAS"
    assert callable(tops.pairwise_distance) and callable(tops.select_k)
