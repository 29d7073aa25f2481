"""raft_tpu_torch's small modules against raft_tpu on the same numpy inputs:
shape helpers, resources, tracing, bitset, distances, select_k (with its
tie order and the graph merges), recall, row subsampling and CAGRA's seed
draw. All on the CPU (``device="cpu"``).

Tolerances: distances rtol 1e-5 and atol 1e-4·max‖x‖² (fp32 sums taken in
another order); selections exact in value and equal in id away from
near-ties (``raft_tpu_torch.testing.assert_topk_close``); on tied inputs,
and for the merges and the seed draw, ids (and flags) exactly equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import bitset as jbitset
from raft_tpu.ops import distance as jdist
from raft_tpu.stats import neighborhood_recall as j_recall
from raft_tpu.utils import shape as jshape
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.bitset import Bitset, filter_mask
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops import distance as tdist
from raft_tpu_torch.ops import rng as trng
from raft_tpu_torch.ops import select_k as tsel
from raft_tpu_torch.stats import neighborhood_recall
from raft_tpu_torch.testing import assert_topk_close
from raft_tpu_torch.utils import shape as tshape

# raft_tpu.ops re-exports the select_k function under the module's name
jsel = importlib.import_module("raft_tpu.ops.select_k")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _data(seed=0, m=37, n=211, d=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _close(got, want, scale):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4 * scale)


# -------------------------------------------------------------------- shape


@pytest.mark.parametrize("total,tile,multiple", [(10000, 10000, 8),
                                                 (10001, 1024, 128),
                                                 (5, 64, 8), (0, 16, 8),
                                                 (999, 7, 8)])
def test_shape_helpers_match(total, tile, multiple):
    assert tshape.balanced_tile(total, tile, multiple) == \
        jshape.balanced_tile(total, tile, multiple)
    assert tshape.round_up_to(total, multiple) == jshape.round_up_to(total,
                                                                      multiple)
    assert tshape.cdiv(total, tile) == jshape.cdiv(total, tile)


def test_as_query_array_moves_and_casts():
    q = tshape.as_query_array(np.zeros((3, 4), np.float64), torch.device("cpu"),
                              torch.float32)
    assert q.dtype == torch.float32 and q.is_contiguous()
    with pytest.raises(ValueError, match=r"\[n, dim\]"):
        tshape.as_query_array(np.zeros(4), torch.device("cpu"))


# ---------------------------------------------------------------- resources


def test_resources_on_cpu():
    res = Resources(device="cpu", seed=3, workspace_limit_bytes=1 << 20)
    assert res.device.type == "cpu"
    assert res.workspace_limit_bytes == 1 << 20
    assert Resources(device="cpu").workspace_limit_bytes == 2 << 30
    a = torch.randint(0, 1000, (8,), generator=res.generator)
    b = torch.randint(0, 1000, (8,),
                      generator=Resources(device="cpu", seed=3).generator)
    assert torch.equal(a, b)
    assert ensure_resources(res) is res
    assert ensure_resources(None, "cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        Resources(device="meta")


def test_tracing_range_as_decorator_and_context():
    @tracing.range("outer")
    def f(x):
        with tracing.range("inner"):
            return x + 1

    assert f(1) == 2
    with pytest.raises(KeyError):
        with tracing.range("raises"):
            raise KeyError("propagates")


# ------------------------------------------------------------------- bitset


def test_bitset_words_match_jax():
    rng = np.random.default_rng(1)
    mask = rng.random(77) < 0.6
    words = Bitset.from_mask(_t(mask)).words
    np.testing.assert_array_equal(
        words.numpy(),
        np.asarray(jbitset.Bitset.from_mask(mask).words).astype(np.int64))
    ids = rng.integers(0, 77, 40)
    np.testing.assert_array_equal(
        filter_mask(_t(ids), words).numpy(),
        np.asarray(jbitset.filter_mask(jnp.asarray(ids),
                                       jbitset.Bitset.from_mask(mask).words)))


def test_bitset_ops():
    b = Bitset.create(70).set([3, 69], value=False)
    assert b.count() == 68 and len(b) == 70
    assert b.test([3, 4, 69]).tolist() == [False, True, False]
    assert b.flip().count() == 2
    assert torch.equal(Bitset.from_mask(b.to_mask()).words, b.words)
    jb = jbitset.Bitset.create(70).set(jnp.asarray([3, 69]), value=False)
    np.testing.assert_array_equal(b.words.numpy(),
                                  np.asarray(jb.words).astype(np.int64))


# ---------------------------------------------------------------- distances


@pytest.mark.parametrize("sqrt", [False, True])
def test_l2_expanded_matches(sqrt):
    x, y = _data()
    scale = float((y ** 2).sum(1).max())
    _close(tdist.l2_expanded(_t(x), _t(y), sqrt),
           jdist.l2_expanded(x, y, sqrt), np.sqrt(scale) if sqrt else scale)
    assert float(tdist.l2_expanded(_t(x), _t(x), False).min()) >= 0.0


def test_cosine_inner_product_and_norms_match():
    x, y = _data(2)
    _close(tdist.cosine_expanded(_t(x), _t(y)), jdist.cosine_expanded(x, y), 1)
    scale = float((y ** 2).sum(1).max())
    _close(tdist.inner_product(_t(x), _t(y)), jdist.inner_product(x, y), scale)
    _close(tdist.row_norms_sq(_t(x)), jdist.row_norms_sq(x), scale)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine",
                                    "inner_product"])
def test_gathered_distances_and_pairwise_match(metric):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    v = rng.standard_normal((6, 9, 16)).astype(np.float32)
    m = tdist.resolve_metric(metric)
    assert int(m) == int(jdist.resolve_metric(metric))
    scale = float((v ** 2).sum(-1).max())
    _close(tdist.gathered_distances(_t(q), _t(v), m),
           jdist.gathered_distances(q, v, jdist.DistanceType(int(m))), scale)
    x, y = _data(4)
    _close(tdist.pairwise_core(_t(x), _t(y), m),
           jdist.pairwise_distance(x, y, metric), scale)


@pytest.mark.parametrize("metric", ["l1", "chebyshev", "canberra"])
def test_unported_metrics_raise(metric):
    x, y = _data()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdist.pairwise_core(_t(x), _t(y), tdist.resolve_metric(metric))


# ----------------------------------------------------------------- select_k


@pytest.mark.parametrize("algo", ["DIRECT", "TWO_PHASE", "PALLAS", "APPROX",
                                  "SCREEN", "AUTO"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_select_k_matches(algo, select_min, k):
    rng = np.random.default_rng(5)
    v = rng.standard_normal((9, 500)).astype(np.float32)
    want_algo = jsel.SelectAlgo.DIRECT if algo in ("APPROX", "SCREEN") \
        else jsel.SelectAlgo[algo]
    want = jsel.select_k(v, k, select_min, algo=want_algo)
    got = tsel.select_k(_t(v), k, select_min, algo=tsel.SelectAlgo[algo])
    assert got[1].dtype == torch.int32
    assert_topk_close(got, want, 0.0, 0.0)


def test_select_k_relabels_and_keeps_null_ids():
    rng = np.random.default_rng(6)
    v = rng.standard_normal((4, 50)).astype(np.float32)
    v[1, 3:] = np.inf
    ids = rng.integers(0, 10**6, (4, 50)).astype(np.int32)
    want = jsel.select_k(v, 6, indices=jnp.asarray(ids),
                         algo=jsel.SelectAlgo.PALLAS)
    got = tsel.select_k(_t(v), 6, indices=_t(ids), algo=tsel.SelectAlgo.PALLAS)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1][1, 3:] == -1).all()
    v1, i1 = tsel.select_k(_t(v[0]), 5, indices=_t(ids[0]))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(
        jsel.select_k(v[0], 5, indices=jnp.asarray(ids[0]))[1]))
    with pytest.raises(ValueError, match="row length"):
        tsel.select_k(_t(v), 51)


@pytest.mark.parametrize("n,k", [(100, 30), (70000, 10), (70000, 300),
                                 (200000, 512)])
def test_select_k_auto_resolution_matches_default_table(n, k):
    jsel.set_auto_table("cpu", None)  # fall back to the JAX default table
    try:
        want = jsel._resolve_auto(n, k)
    finally:
        jsel._auto_table_cache = None
    assert tsel._resolve_auto(n, k).name == want.name


def test_refine_multiplier_and_maybe_approx():
    assert tsel.refine_multiplier(4.4, True) == jsel.refine_multiplier(4.4, True)
    assert tsel.refine_multiplier(4.4, False) == 1
    v = np.random.default_rng(7).standard_normal((3, 40)).astype(np.float32)
    got = tsel.select_k_maybe_approx(_t(v), 5, True, 0.9)
    assert_topk_close(got, jsel.select_k(v, 5), 0.0, 0.0)


# ------------------------------------------------------------ recall / rng


def test_neighborhood_recall_matches():
    rng = np.random.default_rng(8)
    ref = rng.integers(0, 50, (20, 5))
    got = ref.copy()
    got[:7, 0] = 99
    dist = rng.random((20, 5)).astype(np.float32)
    ref_d = dist.copy()
    ref_d[:3, 0] += 1e-4
    assert float(neighborhood_recall(_t(got), _t(ref))) == pytest.approx(
        float(j_recall(got, ref)))
    assert float(neighborhood_recall(_t(got), _t(ref), _t(dist), _t(ref_d))) \
        == pytest.approx(float(j_recall(got, ref, dist, ref_d)))


def test_subsample_rows_uniform_distinct_ordered():
    x = torch.arange(1000, dtype=torch.float32)[:, None].repeat(1, 3)
    g = torch.Generator().manual_seed(0)
    s = trng.subsample_rows(g, x, 100)
    assert s.shape == (100, 3)
    rows = s[:, 0]
    assert torch.equal(rows, torch.sort(rows).values)
    assert rows.unique().numel() == 100
    assert trng.subsample_rows(g, x, 5000) is x


@pytest.mark.parametrize("algo", ["DIRECT", "TWO_PHASE"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("n", [3000, 200_000])
def test_select_k_ties_resolve_as_jax(algo, select_min, n):
    # integer-valued rows: every value is tied many times, so the order of
    # the ties and the members at the k-th value are all that is tested
    rng = np.random.default_rng(9)
    v = rng.integers(0, 4, (8, n)).astype(np.float32)
    v[1, :40] = np.inf
    v[2, 7:9] = -0.0
    v[2, -2:] = -0.0  # beyond the k lowest +0.0s: the sign decides
    # rows without a tie at the k-th place (the single selection's path),
    # one with both zeros among its members
    v[5] = rng.permutation(n).astype(np.float32)
    v[6] = -v[5]
    v[6, [3, 11]] = [-0.0, 0.0]
    want = jsel.select_k(v, 20, select_min, algo=jsel.SelectAlgo[algo])
    got = tsel.select_k(_t(v), 20, select_min, algo=tsel.SelectAlgo[algo])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  np.asarray(want[0]).view(np.int32))


def _merge_rows(seed=10, b=7, m=60):
    """Rows with duplicate ids, -1 ids, +inf distances and tied finite
    distances."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 25, (b, m)).astype(np.int32)
    d = rng.integers(0, 6, (b, m)).astype(np.float32)
    d[:, m - 12:] = np.inf
    d[3] = np.inf
    flags = rng.random((b, m)) < 0.3
    return ids, d, flags


@pytest.mark.parametrize("k", [5, 24, 70])
def test_merge_topk_dedup_matches_jax_exactly(k):
    ids, d, _ = _merge_rows()
    own = np.arange(ids.shape[0], dtype=np.int32)
    if k > ids.shape[1]:  # JAX needs k <= m; the port pads with (-1, inf)
        ids = np.pad(ids, ((0, 0), (0, k - ids.shape[1])), constant_values=-1)
        d = np.pad(d, ((0, 0), (0, k - d.shape[1])), constant_values=np.inf)
    wi, wd = jsel.merge_topk_dedup(jnp.asarray(ids), jnp.asarray(d), k,
                                   exclude_ids=jnp.asarray(own))
    gi, gd = tsel.merge_topk_dedup(_t(ids), _t(d), k, exclude_ids=_t(own))
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("k", [5, 24, 60])
def test_merge_topk_dedup_flagged_matches_jax_exactly(k):
    ids, d, flags = _merge_rows(11)
    wi, wd, wf = jsel.merge_topk_dedup_flagged(
        jnp.asarray(ids), jnp.asarray(d), jnp.asarray(flags), k)
    gi, gd, gf = tsel.merge_topk_dedup_flagged(_t(ids), _t(d), _t(flags), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    assert not bool(gf[gi < 0].any())


@pytest.mark.parametrize("size", [3000, 1_000_000])
@pytest.mark.parametrize("mask", [0x128394, 0x7EADBEEF])
def test_cagra_seed_offsets_bitwise_equal_to_jax(size, mask):
    # raft_tpu.neighbors.cagra.search's draw: randint(fold_in(key(mask),
    # row), (), 0, size) per row
    key = jax.random.key(mask & 0x7FFFFFFF)
    want = jax.vmap(lambda row: jax.random.randint(
        jax.random.fold_in(key, row), (), 0, size, jnp.int32))(
        jnp.arange(10_000, dtype=jnp.uint32))
    got = trng.cagra_seed_offsets(mask, 10_000, size)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
