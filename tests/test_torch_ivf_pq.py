"""raft_tpu_torch's IVF-PQ path against raft_tpu's, on the CPU.

Search is held on identical state: the JAX package builds the index and
``interop.ivf_pq_index_from_numpy`` carries it over. The JAX fused LUT kernel
cannot run in this JAX (``pl.load`` is gone), so the port's fused LUT engine
(the plain version of fused_pq_topk) is held against JAX's XLA LUT engine,
and its fused cache engine against JAX's XLA cache engine (and once against
the JAX fused cache kernel in interpret mode); the plain fused_pq_topk is
held against the numpy ADC loop of raft_tpu's kernel test. The unfused
engines are held against JAX's with the same forced ``scan_mode``. Builds
cannot match bit for bit (jax.random and torch draw different numbers), so
the build is held by injected state (encoding at JAX-trained centers,
rotation and codebooks; the packed layout of an extend into them) and by
recall against the exact neighbours.

Tolerances: distances rtol 1e-5 and atol 1e-4·(the largest squared norm of
the data) (for L2Sqrt its square root), for bf16 and fp8 LUTs and bf16
distances too: both packages round the same float32 LUT entries to the
same format, so only the float32 summation order differs; ids equal away
from near-ties, near-ties as sets, and at least 95% of ids equal; codes
bitwise; build recall within 0.02 of the JAX build's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.core.resources import solve_joint_tiles as j_solve_joint_tiles
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jref
from raft_tpu_torch import interop
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.core.resources import solve_joint_tiles
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.stats import neighborhood_recall
from raft_tpu_torch.testing import assert_topk_close

jkm = importlib.import_module("raft_tpu.cluster.kmeans_balanced")


@pytest.fixture(scope="module")
def data():
    # clustered rows of low intrinsic dimension (the benchmark generator)
    rows = low_rank_clusters(np.random.default_rng(31), 3300, 32)
    return rows[:3000], rows[3000:]


@pytest.fixture(scope="module")
def gt(data):
    db, q = data
    d = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    return torch.from_numpy(np.argsort(d, axis=1, kind="stable")[:, :10])


@pytest.fixture(scope="module")
def jindex(data):
    return jpq.build(data[0], jpq.IndexParams(n_lists=16, pq_dim=16),
                     res=JResources(seed=0))


@pytest.fixture(scope="module")
def jper_cluster(data):
    return jpq.build(data[0], jpq.IndexParams(
        n_lists=16, pq_dim=16, codebook_kind=jpq.CodebookGen.PER_CLUSTER),
        res=JResources(seed=0))


@pytest.fixture(scope="module")
def jbits5(data):
    return jpq.build(data[0], jpq.IndexParams(n_lists=16, pq_dim=16,
                                              pq_bits=5),
                     res=JResources(seed=0))


@pytest.fixture(scope="module")
def joverflow():
    # a tight pad budget on skewed data forces spill
    rng = np.random.default_rng(5)
    db = np.concatenate([
        rng.standard_normal((600, 16)).astype(np.float32),
        rng.standard_normal((200, 16)).astype(np.float32) * 0.05 + 2.0])
    q = rng.standard_normal((30, 16)).astype(np.float32)
    j = jpq.build(db, jpq.IndexParams(n_lists=8, pq_dim=8,
                                      list_pad_expansion=1.01),
                  res=JResources(seed=0))
    assert j.overflow_codes.shape[0] > 0
    return j, db, q


def _scale(db, metric="sqeuclidean"):
    s = float((db ** 2).sum(1).max())
    return np.sqrt(s) if metric == "euclidean" else s


def _carry(j, metric=None):
    """The JAX index's state (under another metric if asked) in both
    packages."""
    jp = j.params
    metric = jp.metric if metric is None else metric
    jparams = jpq.IndexParams(
        n_lists=jp.n_lists, metric=metric, pq_bits=jp.pq_bits,
        pq_dim=j.pq_dim, codebook_kind=jp.codebook_kind,
        list_pad_expansion=jp.list_pad_expansion)
    jj = jpq.Index(jparams, j.pq_dim, j.centers, j.rotation, j.codebooks,
                   j.list_codes, j.list_indices, j.list_sizes, j.n_rows,
                   j.overflow_codes, j.overflow_labels, j.overflow_indices)
    tparams = tpq.IndexParams(
        n_lists=jp.n_lists, metric=int(jparams.metric), pq_bits=jp.pq_bits,
        pq_dim=j.pq_dim, codebook_kind=int(jp.codebook_kind),
        list_pad_expansion=jp.list_pad_expansion)
    t = interop.ivf_pq_index_from_numpy(
        tparams, j.pq_dim, *(np.asarray(a) for a in (
            j.centers, j.rotation, j.codebooks, j.list_codes, j.list_indices,
            j.list_sizes)), j.n_rows,
        *(np.asarray(a) for a in (j.overflow_codes, j.overflow_labels,
                                  j.overflow_indices)), device="cpu")
    return jj, t


def _lut_res(t):
    """CPU resources whose stated device memory holds the packed codes but
    not the decoded cache: the LUT regime."""
    return Resources(device="cpu",
                     device_memory_bytes=sum(tpq.scan_memory_bytes(t)))


# ------------------------------------------------------------ code packing


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_pack_and_unpack_are_bitwise_jax(pq_bits):
    pq_dim = 24
    codes = np.random.default_rng(pq_bits).integers(
        0, 1 << pq_bits, (300, pq_dim)).astype(np.uint8)
    want = np.asarray(jpq._pack_codes_np(codes, pq_bits))
    np.testing.assert_array_equal(tpq._pack_codes_np(codes, pq_bits), want)
    np.testing.assert_array_equal(
        np.asarray(jpq._pack_codes_jit(jnp.asarray(codes), pq_dim, pq_bits)),
        want)
    got = tpq._pack_codes(torch.from_numpy(codes), pq_dim, pq_bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(tpq._pack_terms(pq_dim, pq_bits),
                    jpq._pack_terms(pq_dim, pq_bits)):
        np.testing.assert_array_equal(a, b)
    unpacked = tpq._unpack_codes(torch.from_numpy(want), pq_dim, pq_bits)
    np.testing.assert_array_equal(unpacked.numpy(), codes)
    np.testing.assert_array_equal(
        unpacked.numpy(),
        np.asarray(jpq._unpack_codes(jnp.asarray(want), pq_dim, pq_bits)))


@pytest.mark.parametrize("dim", [8, 17, 32, 96, 128, 1000])
def test_calc_pq_dim_matches_jax(dim):
    assert tpq._calc_pq_dim(dim) == jpq._calc_pq_dim(dim)


def test_rotation_is_identity_unless_forced():
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cpu")
    assert torch.equal(tpq.make_rotation_matrix(g, 32, 32, False, dev),
                       torch.eye(32))
    np.testing.assert_array_equal(
        tpq.make_rotation_matrix(g, 36, 33, False, dev).numpy(),
        np.asarray(jpq.make_rotation_matrix(None, 36, 33, False)))
    r = tpq.make_rotation_matrix(g, 36, 33, True, dev)
    torch.testing.assert_close(r.T @ r, torch.eye(33), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- encoding


@pytest.mark.parametrize("kind", ["per_subspace", "per_cluster"])
def test_encode_batch_matches_jax_at_injected_state(data, jindex,
                                                    jper_cluster, kind):
    db, _ = data
    j = jindex if kind == "per_subspace" else jper_cluster
    _, t = _carry(j)
    x = db[:600]
    labels = np.array(jkm.predict(j.centers, x))
    want = np.asarray(jpq.encode_batch(j, x, jnp.asarray(labels)))
    got = tpq.encode_batch(t, x, torch.from_numpy(labels)).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    wc, gc = want.astype(np.int64), got.astype(np.int64)  # pq_bits 8: raw
    # a differing code is a near tie of its subspace's two codebook entries
    rr = (x - np.asarray(j.centers)[labels]) @ np.asarray(j.rotation).T
    sub = rr.reshape(len(x), t.pq_dim, t.pq_len)
    cbs = np.asarray(j.codebooks)
    for r, s in zip(*np.nonzero(wc != gc)):
        cb = cbs[labels[r]] if kind == "per_cluster" else cbs[s]
        d = ((sub[r, s][None, :] - cb) ** 2).sum(-1)
        assert abs(d[wc[r, s]] - d[gc[r, s]]) <= 1e-4 * max(d.max(), 1.0)
    assert (wc == gc).mean() > 0.999


def test_extend_into_jax_state_gives_the_same_layout(data, jindex):
    db, _ = data
    _, t0 = _carry(jindex)
    jp = jpq.IndexParams(n_lists=16, pq_dim=16, list_pad_expansion=1.05)
    tp = tpq.IndexParams(n_lists=16, pq_dim=16, list_pad_expansion=1.05)
    j = jpq.Index(jp, 16, jindex.centers, jindex.rotation, jindex.codebooks,
                  None, None, None, 0)
    t = tpq.Index(tp, 16, t0.centers, t0.rotation, t0.codebooks, None, None,
                  None, 0)
    half = len(db) // 2
    j = jpq.extend(jpq.extend(j, db[:half]), db[half:])
    t = tpq.extend(tpq.extend(t, db[:half]), db[half:])
    for name in ("list_sizes", "list_indices", "overflow_indices",
                 "overflow_labels"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    for name in ("list_codes", "overflow_codes"):
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.shape == want.shape, name
        assert (got == want).mean() > 0.999, name  # near-tie codes only
    assert t.size == j.size == len(db)


# ---------------------------------------------------------------- planners


@pytest.mark.parametrize("budget", [1, 1000, 1 << 20, 128 << 20, 20 << 30])
def test_solve_joint_tiles_matches_jax(budget):
    for cell in (1, 300, 70000, 3 << 20):
        for inner in (1, 7, 64, 1000):
            for cap, mult in ((256, 8), (64, 1)):
                assert solve_joint_tiles(budget, cell, inner, cap, mult) \
                    == j_solve_joint_tiles(budget, cell, inner, cap, mult)


@pytest.mark.parametrize("workspace", [1 << 16, 3 << 20, 128 << 20, 20 << 30])
def test_lut_and_cache_planners_match_jax(workspace):
    for n_probes in (1, 20, 64, 200):
        for list_pad in (8, 1456, 20000):
            for pq_dim, pq_bits in ((16, 8), (64, 8), (96, 5)):
                for lut_b, dist_b in ((4, 4), (2, 2), (1, 4)):
                    args = (list_pad, pq_dim, pq_bits, lut_b, dist_b)
                    assert tpq.lut_bytes_per_query_probe(*args) \
                        == jpq.lut_bytes_per_query_probe(*args)
                    assert tpq.plan_lut_tiles(n_probes, list_pad, pq_dim,
                                              pq_bits, workspace, lut_b,
                                              dist_b) \
                        == jpq.plan_lut_tiles(n_probes, list_pad, pq_dim,
                                              pq_bits, workspace, lut_b,
                                              dist_b)
            assert tpq.cache_bytes_per_query(n_probes, list_pad, 128) \
                == jpq.cache_bytes_per_query(n_probes, list_pad, 128)
            assert tpq.plan_cache_tiles(n_probes, list_pad, 128, workspace) \
                == jpq.plan_cache_tiles(n_probes, list_pad, 128, workspace)


@pytest.mark.parametrize("device_memory", [None, 1 << 30, 16 << 30, 80 << 30])
def test_resolve_scan_mode_matches_jax(device_memory):
    for n_lists, list_pad in ((1024, 1456), (50000, 3000), (16, 8)):
        for rot, code_bytes, itemsize in ((128, 64, 2), (96, 60, 4)):
            for workspace in (1 << 10, 128 << 20, 20 << 30):
                args = (n_lists, list_pad, rot, code_bytes, itemsize,
                        device_memory, workspace)
                assert tpq.resolve_scan_mode(*args) \
                    == jpq.resolve_scan_mode(*args)


def test_regime_flips_at_the_stated_device_memory(jindex):
    _, t = _carry(jindex)
    packed, cache = tpq.scan_memory_bytes(t)
    slots = t.n_lists * t.list_codes.shape[1]
    assert (packed, cache) == (slots * (t.list_codes.shape[2] + 4),
                               slots * (t.rot_dim * 2 + 4))
    assert tpq.scan_memory_bytes(t, "float32")[1] == slots * (t.rot_dim * 4
                                                              + 4)
    need = packed + cache
    sp = tpq.SearchParams(n_probes=4)
    for memory, engine, mode in ((2 * need, "pallas_cache", "cache"),
                                 (2 * need - 2, "pallas_lut", "lut")):
        res = Resources(device="cpu", device_memory_bytes=memory)
        assert res.device_memory_bytes == memory
        assert tpq.plan_search(t, 10, sp, res=res).engine == engine
        assert jpq.resolve_scan_mode(t.n_lists, t.list_codes.shape[1],
                                     t.rot_dim, t.list_codes.shape[2], 2,
                                     memory, res.workspace_limit_bytes) == mode
    # no stated device memory on the CPU: four times the workspace decides
    assert Resources(device="cpu").device_memory_bytes is None
    small = Resources(device="cpu", workspace_limit_bytes=need // 4 - 1)
    assert tpq.plan_search(t, 10, sp, res=small).engine == "pallas_lut"


# ----------------------------------------------------- search, fused engines


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_fused_cache_regime_matches_jax_cache_engine(data, jindex, joverflow,
                                                     overflow, cache_dtype,
                                                     metric):
    if overflow:
        j0, db, q = joverflow
    else:
        j0, (db, q) = jindex, data
    j, t = _carry(j0, metric)
    sp = tpq.SearchParams(n_probes=4, scan_cache_dtype=cache_dtype)
    assert tpq.plan_search(t, 10, sp).engine == "pallas_cache"
    got = tpq.search(t, q, 10, sp)
    assert t.list_decoded.dtype == getattr(torch, cache_dtype)
    want = jpq.search(j, q, 10, jpq.SearchParams(
        n_probes=4, scan_mode="cache",
        scan_cache_dtype=getattr(jnp, cache_dtype)))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_topk_close(got, want, 1e-4 * _scale(db, metric), 1e-5)


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_fused_lut_regime_matches_jax_lut_engine(data, jindex, joverflow,
                                                 overflow, k, metric):
    if overflow:
        j0, db, q = joverflow
    else:
        j0, (db, q) = jindex, data
    j, t = _carry(j0, metric)
    res = _lut_res(t)
    sp = tpq.SearchParams(n_probes=5)
    assert tpq.plan_search(t, k, sp, res=res).engine == "pallas_lut"
    got = tpq.search(t, q, k, sp, res=res)
    assert t.list_decoded is None  # the LUT regime builds no cache
    want = jpq.search(j, q, k, jpq.SearchParams(n_probes=5, scan_mode="lut"))
    assert_topk_close(got, want, 1e-4 * _scale(db, metric), 1e-5)


def test_fused_cache_regime_matches_jax_pallas_interpret(data, jindex,
                                                         monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS_INTERPRET", "1")
    db, q = data
    j, t = _carry(jindex)
    want = jpq.search(j, q[:20], 10, jpq.SearchParams(n_probes=3,
                                                      scan_mode="pallas"))
    got = tpq.search(t, q[:20], 10, tpq.SearchParams(n_probes=3))
    assert_topk_close(got, want, 1e-4 * _scale(db), 1e-5)


# --------------------------------------------------- search, unfused engines


def _unfused_case(case, data, jindex, jper_cluster, jbits5):
    """(JAX index, port index, JAX params, port params, filter mask) of one
    unfused-engine case."""
    src = {"pq_bits5": jbits5, "per_cluster": jper_cluster}.get(case, jindex)
    metric = {"inner_product": "inner_product",
              "euclidean": "euclidean"}.get(case)
    j, t = _carry(src, metric)
    jkw, tkw = {}, {}
    if case in ("bf16_lut", "bf16_distances", "fp8_lut"):
        name = {"bf16_lut": "lut_dtype", "bf16_distances":
                "internal_distance_dtype", "fp8_lut": "lut_dtype"}[case]
        dt = "float8_e4m3fn" if case == "fp8_lut" else "bfloat16"
        jkw[name], tkw[name] = getattr(jnp, dt), dt
    mask = None
    if case == "filter":
        mask = np.random.default_rng(22).random(len(data[0])) < 0.6
    return j, t, jkw, tkw, mask


_UNFUSED = [("filter", "lut"), ("filter", "cache"), ("inner_product", "lut"),
            ("inner_product", "cache"), ("euclidean", "lut"),
            ("pq_bits5", "lut"), ("pq_bits5", "cache"),
            ("per_cluster", "lut"), ("per_cluster", "cache"),
            ("bf16_lut", "lut"), ("bf16_distances", "lut"),
            ("fp8_lut", "lut")]


@pytest.mark.parametrize("case,engine", _UNFUSED)
def test_unfused_engines_match_jax(data, jindex, jper_cluster, jbits5, case,
                                   engine):
    db, q = data
    j, t, jkw, tkw, mask = _unfused_case(case, data, jindex, jper_cluster,
                                         jbits5)
    jf = JBitset.from_mask(mask) if mask is not None else None
    tf = Bitset.from_mask(torch.from_numpy(mask)) if mask is not None else None
    want = jpq.search(j, q, 10, jpq.SearchParams(n_probes=5, scan_mode=engine,
                                                 **jkw), filter=jf)
    sp = tpq.SearchParams(n_probes=5, scan_mode=engine, **tkw)
    assert tpq.plan_search(t, 10, sp, mask is not None).engine == engine
    got = tpq.search(t, q, 10, sp, filter=tf)
    metric = "euclidean" if case == "euclidean" else "sqeuclidean"
    # a bf16 or fp8 entry that rounded the other way would differ by one
    # step of its format (of its subspace's max-abs for fp8); none does here
    agree = assert_topk_close(got, want, 1e-4 * _scale(db, metric), 1e-5)
    assert agree["id_agreement"] >= 0.95, agree
    if mask is not None:
        ids = got[1].numpy()
        assert mask[ids[ids >= 0]].all()


@pytest.mark.parametrize("case,reason", [
    ("filter", "filtered"), ("inner_product", "non_l2"),
    ("k", "k_gt_1024"), ("pq_bits5", "lut_params_unsupported"),
    ("per_cluster", "lut_params_unsupported"),
    ("bf16_lut", "lut_params_unsupported"),
    ("fp8_lut", "lut_params_unsupported")])
def test_auto_sends_declined_requests_to_the_unfused_engines(
        data, jindex, jper_cluster, jbits5, case, reason):
    _, t, _, tkw, mask = _unfused_case(case, data, jindex, jper_cluster,
                                       jbits5)
    k = 1100 if case == "k" else 10
    plan = tpq.plan_search(t, k, tpq.SearchParams(n_probes=4, **tkw),
                           mask is not None, res=_lut_res(t))
    assert (plan.engine, plan.reason) == ("lut", reason)


def test_a_lut_beyond_shared_memory_takes_the_unfused_engine():
    # pq_dim 220 at k=1024 needs more than a block's 227 KB for its LUT
    rng = np.random.default_rng(3)
    L, pad, pq_dim = 4, 8, 220
    assert not gk.fused_pq_fits(pq_dim, 1, 1024) and gk.fused_pq_fits(
        pq_dim, 1, 10)
    t = interop.ivf_pq_index_from_numpy(
        tpq.IndexParams(n_lists=L, pq_dim=pq_dim), pq_dim,
        rng.standard_normal((L, pq_dim)), np.eye(pq_dim),
        rng.standard_normal((pq_dim, 256, 1)),
        rng.integers(0, 256, (L, pad, pq_dim)),
        np.arange(L * pad).reshape(L, pad), np.full(L, pad), L * pad,
        np.zeros((0, pq_dim)), np.zeros(0), np.zeros(0), device="cpu")
    res = Resources(device="cpu", device_memory_bytes=1)
    sp = tpq.SearchParams(n_probes=2)
    assert tpq.plan_search(t, 10, sp, res=res).engine == "pallas_lut"
    plan = tpq.plan_search(t, 1024, sp, res=res)
    assert (plan.engine, plan.reason) == ("lut", "lut_params_unsupported")
    v, i = tpq.search(t, rng.standard_normal((3, pq_dim)), 1024, sp, res=res)
    assert int((i >= 0).sum(1).max()) == 2 * pad


def test_lut_probe_tile_loop_matches_the_single_pass(data, jindex):
    db, q = data
    j, t = _carry(jindex)
    n_probes = 12
    sp = tpq.SearchParams(n_probes=n_probes, scan_mode="lut")
    per_qp = tpq.lut_bytes_per_query_probe(t.list_codes.shape[1], t.pq_dim,
                                           t.pq_bits)
    tight = Resources(device="cpu", workspace_limit_bytes=per_qp * 8 * 3)
    plan = tpq.plan_search(t, 10, sp, res=tight)
    assert 1 < plan.plan["probe_tile"] < n_probes
    assert plan.plan["predicted_workspace_bytes"] <= per_qp * 8 * 3
    roomy = Resources(device="cpu", workspace_limit_bytes=1 << 34)
    assert tpq.plan_search(t, 10, sp, res=roomy).plan["probe_tile"] == n_probes
    tiled = tpq.search(t, q, 10, sp, res=tight)
    single = tpq.search(t, q, 10, sp, res=roomy)
    # the same per-candidate arithmetic: equal values, ties in any order
    assert_topk_close(tiled, single, 0.0, 0.0)
    want = jpq.search(j, q, 10, jpq.SearchParams(n_probes=n_probes,
                                                 scan_mode="lut"),
                      res=JResources(workspace_limit_bytes=1 << 34))
    assert_topk_close(tiled, want, 1e-4 * _scale(db), 1e-5)


# ------------------------------------------------------------------ refine


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product"])
def test_refine_matches_jax(data, metric):
    db, q = data
    rng = np.random.default_rng(7)
    cand = rng.integers(0, len(db), (len(q), 30)).astype(np.int32)
    cand[:, ::7] = -1  # missing candidates
    cand[0, 3:] = -1  # fewer valid candidates than k
    want = jref.refine(db, q, cand, 10, metric)
    got = refine(db, q, cand, 10, metric, device="cpu")
    assert got[1].dtype == torch.int32
    assert_topk_close(got, want, 1e-4 * _scale(db, metric), 1e-5)
    small = refine(db, q, cand, 10, metric,
                   res=Resources(device="cpu", workspace_limit_bytes=20000))
    assert_topk_close(small, want, 1e-4 * _scale(db, metric), 1e-5)


def test_refine_checks_its_inputs(data):
    db, q = data
    cand = np.zeros((len(q), 5), np.int32)
    with pytest.raises(ValueError, match="n_candidates"):
        refine(db, q, cand, 6, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        refine(db, q, cand[:3], 2, device="cpu")


# ------------------------------------------------------------------- build


@pytest.mark.parametrize("kind", ["per_subspace", "per_cluster", "pq_bits5"])
def test_build_recall_within_002_of_jax(data, gt, jindex, jper_cluster,
                                        jbits5, kind):
    db, q = data
    j = {"per_subspace": jindex, "per_cluster": jper_cluster,
         "pq_bits5": jbits5}[kind]
    jp = j.params
    t = tpq.build(db, tpq.IndexParams(
        n_lists=16, pq_dim=16, pq_bits=jp.pq_bits,
        codebook_kind=int(jp.codebook_kind)), device="cpu")
    assert tuple(t.codebooks.shape) == tuple(j.codebooks.shape)
    assert torch.equal(t.rotation, torch.eye(32))
    assert int(t.list_sizes.sum()) + int((t.overflow_indices >= 0).sum()) \
        == len(db)
    for n_probes in (3, 5):
        _, ji = jpq.search(j, q, 10, jpq.SearchParams(n_probes=n_probes,
                                                      scan_mode="lut"))
        _, ti = tpq.search(t, q, 10, tpq.SearchParams(n_probes=n_probes,
                                                      scan_mode="lut"))
        j_rec = float(neighborhood_recall(torch.from_numpy(np.array(ji)), gt))
        t_rec = float(neighborhood_recall(ti, gt))
        assert abs(t_rec - j_rec) <= 0.02, (n_probes, t_rec, j_rec)


def test_build_at_injected_coarse_centers_packs_jax_lists(data, jindex):
    db, _ = data
    t = tpq.build(db, tpq.IndexParams(n_lists=16, pq_dim=16),
                  coarse_centers=np.array(jindex.centers), device="cpu")
    np.testing.assert_array_equal(t.centers.numpy(),
                                  np.asarray(jindex.centers))
    for name in ("list_sizes", "list_indices", "overflow_indices"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(jindex, name)),
                                      err_msg=name)
    with pytest.raises(ValueError, match="coarse_centers"):
        tpq.build(db, tpq.IndexParams(n_lists=8, pq_dim=16),
                  coarse_centers=np.array(jindex.centers), device="cpu")


def test_codebook_training_is_seeded_and_tiling_invariant():
    rng = np.random.default_rng(9)
    sub = torch.from_numpy(rng.standard_normal((3, 700, 2)).astype(np.float32))
    w = torch.ones(3, 700)
    w[1, 500:] = 0.0  # padding rows never seed a code

    def train(workspace):
        return tpq._train_codebooks(torch.Generator().manual_seed(0), sub, w,
                                    256, 5, workspace)

    big = train(1 << 30)
    assert torch.equal(big, train(1 << 30))
    # one group and 150 rows at a time: the same draws, the same sums
    torch.testing.assert_close(train(256 * 8 * 150), big, atol=1e-5, rtol=0)
    seeds = sub[1, :500]
    assert bool((torch.cdist(big[1], seeds).min(1).values < 10).all())


# --------------------------------------------------- the plain fused kernel


def _numpy_adc(probes, q_rot, centers, cb, codes, ids, k):
    """The numpy ADC reference of raft_tpu's fused_pq_topk test
    (tests/test_pallas_fused.py), then a stable top-k."""
    nq, P = probes.shape
    L, pad, pq_dim = codes.shape
    pq_len = cb.shape[2]
    ref_d = np.full((nq, P * pad), np.inf, np.float32)
    ref_g = np.full((nq, P * pad), -1, np.int64)
    for qi in range(nq):
        for pj in range(P):
            sl = probes[qi, pj]
            res = (q_rot[qi] - centers[sl]).reshape(pq_dim, pq_len)
            lut = ((res[:, None, :] - cb) ** 2).sum(-1)  # [pq_dim, book]
            dist = lut[np.arange(pq_dim)[None, :],
                       codes[sl].astype(np.int64)].sum(-1)
            dist = np.where(ids[sl] < 0, np.inf, dist)
            ref_d[qi, pj * pad:(pj + 1) * pad] = dist
            ref_g[qi, pj * pad:(pj + 1) * pad] = ids[sl]
    order = np.argsort(ref_d, axis=1, kind="stable")[:, :k]
    v = np.take_along_axis(ref_d, order, 1)
    i = np.where(np.isfinite(v), np.take_along_axis(ref_g, order, 1), -1)
    if v.shape[1] < k:
        v = np.pad(v, ((0, 0), (0, k - v.shape[1])), constant_values=np.inf)
        i = np.pad(i, ((0, 0), (0, k - i.shape[1])), constant_values=-1)
    return v, i


def _pq_kernel_inputs(seed, L=4, pad=16, pq_dim=4, pq_len=2, nq=3, P=2):
    rng = np.random.default_rng(seed)
    rot = pq_dim * pq_len
    centers = rng.standard_normal((L, rot)).astype(np.float32)
    q_rot = rng.standard_normal((nq, rot)).astype(np.float32)
    cb = rng.standard_normal((pq_dim, 256, pq_len)).astype(np.float32)
    codes = rng.integers(0, 256, (L, pad, pq_dim)).astype(np.uint8)
    ids = np.arange(L * pad, dtype=np.int32).reshape(L, pad)
    ids[:, -3:] = -1
    probes = rng.integers(0, L, (nq, P)).astype(np.int32)
    return probes, q_rot, centers, cb, codes, ids


def _plain(probes, q_rot, centers, cb, codes, ids, k):
    cbt = torch.from_numpy(cb)
    return gk.fused_pq_topk(
        torch.from_numpy(probes), torch.from_numpy(q_rot),
        torch.from_numpy(centers), cbt, (cbt * cbt).sum(-1),
        torch.from_numpy(codes), torch.from_numpy(ids), k)


@pytest.mark.parametrize("k", [1, 5, 26, 40])  # 26 valid candidates, 40 > all
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_fused_pq_topk_matches_numpy_adc(k, seed):
    args = _pq_kernel_inputs(seed)
    got = _plain(*args, k)
    want = _numpy_adc(*args, k)
    assert_topk_close(got, want, 1e-3, 1e-5)
    assert bool((got[1][:, 26:] == -1).all())


def test_plain_fused_pq_topk_ties_resolve_by_probe_then_slot():
    probes, q_rot, centers, cb, codes, ids = _pq_kernel_inputs(2)
    codes[1], centers[1] = codes[0], centers[0]  # two identical lists
    codes[0, 5] = codes[0, 2]  # and a tie inside one list
    probes[:] = np.array([1, 0], np.int32)
    v, i = _plain(probes, q_rot, centers, cb, codes, ids, 26)
    want = _numpy_adc(probes, q_rot, centers, cb, codes, ids, 26)
    np.testing.assert_array_equal(i.numpy(), want[1])
    for row in i.numpy():  # list 1 (ids 16-31) was probed first
        pos = {int(x): p for p, x in enumerate(row)}
        assert all(pos[x] < pos[x - 16] for x in pos if 16 <= x < 29)


def test_fused_pq_topk_rejects_packed_codes():
    probes, q_rot, centers, cb, codes, ids = _pq_kernel_inputs(0)
    with pytest.raises(ValueError, match="pq_bits=8"):
        _plain(probes, q_rot, centers, cb, codes[:, :, :2], ids, 3)
    with pytest.raises(ValueError, match="1 <= k"):
        _plain(probes, q_rot, centers, cb, codes, ids, 1025)


# --------------------------------------------------------------- the rest


def test_cpu_search_launches_no_kernel(data, jindex):
    _, q = data
    _, t = _carry(jindex)
    gk.reset_launch_counts()
    tpq.search(t, q, 10)
    tpq.search(t, q, 10, res=_lut_res(t))
    assert sum(gk.LAUNCHES.values()) == 0


def test_deferred_pieces_raise(data, jindex):
    """What still raises, and ``helpers``, once deferred, now equal to
    raft_tpu's (round trips in tests/test_torch_surface.py)."""
    _, q = data
    j, t = _carry(jindex)
    np.testing.assert_array_equal(tpq.helpers.unpack_list_codes(t, 0),
                                  jpq.helpers.unpack_list_codes(j, 0))
    with pytest.raises(ValueError, match="scan_mode"):
        tpq.search(t, q, 5, tpq.SearchParams(scan_mode="mosaic"))
    with pytest.raises(ValueError, match="lut_dtype"):
        tpq.SearchParams(lut_dtype="float16")
    with pytest.raises(ValueError, match="pq_bits"):
        tpq.IndexParams(pq_bits=3)


# ------------------------------------------ the unfused cache engine's scan


def _jax_cache_scan(j, q, k, n_probes, mask=None):
    """JAX's unfused cache engine through its scan kernel (``use_pallas``)
    in interpret mode, one query tile, on a bf16 cache."""
    jpq.ensure_scan_cache(j, jnp.bfloat16)
    jpq.ensure_overflow_decoded(j, jnp.bfloat16)
    words = (JBitset.from_mask(mask).words if mask is not None
             else jnp.zeros((0,), jnp.uint32))
    has_overflow = j.overflow_codes.shape[0] > 0
    return jpq.search_cache_core(
        q, j.centers, j.rotation, j.list_decoded, j.decoded_norms,
        j.list_indices, j.list_sizes, words, j.metric, k, n_probes,
        q.shape[0], mask is not None, True, True,
        j.overflow_decoded if has_overflow else None,
        j.overflow_norms if has_overflow else None,
        j.overflow_indices, has_overflow)


@pytest.mark.parametrize("case,k", [("filter", 10), ("inner_product", 10),
                                    ("euclidean_filter", 10),
                                    ("sqeuclidean", 1100),
                                    ("overflow_ip", 10)])
def test_auto_cache_engine_scans_like_jax_use_pallas(data, jindex, joverflow,
                                                     monkeypatch, case, k):
    if case == "overflow_ip":
        j0, db, q = joverflow
    else:
        j0, (db, q) = jindex, data
    q = q[:8]
    metric = {"inner_product": "inner_product", "overflow_ip": "inner_product",
              "euclidean_filter": "euclidean"}.get(case, "sqeuclidean")
    j, t = _carry(j0, metric)
    mask = (np.random.default_rng(24).random(len(db)) < 0.7
            if "filter" in case else None)
    tf = Bitset.from_mask(torch.from_numpy(mask)) if mask is not None else None
    sp = tpq.SearchParams(n_probes=6)
    plan = tpq.plan_search(t, k, sp, mask is not None)
    assert plan.engine == "cache" and plan.plan["unfused_ivf_scan"]
    calls = []
    real_scan = gk.ivf_scan
    monkeypatch.setattr(gk, "ivf_scan",
                        lambda *a: calls.append(a[0].shape) or real_scan(*a))
    got = tpq.search(t, q, k, sp, filter=tf)
    assert calls
    want = _jax_cache_scan(j, q, k, 6, mask)
    agree = assert_topk_close(got, want, 1e-4 * _scale(db, metric), 1e-5)
    assert agree["id_agreement"] >= 0.95, agree
    if mask is not None:
        ids, fin = got[1].numpy(), np.isfinite(got[0].numpy())
        assert mask[ids[fin]].all()
    # a forced "cache" keeps the gather
    forced = tpq.SearchParams(n_probes=6, scan_mode="cache")
    assert not tpq.plan_search(t, k, forced, mask is not None).plan[
        "unfused_ivf_scan"]
    calls.clear()
    tpq.search(t, q, k, forced, filter=tf)
    assert not calls


def test_only_the_auto_cache_engine_plans_the_scan(data, jindex):
    _, t = _carry(jindex)
    for sp, has_filter, res, want in [
            (tpq.SearchParams(), False, None, ("pallas_cache", False)),
            (tpq.SearchParams(), True, None, ("cache", True)),
            (tpq.SearchParams(scan_mode="pallas"), True, None,
             ("cache", True)),
            (tpq.SearchParams(scan_mode="cache"), True, None,
             ("cache", False)),
            (tpq.SearchParams(), True, _lut_res(t), ("lut", False)),
            (tpq.SearchParams(), False, _lut_res(t), ("pallas_lut", False))]:
        plan = tpq.plan_search(t, 10, sp, has_filter, res=res)
        assert (plan.engine, plan.plan["unfused_ivf_scan"]) == want
