"""raft_tpu_torch.neighbors.brute_force against raft_tpu.neighbors.brute_force
on the same numpy data, on the CPU: the port's fused path (the plain version
of fused_l2_topk) and its tiled path against the JAX XLA engine and the
JAX fused Pallas kernel in interpret mode, for every ported metric, with and
without a bitset filter.

Tolerances: distances rtol 1e-5 and atol 1e-4·max‖x‖² (fp32 sums taken in
another order; ‖x‖ for the square-rooted metric, 1 for cosine); ids equal
away from near-ties, near-ties as sets
(``raft_tpu_torch.testing.assert_topk_close``).
"""

import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch import interop
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.testing import assert_topk_close

METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    db = rng.standard_normal((700, 32)).astype(np.float32)
    q = rng.standard_normal((19, 32)).astype(np.float32)
    return db, q


def _atol(metric, db):
    scale = float((db ** 2).sum(1).max())
    return 1e-4 * {"sqeuclidean": scale, "euclidean": np.sqrt(scale),
                   "inner_product": scale, "cosine": 1.0}[metric]


def _carried(jindex):
    norms = None if jindex.norms is None else np.asarray(jindex.norms)
    return interop.brute_force_index_from_numpy(
        np.asarray(jindex.dataset), int(jindex.metric), norms, device="cpu")


@pytest.mark.parametrize("scan_mode", ["auto", "xla"])
@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_jax(data, metric, scan_mode):
    db, q = data
    jindex = jbf.build(db, metric=metric)
    want = jbf.search(jindex, q, 10, scan_mode="xla")
    tindex = tbf.build(db, metric=metric, device="cpu")
    np.testing.assert_allclose(
        tindex.norms.numpy() if tindex.norms is not None else 0,
        np.asarray(jindex.norms) if jindex.norms is not None else 0,
        rtol=1e-5)
    for index in (tindex, _carried(jindex)):
        got = tbf.search(index, q, 10, scan_mode=scan_mode)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert_topk_close(got, want, _atol(metric, db), 1e-5)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_fused_path_matches_jax_pallas_interpret(data, monkeypatch, metric):
    monkeypatch.setenv("RAFT_TPU_PALLAS_INTERPRET", "1")
    db, q = data
    jindex = jbf.build(db, metric=metric)
    want = jbf.search(jindex, q, 10, scan_mode="pallas")
    got = tbf.search(_carried(jindex), q, 10, scan_mode="pallas")
    assert_topk_close(got, want, _atol(metric, db), 1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_filtered_search_matches_jax(data, metric):
    db, q = data
    mask = np.random.default_rng(12).random(len(db)) < 0.7
    jindex = jbf.build(db, metric=metric)
    want = jbf.search(jindex, q, 10, filter=JBitset.from_mask(mask),
                      scan_mode="xla")
    got = tbf.search(_carried(jindex), q, 10,
                     filter=Bitset.from_mask(torch.from_numpy(mask)))
    assert_topk_close(got, want, _atol(metric, db), 1e-5)
    assert mask[got[1].numpy()].all()


def test_fused_dispatch_and_tiled_path_agree_on_launch_free_cpu(data):
    # on the CPU the wrapper runs the plain version, and no kernel launches
    db, q = data
    index = tbf.build(db, metric="sqeuclidean", device="cpu")
    gk.reset_launch_counts()
    fused = tbf.search(index, q, 7)
    tiled = tbf.search(index, q, 7, scan_mode="xla",
                       res=Resources(device="cpu", workspace_limit_bytes=50_000))
    assert gk.LAUNCHES == {name: 0 for name in gk.LAUNCHES}
    assert_topk_close(fused, tiled, _atol("sqeuclidean", db), 1e-5)


def test_knn_and_k_clamped_to_index_size(data):
    db, q = data
    got = tbf.knn(q, db[:6], 10, metric="sqeuclidean", device="cpu")
    want = jbf.knn(q, db[:6], 10, metric="sqeuclidean")
    assert got[0].shape == (19, 6)
    assert_topk_close(got, want, _atol("sqeuclidean", db), 1e-5)


def test_rejects_bad_requests(data):
    db, q = data
    index = tbf.build(db, device="cpu")
    with pytest.raises(ValueError, match="scan_mode"):
        tbf.search(index, q, 5, scan_mode="mosaic")
    with pytest.raises(ValueError, match="query dim"):
        tbf.search(index, q[:, :8], 5)
    with pytest.raises(NotImplementedError, match="fast scan"):
        tbf.search(index, q, 5, scan_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="explain"):
        tbf.search(index, q, 5, explain=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbf.build(db, metric="l1", device="cpu")


def test_fused_ineligible_reasons_match_jax():
    import jax.numpy as jnp
    from raft_tpu.ops.distance import DistanceType as JD

    from raft_tpu_torch.ops.distance import DistanceType as TD

    cases = [(0, 10, False, False), (1, 10, False, False), (6, 10, False, False),
             (0, 10, True, False), (0, 10, False, True), (0, 2000, False, False)]
    for metric, k, filt, fast in cases:
        assert tbf.fused_ineligible_reason(TD(metric), torch.float32, k, filt,
                                           fast) == \
            jbf.fused_ineligible_reason(JD(metric), jnp.float32, k, filt, fast)
    assert tbf.fused_ineligible_reason(TD(0), torch.int8, 10, False, False) == \
        jbf.fused_ineligible_reason(JD(0), jnp.int8, 10, False, False)


@pytest.mark.parametrize("n_queries,n_db,k,budget", [(19, 700, 10, 2 << 30),
                                                     (10000, 10**6, 10, 1 << 30),
                                                     (5, 50, 3, 1000)])
def test_choose_tiles_matches_jax(n_queries, n_db, k, budget):
    assert tbf._choose_tiles(n_queries, n_db, 128, k, budget) == \
        jbf._choose_tiles(n_queries, n_db, 128, k, budget)
