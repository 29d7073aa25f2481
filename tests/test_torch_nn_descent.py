"""raft_tpu_torch's NN-descent against raft_tpu's, on the CPU.

The two packages draw different random numbers (torch.Generator vs
jax.random), so a build is held by graph recall against the exact kNN
graph: at least the JAX build's recall on the same data minus 0.02, at
tests/test_nn_descent.py's sizes. The deterministic pieces (the scatter
whose later writer wins, the candidate sizing) are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import nn_descent as jnd
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import nn_descent as tnd
from raft_tpu_torch.stats import neighborhood_recall


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    return rng.standard_normal((2000, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def exact_graph(data):
    x = data.astype(np.float64)
    sq = (x * x).sum(1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=1, kind="stable")[:, :32]


_PARAMS = dict(graph_degree=32, intermediate_graph_degree=48,
               max_iterations=12)


@pytest.fixture(scope="module")
def jax_recall(data, exact_graph):
    index = jnd.build(data, jnd.IndexParams(**_PARAMS), res=JResources(seed=0))
    return float(neighborhood_recall(torch.from_numpy(np.array(
        index.graph)), torch.from_numpy(exact_graph)))


@pytest.fixture(scope="module")
def built(data):
    return tnd.build(data, tnd.IndexParams(**_PARAMS),
                     res=Resources(device="cpu", seed=0))


def test_graph_recall_within_002_of_jax(built, exact_graph, jax_recall):
    assert built.graph.shape == (2000, 32)
    assert built.graph.dtype == torch.int32
    recall = float(neighborhood_recall(built.graph,
                                       torch.from_numpy(exact_graph)))
    assert recall >= jax_recall - 0.02, (recall, jax_recall)
    assert recall >= 0.9, recall


def test_no_self_loops_and_sorted_distances(built, data):
    g = built.graph.numpy()
    assert not (g == np.arange(len(data))[:, None]).any()
    assert (g >= 0).all()
    d = built.distances.numpy()
    assert (np.diff(d, axis=1) >= 0).all()
    # the distances are the rows' squared L2 distances
    want = ((data[:, None, :] - data[g]) ** 2).sum(-1)
    np.testing.assert_allclose(d, want, rtol=1e-5,
                               atol=1e-4 * float((data ** 2).sum(1).max()))
    assert 1 <= built.n_iterations <= 12


def test_inner_product_recall_within_002_of_jax(data):
    x = data[:600]
    params = dict(graph_degree=16, intermediate_graph_degree=24,
                  max_iterations=8, metric="inner_product")
    got = tnd.build(x, tnd.IndexParams(**params),
                    res=Resources(device="cpu", seed=1)).graph
    want = np.array(jnd.build(x, jnd.IndexParams(**params),
                              res=JResources(seed=1)).graph)
    sim = x.astype(np.float64) @ x.T.astype(np.float64)
    np.fill_diagonal(sim, -np.inf)
    exact = torch.from_numpy(np.argsort(-sim, axis=1, kind="stable")[:, :16])
    r_got = float(neighborhood_recall(got, exact))
    r_want = float(neighborhood_recall(torch.from_numpy(want), exact))
    assert r_got >= r_want - 0.02, (r_got, r_want)


def test_plan_build_matches_jax_sizing():
    # the candidate sizing and node tile of raft_tpu's build (:264-276)
    for k, ws in ((48, 2 << 30), (96, 20 << 30), (8, 1 << 20), (200, 1 << 26)):
        fwd = min(int(np.clip(768 // k, 3, 12)), k)
        rev = min(int(np.clip(384 // k, 2, 6)), k)
        rs = min(max(k // 2, 16), 64)
        per_node = ((fwd + rev) * k + rs + 8) * (128 + 8) * 4 * 2
        tile = int(np.clip(ws // per_node, 64, 4096))
        tile -= tile % 8
        assert tnd.plan_build(10_000, 128, k, ws) == (fwd, rev, rs, tile)


def test_scatter_last_wins_matches_jax_serial_scatter():
    rng = np.random.default_rng(3)
    rows = rng.integers(-2, 9, 400).astype(np.int32)  # -2, -1 and 8: dropped
    cols = rng.integers(0, 5, 400)
    vals = rng.integers(0, 1000, 400).astype(np.int32)
    keep = (rows >= 0) & (rows < 8)
    want = jnp.full((8, 5), -1, jnp.int32).at[
        jnp.where(keep, rows, 8), cols].set(vals, mode="drop")
    got = tnd.scatter_last_wins(8, 5, torch.from_numpy(rows),
                                torch.from_numpy(cols), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_metric_validation():
    with pytest.raises(ValueError, match="supports"):
        tnd.IndexParams(metric="canberra")
