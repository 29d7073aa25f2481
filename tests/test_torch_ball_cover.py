"""raft_tpu_torch's random ball cover, epsilon neighbourhood and scalar
quantizer against raft_tpu's, on the CPU, on the same seeded numpy inputs.

- One raft_tpu ``ball_cover`` build, carried by
  ``interop.ball_cover_index_from_numpy``, is searched by both packages
  (``knn`` for sqeuclidean, euclidean and haversine; ``eps_nn``): ids and
  adjacency equal, distances rtol 1e-5 with atol 1e-5 of the largest.
- The port's ``build`` with raft_tpu's landmarks (its draw helper replaced):
  lists, ids and sizes equal, radii within the tolerance.
- ``knn``'s pass 2 cut into many query chunks (a small
  ``workspace_limit_bytes``) is bitwise the one-chunk search.
- ``epsilon_neighborhood.eps_neighbors`` equal to raft_tpu's; ``quantize``
  bitwise raft_tpu's (it is the same numpy).
"""

import numpy as np
import pytest
import torch

from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import ball_cover as jbc
from raft_tpu.neighbors import epsilon_neighborhood as jeps
from raft_tpu.neighbors import quantize as jq
from raft_tpu_torch import interop
from raft_tpu_torch import neighbors as tnb
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ball_cover as tbc
from raft_tpu_torch.neighbors import epsilon_neighborhood as teps
from raft_tpu_torch.neighbors import quantize as tq

CPU = Resources(device="cpu")


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    got = got.numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = float(np.max(np.abs(want[fin]), initial=0.0))
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=1e-5 * max(scale, 1e-30))


def _points(metric: str, n: int, seed: int, n_clusters: int = 12):
    """Clustered rows: (latitude, longitude) radians for haversine, 3-D
    otherwise."""
    rng = np.random.default_rng(seed)
    if metric == "haversine":
        c = np.stack([rng.uniform(-1.2, 1.2, n_clusters),
                      rng.uniform(-3.0, 3.0, n_clusters)], 1)
        pts = c[rng.integers(0, n_clusters, n)] + 0.05 * rng.standard_normal(
            (n, 2))
    else:
        c = rng.standard_normal((n_clusters, 3)) * 5.0
        pts = c[rng.integers(0, n_clusters, n)] + rng.standard_normal((n, 3))
    return pts.astype(np.float32)


def _carry(j):
    return interop.ball_cover_index_from_numpy(
        np.asarray(j.landmarks), np.asarray(j.list_data),
        np.asarray(j.list_indices), np.asarray(j.list_sizes),
        np.asarray(j.radii), j.metric, j.n_rows, device="cpu")


@pytest.fixture(scope="module", params=["sqeuclidean", "euclidean",
                                        "haversine"])
def pair(request):
    metric = request.param
    db = _points(metric, 3000, 0)
    q = _points(metric, 160, 1)
    j = jbc.build(db, metric, res=JResources(seed=3))
    return metric, db, q, j, _carry(j)


def test_knn_on_one_build(pair):
    metric, db, q, j, t = pair
    d_t, i_t = tbc.knn(t, q, 10, res=CPU)
    d_j, i_j = jbc.knn(j, q, 10)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _close(d_t, d_j)
    assert d_t.shape == (160, 10) and i_t.dtype == torch.int32


def test_knn_is_exact(pair):
    metric, db, q, j, t = pair
    from raft_tpu_torch.neighbors import brute_force as tbf

    _, i_t = tbc.knn(t, q, 10, n_init_probes=2, res=CPU)
    _, i_b = tbf.knn(q, db, 10, metric=metric, device="cpu")
    np.testing.assert_array_equal(i_t.numpy(), i_b.numpy())


def test_chunked_pass_two_is_bitwise_one_chunk(pair, monkeypatch):
    metric, db, q, j, t = pair
    calls = []
    real = tbc._pass2

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(tbc, "_pass2", counted)
    # one probe in pass 1, so pass 2 has lists to scan
    one = tbc.knn(t, q, 10, 1, res=Resources(device="cpu",
                                             workspace_limit_bytes=1 << 34))
    assert len(calls) == 1
    small = Resources(device="cpu", workspace_limit_bytes=1 << 18)
    many = tbc.knn(t, q, 10, 1, res=small)
    assert len(calls) > 4, calls
    assert torch.equal(one[0].view(torch.int32), many[0].view(torch.int32))
    assert torch.equal(one[1], many[1])


def _eps_in_a_gap(d64: np.ndarray, quantile: float) -> float:
    """A radius near the quantile of the distances d64, at the middle of
    the widest gap between neighbouring distances there: no distance lies
    within rounding of it."""
    s = np.sort(d64.reshape(-1))
    at = int(quantile * (len(s) - 1))
    window = s[max(at - 200, 0):at + 200]
    g = int(np.argmax(np.diff(window)))
    return float(0.5 * (window[g] + window[g + 1]))


def _rooted64(metric, q, db):
    q, db = q.astype(np.float64), db.astype(np.float64)
    if metric == "haversine":
        a = (np.sin(0.5 * (db[None, :, 0] - q[:, None, 0])) ** 2
             + np.cos(q[:, None, 0]) * np.cos(db[None, :, 0])
             * np.sin(0.5 * (db[None, :, 1] - q[:, None, 1])) ** 2)
        return 2.0 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))
    return np.sqrt(((q[:, None, :] - db[None, :, :]) ** 2).sum(-1))


def test_eps_nn_on_one_build(pair):
    metric, db, q, j, t = pair
    eps = _eps_in_a_gap(_rooted64(metric, q, db), 0.005)
    adj_t, deg_t = tbc.eps_nn(t, q, eps, res=CPU)
    adj_j, deg_j = jbc.eps_nn(j, q, eps)
    np.testing.assert_array_equal(adj_t.numpy(), np.asarray(adj_j))
    np.testing.assert_array_equal(deg_t.numpy(), np.asarray(deg_j))
    assert deg_t.dtype == torch.int32 and int(deg_t.sum()) > 0
    small = Resources(device="cpu", workspace_limit_bytes=1 << 18)
    adj_s, deg_s = tbc.eps_nn(t, q, eps, res=small)
    assert torch.equal(adj_s, adj_t) and torch.equal(deg_s, deg_t)
    none_t = tbc.eps_nn(t, q, -1.0, res=CPU)
    assert not bool(none_t[0].any()) and int(none_t[1].sum()) == 0


def test_build_with_jax_landmarks(pair, monkeypatch):
    metric, db, q, j, t = pair
    monkeypatch.setattr(tbc, "_landmark_rows",
                        lambda g, x, n: torch.from_numpy(np.array(
                            j.landmarks)))
    b = tbc.build(db, metric, res=CPU)
    np.testing.assert_array_equal(b.list_sizes.numpy(),
                                  np.asarray(j.list_sizes))
    np.testing.assert_array_equal(b.list_data.numpy(),
                                  np.asarray(j.list_data))
    np.testing.assert_array_equal(b.list_indices.numpy(),
                                  np.asarray(j.list_indices))
    _close(b.radii, j.radii)
    assert b.metric == t.metric and b.n_rows == j.n_rows


def test_build_draws_and_rejects_metrics():
    db = _points("euclidean", 400, 2)
    a = tbc.build(db, "euclidean", res=Resources(device="cpu", seed=1))
    b = tbc.build(db, "euclidean", res=Resources(device="cpu", seed=1))
    assert a.n_landmarks == 20 and torch.equal(a.landmarks, b.landmarks)
    with pytest.raises(ValueError, match="L2/haversine"):
        tbc.build(db, "cosine", res=CPU)
    assert tnb.rbc.build is tbc.build and tnb.rbc.knn is tbc.knn
    assert set(tnb.rbc.__all__) == {"BallCoverIndex", "build", "knn"}


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "haversine"])
def test_eps_neighbors(metric):
    x = _points("haversine" if metric == "haversine" else "euclidean", 90, 4)
    y = _points("haversine" if metric == "haversine" else "euclidean", 300, 5)
    d64 = _rooted64(metric, x, y)
    eps = _eps_in_a_gap(d64 ** 2 if metric == "sqeuclidean" else d64, 0.1)
    adj_t, deg_t = teps.eps_neighbors(x, y, eps, metric, device="cpu")
    adj_j, deg_j = jeps.eps_neighbors(x, y, eps, metric)
    np.testing.assert_array_equal(adj_t.numpy(), np.asarray(adj_j))
    np.testing.assert_array_equal(deg_t.numpy(), np.asarray(deg_j))
    assert deg_t.dtype == torch.int32 and 0 < int(deg_t.sum()) < adj_t.numel()


@pytest.mark.parametrize("quantile", [1.0, 0.99])
def test_quantize_is_bitwise(quantile):
    rng = np.random.default_rng(6)
    train = (rng.standard_normal((500, 12)) * 3.0).astype(np.float32)
    data = (rng.standard_normal((200, 12)) * 4.0).astype(np.float32)
    st = tq.ScalarQuantizer.fit(train, quantile)
    sj = jq.ScalarQuantizer.fit(train, quantile)
    for a, b in ((st.lo, sj.lo), (st.scale, sj.scale),
                 (st.transform(data), sj.transform(data))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    codes = st.transform(data)
    assert codes.dtype == np.int8 and st.dim == 12
    assert np.array_equal(st.inverse_transform(codes),
                          sj.inverse_transform(codes))
    with pytest.raises(ValueError):
        tq.ScalarQuantizer.fit(train, 0.4)
