"""raft_tpu_torch's ``stats`` (basic and cluster metrics) against raft_tpu's,
on the CPU, on the same seeded numpy inputs.

Tolerances: fp32 results rtol 1e-5 with atol 1e-5 of the largest |value|
(sums in another order); histogram counts, contingency tables and integer
outputs equal. The contingency counts are float32 in both packages (raft_tpu
counts in float64 only under ``jax_enable_x64``, off here).
``trustworthiness_score`` runs both packages' brute-force kNN on seeded
normal rows, where no two distances tie.
"""

import numpy as np
import pytest
import torch

from raft_tpu import stats as jstats
from raft_tpu_torch import stats as tstats
from raft_tpu_torch.core.resources import Resources

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol_scale=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * max(scale, 1e-30))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("axis", [0, 1])
def test_moments(axis):
    x = _rand(50, 8) * 3.0 + 1.0
    for name in ("mean", "sum", "minmax"):
        got, want = getattr(tstats, name)(_t(x), axis), getattr(
            jstats, name)(x, axis)
        if name == "minmax":
            _close(got[0], want[0])
            _close(got[1], want[1])
        else:
            _close(got, want)
    for name in ("var", "stddev"):
        for sample in (False, True):
            _close(getattr(tstats, name)(_t(x), axis, sample),
                   getattr(jstats, name)(x, axis, sample))
    for sample in (False, True):
        mu_t, v_t = tstats.meanvar(_t(x), axis, sample)
        mu_j, v_j = jstats.meanvar(x, axis, sample)
        _close(mu_t, mu_j)
        _close(v_t, v_j)
    c_t, m_t = tstats.mean_center(_t(x), axis)
    c_j, m_j = jstats.mean_center(x, axis)
    _close(c_t, c_j)
    _close(m_t, m_j)


def test_integer_rows_promote_like_jnp_mean():
    xi = np.random.default_rng(1).integers(-9, 9, (20, 3)).astype(np.int32)
    _close(tstats.mean_center(_t(xi))[0], jstats.mean_center(xi)[0])
    _close(tstats.meanvar(_t(xi))[1], jstats.meanvar(xi)[1])
    np.testing.assert_array_equal(tstats.sum(_t(xi)).numpy(),
                                  np.asarray(jstats.sum(xi)))


@pytest.mark.parametrize("sample", [False, True])
def test_cov(sample):
    x = _rand(60, 7)
    _close(tstats.cov(_t(x), sample), jstats.cov(x, sample))


@pytest.mark.parametrize("bounds", [(None, None), (-1.0, 1.5)])
def test_histogram(bounds):
    x = _rand(40, 25)
    c_t, e_t = tstats.histogram(_t(x), 17, *bounds)
    c_j, e_j = jstats.histogram(x, 17, *bounds)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert c_t.dtype == torch.int32 and int(c_t.sum()) == x.size
    _close(e_t, e_j)


def test_model_metrics():
    rng = np.random.default_rng(2)
    yt = rng.standard_normal(101).astype(np.float32)
    yp = (yt + 0.3 * rng.standard_normal(101)).astype(np.float32)
    for name in ("r2_score", "mean_squared_error"):
        _close(getattr(tstats, name)(_t(yt), _t(yp)),
               getattr(jstats, name)(yt, yp))
    for n in (101, 100):  # odd and even counts: the median's two cases
        for got, want in zip(tstats.regression_metrics(_t(yt[:n]),
                                                       _t(yp[:n])),
                             jstats.regression_metrics(yt[:n], yp[:n])):
            _close(got, want)
    p = rng.integers(0, 4, 80).astype(np.int32)
    l = np.where(rng.random(80) < 0.7, p, (p + 1) % 4).astype(np.int32)
    _close(tstats.accuracy_score(_t(p), _t(l)), jstats.accuracy_score(p, l))
    pd = rng.random(30).astype(np.float32)
    qd = rng.random(30).astype(np.float32)
    pd[:4] = 0.0
    _close(tstats.kl_divergence(_t(pd), _t(qd)), jstats.kl_divergence(pd, qd))


def test_dispersion_and_information_criteria():
    c = _rand(6, 4)
    s = np.array([5, 1, 0, 9, 3, 2], np.float32)
    _close(tstats.dispersion(_t(c), _t(s)), jstats.dispersion(c, s))
    g = _rand(4, seed=3)
    _close(tstats.dispersion(_t(c), _t(s), _t(g)),
           jstats.dispersion(c, s, g))
    ll = _rand(10, seed=4) * 50.0
    for crit in ("aic", "aicc", "bic"):
        _close(tstats.information_criterion_batched(_t(ll), 3, 200, crit),
               jstats.information_criterion_batched(ll, 3, 200, crit))
    with pytest.raises(ValueError):
        tstats.information_criterion_batched(_t(ll), 3, 200, "hqic")


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_trustworthiness(metric):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((120, 10)).astype(np.float32)
    emb = (x[:, :2] + 0.3 * rng.standard_normal((120, 2))).astype(
        np.float32)
    got = tstats.trustworthiness_score(_t(x), _t(emb), 5, metric,
                                       res=Resources(device="cpu"))
    want = jstats.trustworthiness_score(x, emb, 5, metric)
    _close(got, want)
    assert 0.0 < float(got) < 1.0
    with pytest.raises(ValueError):
        tstats.trustworthiness_score(_t(x[:10]), _t(emb[:10]), 5,
                                     device="cpu")


def _labels(n, k, seed):
    return np.random.default_rng(seed).integers(0, k, n).astype(np.int32)


def test_contingency_and_label_scores():
    a, b = _labels(500, 6, 6), _labels(500, 4, 7)
    b[:200] = a[:200] % 4  # some agreement
    got = tstats.contingency_matrix(_t(a), _t(b), 6, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jstats.contingency_matrix(a, b, 6, 4)))
    assert got.dtype == torch.float32
    for name in ("rand_index", "adjusted_rand_index", "mutual_info_score",
                 "homogeneity_score", "completeness_score", "v_measure"):
        _close(getattr(tstats, name)(_t(a), _t(b), 6, 4),
               getattr(jstats, name)(a, b, 6, 4))
    _close(tstats.v_measure(_t(a), _t(b), 6, 4, beta=0.5),
           jstats.v_measure(a, b, 6, 4, beta=0.5))
    _close(tstats.entropy(_t(a), 6), jstats.entropy(a, 6))
    # one class: entropy 0, homogeneity 1 by convention
    one = np.zeros(50, np.int32)
    _close(tstats.homogeneity_score(_t(one), _t(b[:50]), 1, 4),
           jstats.homogeneity_score(one, b[:50], 1, 4))


@pytest.mark.parametrize("metric", ["l2_expanded", "euclidean"])
def test_silhouette(metric):
    rng = np.random.default_rng(8)
    centers = rng.standard_normal((5, 6)) * 4.0
    lab = rng.integers(0, 5, 150).astype(np.int32)
    lab[lab == 3] = 2  # an empty cluster
    lab[0] = 3  # ... then a cluster of one
    x = (centers[lab] + rng.standard_normal((150, 6))).astype(np.float32)
    _close(tstats.silhouette_score(_t(x), _t(lab), 5, metric),
           jstats.silhouette_score(x, lab, 5, metric))


def test_stats_all_matches_jax():
    assert set(tstats.__all__) == set(jstats.__all__)
