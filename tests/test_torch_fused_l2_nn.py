"""raft_tpu_torch's fused L2 1-NN against raft_tpu's, on the CPU.

The plain version of the ``fused_l2_argmin`` kernel is held against the JAX
Pallas kernel in interpret mode, its clamped form against JAX's
``fused_l2_nn_core`` (the k-means E-step), and the module's entry points
against ``raft_tpu.ops.fused_l2_nn``, on the same numpy inputs.

Tolerances: values rtol 1e-5 and atol 1e-4·max‖x‖² (fp32 sums taken in
another order; for ``sqrt`` its square root); ids equal. The inputs are
drawn so that no two distinct y rows are within that tolerance of a row's
minimum (checked in float64), and duplicated y rows are exact copies, whose
distances are bitwise equal, so ties go to the lowest index in both
packages. The kernel itself runs only on a CUDA card
(tests/test_torch_cuda.py holds it against this plain version there).
"""

import importlib

import numpy as np
import pytest
import torch

from raft_tpu.ops import pallas_kernels as pk
from raft_tpu_torch.ops import fused_l2_nn as tfnn
from raft_tpu_torch.ops import gpu_kernels as gk

jfnn = importlib.import_module("raft_tpu.ops.fused_l2_nn")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(m, n, d, seed, dup=0):
    """x [m, d], y [n, d] float32; with ``dup`` the first ``dup`` y rows are
    repeated at the end of y (exact copies at higher indices)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal((n - dup, d)).astype(np.float32)
    y = np.concatenate([y, y[:dup]])
    return x, y


def _tol(x, y):
    return 1e-4 * float(max((x ** 2).sum(1).max(), (y ** 2).sum(1).max()))


def _assert_no_near_ties(x, y, tol):
    """Precondition of exact id equality: the nearest distinct y vector
    beats the next distinct one by more than twice the tolerance."""
    xd, yd = x.astype(np.float64), y.astype(np.float64)
    _, first = np.unique(y, axis=0, return_index=True)
    d = ((xd[:, None, :] - yd[None, np.sort(first), :]) ** 2).sum(-1)
    part = np.sort(d, axis=1)
    assert (part[:, 1] - part[:, 0]).min() > 2 * tol


def _assert_nn_equal(got, want, atol, rtol=1e-5):
    gv, gi = got
    wv, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi.numpy(), wi.astype(np.int32))
    np.testing.assert_allclose(gv.numpy(), wv, rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,n,d,dup", [(37, 131, 24, 0), (37, 131, 24, 40),
                                       (64, 256, 32, 0), (100, 300, 32, 64),
                                       (5, 1000, 100, 200)])
def test_plain_fused_l2_argmin_matches_pallas(m, n, d, dup):
    x, y = _inputs(m, n, d, seed=m + n, dup=dup)
    tol = _tol(x, y)
    _assert_no_near_ties(x, y, tol)
    want = pk.fused_l2_argmin(x, y, interpret=True)
    got = gk.fused_l2_argmin(_t(x), _t(y))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _assert_nn_equal(got, want, tol)
    # the duplicates at the end of y never win over their first copies
    assert int(got[1].max()) < n - dup


def test_plain_fused_l2_argmin_ties_go_to_the_lowest_index():
    # integer rows: every product and sum is exact, so copies tie exactly
    rng = np.random.default_rng(7)
    base = rng.integers(-4, 5, (30, 12)).astype(np.float32)
    y = np.concatenate([base, base, base])
    x = base[rng.integers(0, 30, 50)] + rng.integers(-1, 2, (50, 12))
    want = pk.fused_l2_argmin(x, y, interpret=True)
    got = gk.fused_l2_argmin(_t(x), _t(y))
    _assert_nn_equal(got, want, 0.0, 0.0)
    assert int(got[1].max()) < 30


@pytest.mark.parametrize("tile", [None, 7, 64])
def test_plain_fused_l2_argmin_is_chunk_invariant(tile):
    x, y = _inputs(50, 90, 16, seed=3)
    a = gk.fused_l2_argmin(_t(x), _t(y), tile=tile)
    b = gk.fused_l2_argmin_plain(_t(x), _t(y), tile=1)
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=_tol(x, y))


def test_clamp_ties_at_zero_take_the_lowest_index():
    # norms stated below the rows' own: every distance is negative, so the
    # unclamped 1-NN is the most negative and the clamped one ties at 0
    x, y = _inputs(20, 60, 8, seed=4)
    xn = (x ** 2).sum(1) - 1e4
    yn = (y ** 2).sum(1)
    want_u = pk.fused_l2_argmin(x, y, xn, yn, interpret=True)
    got_u = gk.fused_l2_argmin(_t(x), _t(y), _t(xn), _t(yn))
    _assert_nn_equal(got_u, want_u, 1e-5 * 1e4)
    assert (want_u[0] < 0).all()
    want_c = jfnn.fused_l2_nn_core(x, y, xn, yn, False, 8)
    got_c = tfnn.fused_l2_nn_core(_t(x), _t(y), _t(xn), _t(yn), False, 8)
    _assert_nn_equal(got_c, want_c, 0.0, 0.0)
    assert (got_c[1] == 0).all() and (got_c[0] == 0).all()


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("m,n,d,tile", [(37, 131, 24, 16), (200, 64, 32, 64),
                                        (9, 500, 100, 9)])
def test_fused_l2_nn_core_matches_jax(m, n, d, tile, sqrt):
    x, y = _inputs(m, n, d, seed=5 + m)
    tol = _tol(x, y)
    _assert_no_near_ties(x, y, tol)
    xn, yn = (x ** 2).sum(1), (y ** 2).sum(1)
    want = jfnn.fused_l2_nn_core(x, y, xn, yn, sqrt, tile)
    got = tfnn.fused_l2_nn_core(_t(x), _t(y), _t(xn), _t(yn), sqrt, tile)
    _assert_nn_equal(got, want, np.sqrt(tol) if sqrt else tol)


@pytest.mark.parametrize("norms", [False, True])
@pytest.mark.parametrize("sqrt", [False, True])
def test_fused_l2_nn_argmin_matches_jax(sqrt, norms):
    x, y = _inputs(120, 200, 48, seed=6, dup=20)
    tol = _tol(x, y)
    _assert_no_near_ties(x, y, tol)
    kw = {}
    if norms:
        kw = {"x_norms": (x ** 2).sum(1), "y_norms": (y ** 2).sum(1)}
    want = jfnn.fused_l2_nn_argmin(x, y, sqrt=sqrt, **kw)
    gk.reset_launch_counts()
    got = tfnn.fused_l2_nn_argmin(x, y, sqrt=sqrt, device="cpu", **kw)
    assert sum(gk.LAUNCHES.values()) == 0  # the CPU takes the plain version
    _assert_nn_equal(got, want, np.sqrt(tol) if sqrt else tol)


def test_fused_l2_nn_argmin_honours_given_norms():
    # norms that are not the rows' own change the answer in both packages
    x, y = _inputs(30, 50, 8, seed=8)
    yn = (y ** 2).sum(1) + np.linspace(0, 40, 50, dtype=np.float32)
    want = jfnn.fused_l2_nn_argmin(x, y, y_norms=yn)
    got = tfnn.fused_l2_nn_argmin(x, y, y_norms=yn, device="cpu")
    _assert_nn_equal(got, want, _tol(x, y) + 1e-3)
    plain = tfnn.fused_l2_nn_argmin(x, y, device="cpu")
    assert not torch.equal(got[1], plain[1])


@pytest.mark.parametrize("sqrt", [False, True])
def test_masked_l2_nn_argmin_matches_jax(sqrt):
    x, y = _inputs(40, 90, 16, seed=9)
    rng = np.random.default_rng(10)
    group_idxs = np.array([20, 45, 45, 70, 90], np.int32)  # one empty group
    adj = rng.random((40, 5)) < 0.5
    adj[0] = False  # a row with no allowed group: inf, index 0
    want = jfnn.masked_l2_nn_argmin(x, y, adj, group_idxs, sqrt=sqrt)
    got = tfnn.masked_l2_nn_argmin(x, y, adj, group_idxs, sqrt=sqrt,
                                   device="cpu")
    tol = _tol(x, y)
    _assert_nn_equal(got, want, np.sqrt(tol) if sqrt else tol)
    assert got[0][0] == torch.inf and got[1][0] == 0


@pytest.mark.parametrize("m,n,budget", [(1000, 8, 1 << 20), (70000, 1024, 2 << 30),
                                        (5, 100000, 1 << 16), (0, 10, 1 << 20)])
def test_tile_planner_matches_jax(m, n, budget):
    assert tfnn.choose_tile_rows(m, n, budget) == jfnn.choose_tile_rows(
        m, n, budget)
    assert tfnn.planned_peak_bytes(m, n, budget) == jfnn.planned_peak_bytes(
        m, n, budget)
