"""raft_tpu_torch's ``ops.linalg``, ``ops.matrix`` and ``core.operators``
against raft_tpu's, on the CPU, on the same seeded numpy inputs.

Tolerances: fp32 results rtol 1e-5 with atol 1e-5 of the largest |value|
(sums taken in another order); ids, sort keys, integer and boolean outputs
equal. Decompositions are compared up to the sign of each vector
(|UᵀU'| ≈ I) or by reconstruction, with atol 1e-4 where an iterative or
orthogonalising step compounds fp32 rounding. ``rsvd``, ``lanczos`` and
``sample_rows`` take JAX's draws through the port's replaced draw helpers.
The sums by key are also held bitwise over two runs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import operators as jops_
from raft_tpu.ops import linalg as jlin
from raft_tpu.ops import matrix as jmat
from raft_tpu_torch.core import operators as tops_
from raft_tpu_torch.ops import linalg as tlin
from raft_tpu_torch.ops import matrix as tmat

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol_scale=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * max(scale, 1e-30))


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_up_to_sign(a, b, atol=1e-4):
    """Columns of a and b equal up to a sign each."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.sign(np.sum(a * b, axis=0))
    s[s == 0] = 1
    np.testing.assert_allclose(a * s, b, atol=atol)


# ----------------------------------------------------------- core.operators

UNARY = ["identity_op", "sq_op", "abs_op", "sqrt_op", "nz_op"]
BINARY = ["add_op", "sub_op", "mul_op", "div_op", "div_checkzero_op",
          "min_op", "max_op", "pow_op", "mod_op", "equal_op", "notequal_op",
          "greater_op", "less_op"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_operators(name):
    x = np.abs(_rand(5, 7))
    x[0, :3] = 0.0
    _close(getattr(tops_, name)(_t(x)), getattr(jops_, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", BINARY)
def test_binary_operators(name):
    a, b = np.abs(_rand(6, 5)) + 0.5, np.abs(_rand(6, 5, seed=1)) + 0.5
    b[1, 2] = 0.0
    b[2, 3] = a[2, 3]
    if name in ("div_op", "mod_op"):
        b[1, 2] = 1.0  # raft_tpu's 0-divisor gives inf/nan; not compared
    got = getattr(tops_, name)(_t(a), _t(b))
    want = getattr(jops_, name)(jnp.asarray(a), jnp.asarray(b))
    if got.dtype == torch.bool:
        _equal(got, want)
    else:
        _close(got, want)


def test_operator_combinators():
    x = _rand(4, 3)
    tx, jx = _t(x), jnp.asarray(x)
    f_t = tops_.compose_op(tops_.sqrt_op, tops_.abs_op,
                           tops_.add_const_op(2.0))
    f_j = jops_.compose_op(jops_.sqrt_op, jops_.abs_op,
                           jops_.add_const_op(2.0))
    _close(f_t(tx), f_j(jx))
    for name in ("add_const_op", "sub_const_op", "mul_const_op",
                 "div_const_op", "pow_const_op"):
        _close(getattr(tops_, name)(3.0)(tx.abs()),
               getattr(jops_, name)(3.0)(jnp.abs(jx)))
    m_t = tops_.map_args_op(tops_.add_op, tops_.sq_op, tops_.abs_op)
    m_j = jops_.map_args_op(jops_.add_op, jops_.sq_op, jops_.abs_op)
    _close(m_t(tx, -tx), m_j(jx, -jx))
    assert tops_.const_op(7)(tx, tx) == 7
    _close(tops_.plug_const_op(2.0, tops_.pow_op)(tx),
           jops_.plug_const_op(2.0, jops_.pow_op)(jx))


# -------------------------------------------------------- ops.linalg: BLAS


@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_gemm(trans_a, trans_b):
    a, b = _rand(12, 9), _rand(9, 7, seed=1)
    a = a.T.copy() if trans_a else a
    b = b.T.copy() if trans_b else b
    c = _rand(12, 7, seed=2)
    kw = dict(trans_a=trans_a, trans_b=trans_b, alpha=1.5, beta=0.25)
    _close(tlin.gemm(_t(a), _t(b), c=_t(c), **kw),
           jlin.gemm(a, b, c=c, **kw))
    _close(tlin.gemm(_t(a), _t(b), trans_a, trans_b),
           jlin.gemm(a, b, trans_a, trans_b))


@pytest.mark.parametrize("trans", [False, True])
def test_gemv_axpy_dot(trans):
    a, x = _rand(10, 10), _rand(10, seed=1)
    _close(tlin.gemv(_t(a), _t(x), trans, 2.0), jlin.gemv(a, x, trans, 2.0))
    y = _rand(10, seed=2)
    _close(tlin.axpy(0.5, _t(x), _t(y)), jlin.axpy(0.5, x, y))
    _close(tlin.dot(_t(x), _t(y)), jlin.dot(x, y))


# ----------------------------------------------- ops.linalg: kernel prims


def test_map_and_reductions():
    a, b = _rand(8, 6), _rand(8, 6, seed=1)
    _close(tlin.map(tops_.add_op, _t(a), _t(b)),
           jlin.map(jops_.add_op, a, b))
    _close(tlin.map_reduce(tops_.sq_op, torch.sum, _t(a)),
           jlin.map_reduce(jops_.sq_op, jnp.sum, a))
    for axis in (0, 1):
        _close(tlin.map_reduce(tops_.mul_op, torch.sum, _t(a), _t(b),
                               axis=axis),
               jlin.map_reduce(jops_.mul_op, jnp.sum, a, b, axis=axis))
    _close(tlin.coalesced_reduction(_t(a)), jlin.coalesced_reduction(a))
    _close(tlin.strided_reduction(_t(a)), jlin.strided_reduction(a))
    _close(tlin.coalesced_reduction(_t(a), torch.amax),
           jlin.coalesced_reduction(a, jnp.max))
    _close(tlin.strided_reduction(_t(a), torch.amin),
           jlin.strided_reduction(a, jnp.min))


@pytest.mark.parametrize("weighted", [False, True])
def test_reduce_rows_by_key(weighted):
    x = _rand(300, 16)
    keys = np.random.default_rng(3).integers(0, 7, 300).astype(np.int32)
    keys[keys == 4] = 5  # an empty key
    w = np.abs(_rand(300, seed=4)) if weighted else None
    got = tlin.reduce_rows_by_key(_t(x), _t(keys), 7,
                                  None if w is None else _t(w))
    _close(got, jlin.reduce_rows_by_key(x, keys, 7, w))
    again = tlin.reduce_rows_by_key(_t(x), _t(keys), 7,
                                    None if w is None else _t(w))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert float(got[4].abs().sum()) == 0.0


def test_reduce_cols_by_key_and_integer_keys():
    x = _rand(9, 40)
    keys = np.random.default_rng(5).integers(0, 6, 40).astype(np.int32)
    _close(tlin.reduce_cols_by_key(_t(x), _t(keys), 6),
           jlin.reduce_cols_by_key(x, keys, 6))
    xi = np.random.default_rng(6).integers(-5, 5, (30, 4)).astype(np.int32)
    ki = np.random.default_rng(7).integers(0, 3, 30).astype(np.int32)
    _equal(tlin.reduce_rows_by_key(_t(xi), _t(ki), 3),
           jlin.reduce_rows_by_key(xi, ki, 3))


def test_matrix_vector_op_norms_and_elementwise():
    m, v_row, v_col = _rand(6, 5), _rand(5, seed=1), _rand(6, seed=2)
    _close(tlin.matrix_vector_op(_t(m), _t(v_row)),
           jlin.matrix_vector_op(m, v_row))
    _close(tlin.matrix_vector_op(_t(m), _t(v_col), torch.mul, False),
           jlin.matrix_vector_op(m, v_col, jnp.multiply, False))
    for ord_ in ("l1", "l2", "linf"):
        for axis in (0, -1):
            for sqrt in (False, True):
                _close(tlin.norm(_t(m), ord_, axis, sqrt),
                       jlin.norm(m, ord_, axis, sqrt))
    with pytest.raises(ValueError):
        tlin.norm(_t(m), "l3")
    _close(tlin.normalize(_t(m)), jlin.normalize(m))
    _close(tlin.normalize(_t(m), axis=0), jlin.normalize(m, axis=0))
    b = _rand(6, 5, seed=3)
    _close(tlin.add(_t(m), _t(b)), jlin.add(m, b))
    _close(tlin.subtract(_t(m), _t(b)), jlin.subtract(m, b))
    _close(tlin.multiply_scalar(_t(m), 3.0), jlin.multiply_scalar(m, 3.0))
    _close(tlin.binary_op(_t(m), _t(b), torch.maximum),
           jlin.binary_op(m, b, jnp.maximum))
    _close(tlin.unary_op(_t(m), torch.exp), jlin.unary_op(m, jnp.exp))
    _close(tlin.transpose(_t(m)), jlin.transpose(m))
    cube = _rand(2, 3, 4)
    _close(tlin.transpose(_t(cube)), jlin.transpose(cube))


# -------------------------------------------- ops.linalg: decompositions


def test_qr_cholesky_eig():
    a = _rand(20, 8)
    q_t, q_j = tlin.qr_get_q(_t(a)), jlin.qr_get_q(a)
    _same_up_to_sign(q_t.numpy(), q_j)
    qt, rt = tlin.qr_get_qr(_t(a))
    _close(qt @ rt, a, atol_scale=1e-5)
    spd = (a.T @ a + np.eye(8, dtype=np.float32)).astype(np.float32)
    _close(tlin.cholesky(_t(spd)), jlin.cholesky(spd))
    _close(tlin.cholesky(_t(spd), lower=False), jlin.cholesky(spd, False))
    w_t, v_t = tlin.eig_dc(_t(spd))
    w_j, v_j = jlin.eig_dc(spd)
    _close(w_t, w_j)
    _same_up_to_sign(v_t.numpy(), v_j)
    w2, _ = tlin.eig_jacobi(_t(spd))
    assert torch.equal(w2, w_t)


@pytest.mark.parametrize("shape", [(30, 6), (6, 30)])
def test_svd_and_lstsq(shape):
    a = _rand(*shape)
    u_t, s_t, v_t = tlin.svd(_t(a))
    u_j, s_j, v_j = jlin.svd(a)
    _close(s_t, s_j)
    _same_up_to_sign(u_t.numpy(), u_j)
    _same_up_to_sign(v_t.numpy(), v_j)  # V, not Vᵀ, in both
    _close(u_t * s_t @ v_t.T, a, atol_scale=1e-5)
    u2, s2, v2 = tlin.svd_qr(_t(a))
    assert torch.equal(s2, s_t)
    if shape[0] > shape[1]:
        b = _rand(shape[0], 2, seed=1)
        _close(tlin.lstsq(_t(a), _t(b)), jlin.lstsq(a, b), atol_scale=1e-4)


def test_rsvd_with_jax_test_matrix(monkeypatch):
    rng = np.random.default_rng(8)
    a = (rng.standard_normal((200, 12)) @ rng.standard_normal((12, 40))
         + 0.01 * rng.standard_normal((200, 40))).astype(np.float32)
    key = jax.random.key(3)
    k, p = 5, 4
    omega = np.asarray(jax.random.normal(key, (40, k + p), jnp.float32))
    monkeypatch.setattr(tlin, "_gaussian_test_matrix",
                        lambda g, n, l: _t(omega))
    gen = torch.Generator(device="cpu")
    u_t, s_t, v_t = tlin.rsvd(gen, _t(a), k, p, 2)
    u_j, s_j, v_j = jlin.rsvd(key, a, k, p, 2)
    _close(s_t, s_j, rtol=1e-4, atol_scale=1e-5)
    _same_up_to_sign(u_t.numpy(), u_j)
    _same_up_to_sign(v_t.numpy(), v_j)
    exact = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:k]
    # the range finder itself: two power iterations leave ~5e-4 here
    np.testing.assert_allclose(s_t.numpy(), exact, rtol=2e-3)


def test_rsvd_draws_from_the_generator():
    a = _t(_rand(50, 10))
    g1, g2 = torch.Generator(device="cpu"), torch.Generator(device="cpu")
    g1.manual_seed(1)
    g2.manual_seed(1)
    r1, r2 = tlin.rsvd(g1, a, 3), tlin.rsvd(g2, a, 3)
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))


def _spd_with_spectrum(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # both ends of the spectrum stand apart, so 60 steps converge them
    lam = np.concatenate([[0.1, 0.5, 1.0], np.linspace(4.0, 6.0, n - 6),
                          [9.0, 12.0, 15.0]])
    return (q * lam @ q.T).astype(np.float32), lam


@pytest.mark.parametrize("which", ["smallest", "largest"])
def test_lanczos_with_jax_start_vector(monkeypatch, which):
    n, k = 120, 3
    a, lam = _spd_with_spectrum(n, 9)
    v0 = np.asarray(jax.random.normal(jax.random.key(0), (n,), jnp.float32))
    monkeypatch.setattr(tlin, "_start_vector", lambda g, n_: _t(v0))
    ta, ja = _t(a), jnp.asarray(a)
    w_t, v_t = tlin.lanczos(lambda v: ta @ v, n, k, ncv=60, which=which,
                            device="cpu")
    w_j, v_j = jlin.lanczos(lambda v: ja @ v, n, k, ncv=60, which=which)
    _close(w_t, w_j, rtol=1e-4, atol_scale=1e-4)
    _same_up_to_sign(v_t.numpy(), v_j, atol=2e-3)
    want = lam[-k:][::-1] if which == "largest" else lam[:k]
    np.testing.assert_allclose(w_t.numpy(), want, rtol=1e-3, atol=1e-4)


def test_lanczos_default_ncv_and_generator():
    n = 40
    a, _ = _spd_with_spectrum(n, 10)
    ta = _t(a)
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    w1, v1 = tlin.lanczos(lambda v: ta @ v, n, 2, generator=g)
    w2, v2 = tlin.lanczos(lambda v: ta @ v, n, 2, device="cpu")
    # no generator: one seeded with 0 on the device
    assert torch.equal(w1, w2) and torch.equal(v1, v2)
    assert w1.shape == (2,) and v1.shape == (n, 2)


# --------------------------------------------------------------- ops.matrix


def test_gather_scatter_slice():
    m = _rand(10, 6)
    idx = np.array([3, 0, 9, 3], np.int32)
    _close(tmat.gather(_t(m), _t(idx)), jmat.gather(m, idx))
    _close(tmat.gather(_t(m), _t(idx[:2]), axis=1), jmat.gather(m, idx[:2], 1))
    idx2 = np.array([[1, 2], [5, 0]], np.int32)
    _close(tmat.gather(_t(m), _t(idx2)), jmat.gather(m, idx2))
    mask = np.array([True, False, True, False])
    _close(tmat.gather_if(_t(m), _t(idx), _t(mask), fill=-1.0),
           jmat.gather_if(m, idx, mask, fill=-1.0))
    upd = _rand(2, 6, seed=1)
    _close(tmat.scatter(_t(m), _t(np.array([1, 7])), _t(upd)),
           jmat.scatter(m, np.array([1, 7]), upd))
    _close(tmat.slice(_t(m), 2, 5, 1, 4), jmat.slice(m, 2, 5, 1, 4))
    _close(tmat.slice(_t(m), 2, 5), jmat.slice(m, 2, 5))


def test_arg_and_sorts_with_ties():
    m = np.random.default_rng(11).integers(0, 4, (12, 9)).astype(np.float32)
    for axis in (0, 1):
        _equal(tmat.argmax(_t(m), axis), jmat.argmax(m, axis))
        _equal(tmat.argmin(_t(m), axis), jmat.argmin(m, axis))
    for fn in ("col_wise_sort", "row_wise_sort"):
        v_t, k_t = getattr(tmat, fn)(_t(m), return_keys=True)
        v_j, k_j = getattr(jmat, fn)(m, return_keys=True)
        _equal(v_t, v_j)
        _equal(k_t, k_j)
        assert k_t.dtype == torch.int32
        _equal(getattr(tmat, fn)(_t(m)), getattr(jmat, fn)(m))


def test_linewise_init_diagonal_triangular():
    m, v = _rand(5, 4), _rand(4, seed=1)
    _close(tmat.linewise_op(_t(m), _t(v), torch.add),
           jmat.linewise_op(m, v, jnp.add))
    w = _rand(5, seed=2)
    _close(tmat.linewise_op(_t(m), _t(w), torch.mul, False),
           jmat.linewise_op(m, w, jnp.multiply, False))
    for axis in (0, 1):
        _close(tmat.reverse(_t(m), axis), jmat.reverse(m, axis))
    _close(tmat.init((3, 2), 1.5, device="cpu"), jmat.init((3, 2), 1.5))
    _close(tmat.eye(4, device="cpu"), jmat.eye(4))
    _close(tmat.diagonal(_t(m)), jmat.diagonal(m))
    d = _rand(4, seed=3)
    _close(tmat.set_diagonal(_t(m), _t(d)), jmat.set_diagonal(m, d))
    _close(tmat.upper_triangular(_t(m)), jmat.upper_triangular(m))
    _close(tmat.lower_triangular(_t(m)), jmat.lower_triangular(m))
    pos = np.abs(m)
    _close(tmat.ratio(_t(pos)), jmat.ratio(pos))
    _close(tmat.weighted_mean(_t(m), _t(v)), jmat.weighted_mean(m, v))
    _close(tmat.weighted_mean(_t(m), _t(w), False),
           jmat.weighted_mean(m, w, False))


@pytest.mark.parametrize("replace", [False, True])
def test_sample_rows_with_jax_ids(monkeypatch, replace):
    m = _rand(50, 3)
    key = jax.random.key(5)
    ids = np.asarray(jax.random.choice(key, 50, (20,), replace=replace))
    monkeypatch.setattr(tmat, "_sample_row_ids",
                        lambda g, n, s, r: _t(ids.astype(np.int64)))
    got = tmat.sample_rows(torch.Generator(device="cpu"), _t(m), 20, replace)
    _equal(got, jmat.sample_rows(key, m, 20, replace=replace))


def test_sample_rows_draws():
    g = torch.Generator(device="cpu")
    g.manual_seed(2)
    rows = tmat.sample_rows(g, _t(np.arange(100, dtype=np.float32)[:, None]),
                            30)
    assert rows.shape == (30, 1) and len(set(rows[:, 0].tolist())) == 30


def test_select_k_reexport_leaves_ops_select_k_the_function():
    import raft_tpu_torch.ops as tops

    importlib.reload(tmat)
    assert tmat.select_k is tops.select_k and callable(tops.select_k)
    assert tmat.SelectAlgo is tops.SelectAlgo
    v = _rand(4, 50)
    got = tmat.select_k(_t(v), 5)
    want = jmat.select_k(v, 5)
    _equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
