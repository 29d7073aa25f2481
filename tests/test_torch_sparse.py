"""raft_tpu_torch's ``sparse`` (types, convert, linalg, op, selection) and
``ops.kernels`` against raft_tpu's, on the CPU, on the same seeded numpy
inputs (the containers carried by ``interop.csr_from_numpy`` /
``coo_from_numpy``).

Tolerances: fp32 values rtol 1e-5 with atol 1e-5 of the largest |value|
(sums in another order); index arrays, counts, degrees, kept counts and
selected ids equal. The Gram matrices are held on dense, CSR and mixed
operands, CSR × CSR both ways round (the smaller operand is densified in
both packages). The sums that raft_tpu scatter-adds (spmm, spmv, the
norms, symmetrize, the duplicate sums, densification) are also held
bitwise over two runs, and spmm cut into pieces by a small
``PIECE_BYTES`` within the tolerance of one piece.
"""

import numpy as np
import pytest
import torch

from raft_tpu.ops import kernels as jk
from raft_tpu.sparse import convert as jconv
from raft_tpu.sparse import linalg as jsl
from raft_tpu.sparse import op as jop
from raft_tpu.sparse import selection as jsel
from raft_tpu.sparse import types as jtypes
from raft_tpu_torch import interop
from raft_tpu_torch.ops import kernels as tk
from raft_tpu_torch.sparse import convert as tconv
from raft_tpu_torch.sparse import linalg as tsl
from raft_tpu_torch.sparse import op as top
from raft_tpu_torch.sparse import selection as tsel
from raft_tpu_torch.sparse import types as ttypes

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want[np.isfinite(want)]), initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * max(scale, 1e-30))


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) \
        if a.dtype == torch.float32 else torch.equal(a, b)


def _t(a):
    return torch.from_numpy(np.array(a))


def _coo_arrays(n=40, m=30, nnz=180, seed=0, dup=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, m, nnz).astype(np.int32)
    if dup:
        rows[:10], cols[:10] = rows[10:20], cols[10:20]  # duplicates
    data = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, data, (n, m)


def _pair_coo(**kw):
    r, c, d, shape = _coo_arrays(**kw)
    return (jtypes.coo_from_arrays(r, c, d, shape),
            interop.coo_from_numpy(r, c, d, shape, device="cpu"))


def _pair_csr(n=40, m=30, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, m)).astype(np.float32)
    dense[rng.random((n, m)) > density] = 0.0
    dense[3] = 0.0  # an empty row
    j = jconv.dense_to_csr(dense)
    t = interop.csr_from_numpy(np.asarray(j.indptr), np.asarray(j.indices),
                               np.asarray(j.data), j.shape, device="cpu")
    return j, t, dense


def _coo_equal(t, j, data_close=True):
    _equal(t.rows, j.rows)
    _equal(t.cols, j.cols)
    (_close if data_close else _equal)(t.data, j.data)
    assert t.shape == tuple(j.shape)


def _csr_equal(t, j):
    _equal(t.indptr, j.indptr)
    _equal(t.indices, j.indices)
    _close(t.data, j.data)
    assert t.shape == tuple(j.shape)


# ------------------------------------------------------------------ types


def test_containers_and_row_ids():
    j, t, _ = _pair_csr()
    assert (t.nnz, t.n_rows, t.n_cols) == (j.nnz, j.n_rows, j.n_cols)
    assert t.indptr.dtype == t.indices.dtype == torch.int32
    _equal(t.row_ids(), j.row_ids())
    assert t.row_ids().dtype == torch.int32
    r, c, d, shape = _coo_arrays()
    coo = ttypes.coo_from_arrays(r, c, d.astype(np.float64), shape,
                                 device="cpu")
    jcoo = jtypes.coo_from_arrays(r, c, d.astype(np.float64), shape)
    assert str(coo.dtype).split(".")[-1] == str(jcoo.dtype)  # float32
    assert coo.nnz == jcoo.nnz and coo.rows.dtype == torch.int32
    csr = ttypes.csr_from_scipy_like(_t(np.asarray(j.indptr)),
                                     _t(np.asarray(j.indices)),
                                     _t(np.asarray(j.data)), j.shape)
    assert csr.indptr.device.type == "cpu"  # placed where its tensors are


# ---------------------------------------------------------------- convert


def test_coo_sort_and_csr_round_trip():
    jc, tc = _pair_coo()
    _coo_equal(tconv.coo_sort(tc), jconv.coo_sort(jc), data_close=False)
    _csr_equal(tconv.coo_to_csr(tc), jconv.coo_to_csr(jc))
    srt_t, srt_j = tconv.coo_sort(tc), jconv.coo_sort(jc)
    _csr_equal(tconv.coo_to_csr(srt_t, assume_sorted=True),
               jconv.coo_to_csr(srt_j, assume_sorted=True))
    j, t, _ = _pair_csr()
    _coo_equal(tconv.csr_to_coo(t), jconv.csr_to_coo(j))


def test_densify_sums_duplicates_deterministically():
    jc, tc = _pair_coo()
    got = tconv.coo_to_dense(tc)
    _close(got, jconv.coo_to_dense(jc))
    assert _bitwise(got, tconv.coo_to_dense(tc))
    j, t, dense = _pair_csr()
    _close(tconv.csr_to_dense(t), jconv.csr_to_dense(j))
    np.testing.assert_array_equal(tconv.csr_to_dense(t).numpy(), dense)


@pytest.mark.parametrize("nnz", [None, 50, 400])
def test_dense_to_csr_static_nnz(nnz):
    _, _, dense = _pair_csr()
    _csr_equal(tconv.dense_to_csr(_t(dense), nnz),
               jconv.dense_to_csr(dense, nnz))


def test_negative_padding_rows_count_from_the_end():
    jc, tc = _pair_coo()
    jr, _ = jop.coo_remove_scalar(jc, float(np.asarray(jc.data)[5]))
    tr, _ = top.coo_remove_scalar(tc, float(tc.data[5]))
    _close(tconv.coo_to_dense(tr), jconv.coo_to_dense(jr))
    _csr_equal(tconv.coo_to_csr(tr), jconv.coo_to_csr(jr))


# ----------------------------------------------------------------- linalg


def test_spmm_spmv_sddmm(monkeypatch):
    j, t, _ = _pair_csr()
    rng = np.random.default_rng(1)
    b = rng.standard_normal((30, 7)).astype(np.float32)
    got = tsl.spmm(t, _t(b), alpha=2.0)
    _close(got, jsl.spmm(j, b, alpha=2.0))
    assert _bitwise(got, tsl.spmm(t, _t(b), alpha=2.0))
    monkeypatch.setattr(tsl, "PIECE_BYTES", 7 * 4 * 9)  # 9 entries a piece
    pieces = tsl.spmm(t, _t(b), alpha=2.0)
    _close(pieces, np.asarray(jsl.spmm(j, b, alpha=2.0)))
    assert _bitwise(pieces, tsl.spmm(t, _t(b), alpha=2.0))
    v = rng.standard_normal(30).astype(np.float32)
    got = tsl.spmv(t, _t(v))
    _close(got, jsl.spmv(j, v))
    assert _bitwise(got, tsl.spmv(t, _t(v)))
    a = rng.standard_normal((40, 5)).astype(np.float32)
    bb = rng.standard_normal((30, 5)).astype(np.float32)
    _csr_equal(tsl.sddmm(_t(a), _t(bb), t, 0.5), jsl.sddmm(a, bb, j, 0.5))


@pytest.mark.parametrize("ord_", ["l1", "l2", "linf"])
def test_degree_norms_normalize(ord_):
    j, t, _ = _pair_csr()
    _equal(tsl.degree(t), jsl.degree(j))
    got = tsl.row_norm(t, ord_)
    _close(got, jsl.row_norm(j, ord_))
    assert _bitwise(got, tsl.row_norm(t, ord_))
    _csr_equal(tsl.row_normalize(t, ord_), jsl.row_normalize(j, ord_))
    with pytest.raises(ValueError):
        tsl.row_norm(t, "l3")


def test_transpose_and_laplacian():
    j, t, _ = _pair_csr()
    _csr_equal(tsl.transpose(t), jsl.transpose(j))
    sq_j, sq_t, _ = _pair_csr(n=25, m=25, seed=4)
    for normalized in (False, True):
        _close(tsl.laplacian(sq_t, normalized),
               jsl.laplacian(sq_j, normalized))


@pytest.mark.parametrize("op_", ["max", "sum", "mean"])
def test_symmetrize(op_):
    jc, tc = _pair_coo(n=30, m=30, nnz=150)
    got = tsl.symmetrize(tc, op_)
    _coo_equal(got, jsl.symmetrize(jc, op_))
    assert _bitwise(got.data, tsl.symmetrize(tc, op_).data)
    with pytest.raises(ValueError):
        tsl.symmetrize(tc, "min")


# --------------------------------------------------------------------- op


def test_filters_keep_static_nnz():
    jc, tc = _pair_coo()
    zero = np.asarray(jc.data).copy()
    zero[::7] = 0.0
    jz = jtypes.coo_from_arrays(np.asarray(jc.rows), np.asarray(jc.cols),
                                zero, jc.shape)
    tz = interop.coo_from_numpy(np.asarray(jc.rows), np.asarray(jc.cols),
                                zero, jc.shape, device="cpu")
    got, n_t = top.coo_remove_zeros(tz)
    want, n_j = jop.coo_remove_zeros(jz)
    _coo_equal(got, want, data_close=False)
    assert int(n_t) == int(n_j) and n_t.dtype == torch.int32
    s = float(zero[3])
    got, n_t = top.coo_remove_scalar(tz, s)
    want, n_j = jop.coo_remove_scalar(jz, s)
    _coo_equal(got, want, data_close=False)
    assert int(n_t) == int(n_j)


def test_duplicate_reductions_and_sort():
    jc, tc = _pair_coo()
    jr, _ = jop.coo_remove_scalar(jc, float(np.asarray(jc.data)[25]))
    tr, _ = top.coo_remove_scalar(tc, float(tc.data[25]))
    got = top.coo_sum_duplicates(tr)
    _coo_equal(got, jop.coo_sum_duplicates(jr))
    assert _bitwise(got.data, top.coo_sum_duplicates(tr).data)
    _coo_equal(top.coo_max_duplicates(tr), jop.coo_max_duplicates(jr),
               data_close=False)
    _coo_equal(top.coo_sort(tr), jop.coo_sort(jr), data_close=False)


def test_row_op_and_row_slice():
    j, t, _ = _pair_csr()
    _csr_equal(top.csr_row_op(t, lambda r, v: v * (r.to(v.dtype) + 1.0)),
               jop.csr_row_op(j, lambda r, v: v * (r + 1.0)))
    _csr_equal(top.csr_row_slice(t, 2, 17), jop.csr_row_slice(j, 2, 17))


# -------------------------------------------------------------- selection


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [3, 12, 40])
def test_sparse_select_k(select_min, k):
    j, t, _ = _pair_csr()
    v_t, i_t = tsel.select_k(t, k, select_min)
    v_j, i_j = jsel.select_k(j, k, select_min)
    _equal(v_t, v_j)
    _equal(i_t, i_j)


# ------------------------------------------------------------ ops.kernels

KERNELS = [tk.KernelParams(tk.KernelType.LINEAR),
           tk.KernelParams(tk.KernelType.POLYNOMIAL, 3, 0.5, 1.0),
           tk.KernelParams(tk.KernelType.TANH, 3, 0.1, 0.2),
           tk.KernelParams(tk.KernelType.RBF, 3, 0.05, 0.0)]


def _j_params(p):
    return jk.KernelParams(jk.KernelType(int(p.kernel)), p.degree, p.gamma,
                           p.coef0)


def _operands(kind, seed):
    j, t, dense = _pair_csr(n=20 + 5 * seed, m=16, density=0.3, seed=seed)
    if kind == "csr":
        return j, t
    return dense, _t(dense)


@pytest.mark.parametrize("params", KERNELS, ids=lambda p: p.kernel.name)
@pytest.mark.parametrize("kinds", [("dense", "dense"), ("csr", "dense"),
                                   ("dense", "csr"), ("csr", "csr"),
                                   ("csr_big", "csr")])
def test_gram_matrix(params, kinds):
    # "csr_big": a CSR × CSR pair whose first operand has more rows
    xj, xt = _operands("csr" if kinds[0] == "csr_big" else kinds[0],
                       2 if kinds[0] == "csr_big" else 0)
    yj, yt = _operands(kinds[1], 1)
    got = tk.gram_matrix(xt, yt, params)
    _close(got, jk.gram_matrix(xj, yj, _j_params(params)))
    assert got.dtype == torch.float32


def test_rbf_with_cached_norms_and_unknown_kernel():
    x = np.random.default_rng(6).standard_normal((9, 5)).astype(np.float32)
    y = np.random.default_rng(7).standard_normal((11, 5)).astype(np.float32)
    nx, ny = (x * x).sum(1), (y * y).sum(1)
    _close(tk.rbf_kernel(_t(x), _t(y), 0.3, _t(nx), _t(ny)),
           jk.rbf_kernel(x, y, 0.3, nx, ny))
    for name in ("linear_kernel", "polynomial_kernel", "tanh_kernel"):
        _close(getattr(tk, name)(_t(x), _t(y)), getattr(jk, name)(x, y))
    with pytest.raises(ValueError):
        tk.gram_matrix(_t(x), _t(y), tk.KernelParams(kernel=7))
