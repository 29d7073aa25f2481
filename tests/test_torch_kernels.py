"""raft_tpu_torch.ops.gpu_kernels: each kernel's plain version against the
JAX package's Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances: distances rtol 1e-5, atol 1e-4·max‖x‖² (fp32 sums taken in
another order); ids equal away from near-ties, near-ties as sets
(``raft_tpu_torch.testing.assert_topk_close``). Selection alone does no
arithmetic, so select_k is held to exact values. The kernels themselves run
only on a CUDA card: tests/test_torch_cuda.py holds them against these plain
versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import pallas_kernels as pk
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.testing import assert_topk_close


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _l2_tol(*arrays):
    return 1e-4 * max(float((np.asarray(a, np.float32) ** 2).sum(-1).max())
                      for a in arrays)


# ------------------------------------------------------------ fused_l2_topk


@pytest.mark.parametrize("k", [1, 10, 64])
def test_fused_l2_topk_plain_matches_pallas(k):
    # tn=128 over n=300: the JAX carry merges across three db tiles
    rng = np.random.default_rng(0)
    x = rng.standard_normal((23, 16)).astype(np.float32)
    y = rng.standard_normal((300, 16)).astype(np.float32)
    want = pk.fused_l2_topk(x, y, k, tm=8, tn=128, interpret=True)
    got = gk.fused_l2_topk(_t(x), _t(y), k)
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32
    assert_topk_close(got, want, _l2_tol(x, y), 1e-5)


def test_fused_l2_topk_plain_k_exceeds_rows():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 8)).astype(np.float32)
    y = rng.standard_normal((20, 8)).astype(np.float32)
    want = pk.fused_l2_topk(x, y, 64, tm=8, tn=128, interpret=True)
    got = gk.fused_l2_topk(_t(x), _t(y), 64)
    assert_topk_close(got, want, _l2_tol(x, y), 1e-5)
    assert bool((got[1][:, 20:] == -1).all())
    assert bool(torch.isinf(got[0][:, 20:]).all())


def test_fused_l2_topk_ties_resolve_by_row_id():
    # duplicated rows: equal distances come back in row-id order, as the
    # TPU carry's first-occurrence argmin orders them
    rng = np.random.default_rng(2)
    base = rng.standard_normal((40, 8)).astype(np.float32)
    y = np.concatenate([base, base, base])
    x = base[:5]
    want = pk.fused_l2_topk(x, y, 9, tm=8, tn=128, interpret=True)
    got = gk.fused_l2_topk(_t(x), _t(y), 9)
    np.testing.assert_array_equal(got[1].numpy()[:, :3], np.asarray(want[1])[:, :3])
    np.testing.assert_array_equal(got[1].numpy()[:, :3],
                                  np.arange(5)[:, None] + np.array([0, 40, 80]))


@pytest.mark.parametrize("k", [0, 1025])
def test_fused_kernels_reject_k_out_of_range(k):
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="small-k"):
        gk.fused_l2_topk(x, x, k)
    with pytest.raises(ValueError, match="small-k"):
        gk.streaming_select_k(x, k)


@pytest.mark.parametrize("m,n,k", [(10000, 1_000_000, 10), (1000, 1_000_000, 10),
                                   (64, 5000, 1024), (3, 100, 300)])
def test_plan_fused_topk_fits_shared_memory(m, n, k):
    tm, splits = gk.plan_fused_topk(m, n, k, 132)
    assert tm in (16, 64)
    assert gk.l2_topk_smem_bytes(tm, k) <= gk.SMEM_LIMIT
    assert 1 <= splits and (splits == 1 or n // splits >= 8 * 128)


def test_gpu_wrappers_never_take_the_plain_version_off_the_cpu():
    # a tensor that is not on the CPU launches the kernel or raises
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gk.fused_l2_topk(x, x, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        gk.streaming_select_k(x, 2)


# ----------------------------------------------------------- fused_ivf_topk


def _ivf_inputs(seed, L, pad, rot, nq, P):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((L, pad, rot)).astype(np.float32)
    ids = np.arange(L * pad, dtype=np.int32).reshape(L, pad)
    ids[:, -5:] = -1  # ragged tails: unfilled slots
    probes = rng.integers(0, L, (nq, P)).astype(np.int32)
    qres = rng.standard_normal((nq, P, rot)).astype(np.float32)
    return data, ids, probes, qres


@pytest.mark.parametrize("k", [1, 10])
def test_fused_ivf_topk_plain_matches_pallas_across_tiles_and_probes(k):
    # pad_tile=8 over list_pad=24: the JAX carry merges across slab tiles
    # and probes
    data, ids, probes, qres = _ivf_inputs(3, 6, 24, 16, 5, 3)
    norms = (data ** 2).sum(-1)
    qn = (qres ** 2).sum(-1)
    want = pk.fused_ivf_topk(probes, qres, qn, data, norms, ids, k,
                             pad_tile=8, clamp=True, interpret=True)
    got = gk.fused_ivf_topk(_t(probes), _t(qres), _t(qn), _t(data), _t(norms),
                            _t(ids), k, clamp=True)
    assert_topk_close(got, want, _l2_tol(data.reshape(-1, 16), qres.reshape(-1, 16)),
                      1e-5)


def test_fused_ivf_topk_plain_bf16_lists_fp32_accumulation():
    data32, ids, probes, qres = _ivf_inputs(4, 4, 16, 8, 4, 2)
    data_bf = data32.astype(jnp.bfloat16)
    data_up = np.asarray(data_bf, np.float32)
    norms = (data_up ** 2).sum(-1)
    qn = (qres ** 2).sum(-1)
    want = pk.fused_ivf_topk(probes, qres, qn, data_bf, norms, ids, 6,
                             pad_tile=8, clamp=False, interpret=True)
    got = gk.fused_ivf_topk(_t(probes), _t(qres), _t(qn),
                            _t(data_up).to(torch.bfloat16), _t(norms),
                            _t(ids), 6, clamp=False)
    assert_topk_close(got, want, _l2_tol(data_up.reshape(-1, 8), qres.reshape(-1, 8)),
                      1e-5)


def test_fused_ivf_topk_plain_more_k_than_candidates():
    data, ids, probes, qres = _ivf_inputs(5, 3, 8, 4, 2, 1)
    norms = (data ** 2).sum(-1)
    qn = (qres ** 2).sum(-1)
    want = pk.fused_ivf_topk(probes, qres, qn, data, norms, ids, 10,
                             pad_tile=8, clamp=True, interpret=True)
    got = gk.fused_ivf_topk(_t(probes), _t(qres), _t(qn), _t(data), _t(norms),
                            _t(ids), 10, clamp=True)
    assert_topk_close(got, want, _l2_tol(data.reshape(-1, 4), qres.reshape(-1, 4)),
                      1e-5)
    assert bool((got[1][:, 3:] == -1).all())  # 3 valid slots per list


# ------------------------------------------------------------------ select_k


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_streaming_select_k_plain_matches_pallas(k, select_min):
    rng = np.random.default_rng(6)
    v = rng.standard_normal((13, 700)).astype(np.float32)
    v[0, :650] = np.inf if select_min else -np.inf  # exhausted row → -1 ids
    want = pk.pallas_select_k(v, k, select_min=select_min, tn=256,
                              interpret=True)
    got = gk.streaming_select_k(_t(v), k, select_min)
    assert_topk_close(got, want, 0.0, 0.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
