"""The hand-written kernels on a CUDA card against their plain PyTorch
versions. Without a card every test here skips: a CUDA kernel has no CPU
mode. This file imports neither jax nor raft_tpu, so it also runs on a
machine with PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: distances rtol 1e-5 and atol 1e-4·max‖x‖² (fp32 sums taken in
another order); ids equal away from near-ties, near-ties as sets; select_k
does no arithmetic and is held to equality.
"""

import pytest
import torch

from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.testing import assert_topk_close

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


@pytest.mark.parametrize("m,n,d,k", [(23, 300, 16, 1), (23, 300, 16, 64),
                                     (9, 20, 8, 64), (70, 1000, 40, 300),
                                     (5, 50000, 128, 10), (130, 3000, 33, 1024)])
def test_fused_l2_topk_kernel_matches_plain(dev, m, n, d, k):
    x, y = _randn(dev, m, d, seed=1), _randn(dev, n, d, seed=2)
    before = gk.LAUNCHES["fused_l2_topk"]
    got = gk.fused_l2_topk(x, y, k)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_l2_topk"] == before + 1
    assert_topk_close(got, gk.fused_l2_topk_plain(x, y, k),
                      1e-4 * float((y * y).sum(1).max()), 1e-5)


def test_fused_l2_topk_kernel_ties_resolve_by_row_id(dev):
    base = _randn(dev, 40, 8, seed=3)
    y = torch.cat([base, base, base])
    got = gk.fused_l2_topk(base[:5], y, 3)
    torch.cuda.synchronize()
    want = torch.arange(5, device=dev)[:, None] + torch.tensor([0, 40, 80],
                                                               device=dev)
    assert torch.equal(got[1], want.to(torch.int32))


@pytest.mark.parametrize("L,pad,rot,nq,P,dtype,clamp,k", [
    (50, 600, 128, 64, 8, torch.float32, True, 10),
    (50, 600, 128, 64, 8, torch.bfloat16, False, 32),
    (50, 600, 128, 64, 8, torch.float32, True, 1024),
    (6, 300, 20, 9, 3, torch.float32, True, 64),   # rot not a lane multiple
    (3, 8, 4, 2, 1, torch.float32, True, 10),      # fewer candidates than k
])
def test_fused_ivf_topk_kernel_matches_plain(dev, L, pad, rot, nq, P, dtype,
                                             clamp, k):
    data = _randn(dev, L, pad, rot, seed=4).to(dtype)
    ids = torch.arange(L * pad, device=dev, dtype=torch.int32).reshape(L, pad)
    ids[:, -5:] = -1  # unfilled slots
    norms = (data.float() ** 2).sum(-1)
    g = torch.Generator(device=dev).manual_seed(5)
    probes = torch.randint(0, L, (nq, P), generator=g, device=dev,
                           dtype=torch.int32)
    qres = _randn(dev, nq, P, rot, seed=6)
    args = (probes, qres, (qres ** 2).sum(-1), data, norms, ids, k, clamp)
    got = gk.fused_ivf_topk(*args)
    torch.cuda.synchronize()
    assert_topk_close(got, gk.fused_ivf_topk_plain(*args),
                      1e-4 * float(norms.max()), 1e-5)


@pytest.mark.parametrize("b,n,k,select_min", [(1000, 1024, 32, True),
                                              (333, 5000, 1024, False),
                                              (7, 50, 5, True),
                                              (3, 10, 20, True)])
def test_streaming_select_k_kernel_matches_plain(dev, b, n, k, select_min):
    v = _randn(dev, b, n, seed=7)
    v[0, : n // 2] = torch.inf if select_min else -torch.inf
    got = gk.streaming_select_k(v, k, select_min)
    torch.cuda.synchronize()
    want = gk.streaming_select_k_plain(v, k, select_min)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrappers_check_their_inputs(dev):
    x = _randn(dev, 8, 16)
    with pytest.raises(TypeError, match="dtype"):
        gk.fused_l2_topk(x.double(), x.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        gk.streaming_select_k(x.T, 3)
    with pytest.raises(ValueError, match="is on"):
        gk.fused_l2_topk(x, x.cpu(), 3)
