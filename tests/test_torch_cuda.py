"""The hand-written kernels on a CUDA card against their plain PyTorch
versions. Without a card every test here skips: a CUDA kernel has no CPU
mode. This file imports neither jax nor raft_tpu, so it also runs on a
machine with PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: distances rtol 1e-5 and atol 1e-4·max‖x‖² (fp32 sums taken in
another order; for fused_pq_topk and the IVF-PQ engines the largest ADC
distance stands for max‖x‖²; an fp8 LUT adds two e4m3 steps of the
largest LUT entry, as an entry may round the other way on the card); ids
equal away from near-ties, near-ties as sets, and for the IVF-PQ engines at
least 90% equal; select_k does no arithmetic and is held to equality.
fused_cagra_topk is held to bitwise equality with its plain version (the
plain version repeats the kernel's products and its order of additions),
and so is the CAGRA kernel engine on the card with its CPU run.
"""

import pytest
import torch

from raft_tpu_torch import interop
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import cagra, ivf_pq
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.stats import neighborhood_recall
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


def _pq_inputs(dev, L, pad, pq_dim, pq_len, nq, P, seed=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    rot = pq_dim * pq_len
    centers = _randn(dev, L, rot, seed=seed + 1)
    q_rot = _randn(dev, nq, rot, seed=seed + 2)
    cb = _randn(dev, pq_dim, 256, pq_len, seed=seed + 3)
    codes = torch.randint(0, 256, (L, pad, pq_dim), generator=g, device=dev,
                          dtype=torch.uint8)
    ids = torch.arange(L * pad, device=dev, dtype=torch.int32).reshape(L, pad)
    ids[:, -7:] = -1  # unfilled slots
    probes = torch.randint(0, L, (nq, P), generator=g, device=dev,
                           dtype=torch.int32)
    return probes, q_rot, centers, cb, (cb * cb).sum(-1), codes, ids


@pytest.mark.parametrize("k", [1, 10, 256, 1024])
@pytest.mark.parametrize("pq_dim,pq_len", [(8, 4), (64, 2), (128, 1)])
def test_fused_pq_topk_kernel_matches_plain(dev, k, pq_dim, pq_len):
    args = _pq_inputs(dev, 40, 700, pq_dim, pq_len, 33, 6)
    before = gk.LAUNCHES["fused_pq_topk"]
    got = gk.fused_pq_topk(*args, k)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_pq_topk"] == before + 1
    want = gk.fused_pq_topk_plain(*args, k)
    scale = float(want[0][torch.isfinite(want[0])].abs().max())
    assert_topk_close(got, want, 1e-4 * scale, 1e-5)


def test_fused_pq_topk_kernel_pads_and_resolves_ties(dev):
    # fewer valid slots than k (the tail is -1), and two lists holding the
    # same codes: equal distances resolve in (probe, slot) order
    probes, q_rot, centers, cb, cbn, codes, ids = _pq_inputs(
        dev, 4, 24, 16, 2, 5, 3, seed=9)
    codes[1] = codes[0]
    centers[1] = centers[0]
    probes[:, :2] = torch.tensor([1, 0], device=dev, dtype=torch.int32)
    args = (probes, q_rot, centers, cb, cbn, codes, ids)
    got = gk.fused_pq_topk(*args, 80)
    torch.cuda.synchronize()
    want = gk.fused_pq_topk_plain(*args, 80)
    assert torch.equal(got[1], want[1])
    assert bool((got[1][:, -10:] == -1).all())
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)


def test_wrappers_check_their_inputs(dev):
    x = _randn(dev, 8, 16)
    with pytest.raises(TypeError, match="dtype"):
        gk.fused_l2_topk(x.double(), x.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        gk.streaming_select_k(x.T, 3)
    with pytest.raises(ValueError, match="is on"):
        gk.fused_l2_topk(x, x.cpu(), 3)
    args = _pq_inputs(dev, 4, 16, 232, 1, 2, 2)
    with pytest.raises(ValueError, match="shared memory"):
        gk.fused_pq_topk(*args, 1024)


@pytest.mark.parametrize("engine,lut_dtype", [
    ("pallas_cache", "float32"), ("pallas_lut", "float32"),
    ("cache", "float32"), ("lut", "float32"), ("lut", "float8_e4m3fn")])
def test_ivf_pq_engines_on_the_card_match_the_cpu(dev, engine, lut_dtype):
    # one CPU build, carried to the card; every engine against its run on
    # the CPU (the kernels' plain versions there)
    g = torch.Generator().manual_seed(11)
    db = torch.randn(4000, 32, generator=g)
    q = torch.randn(50, 32, generator=g)
    cpu = ivf_pq.build(db, ivf_pq.IndexParams(n_lists=16, pq_dim=16),
                       device="cpu")
    card = interop.ivf_pq_index_from_numpy(
        cpu.params, cpu.pq_dim, *(t.numpy() for t in (
            cpu.centers, cpu.rotation, cpu.codebooks, cpu.list_codes,
            cpu.list_indices, cpu.list_sizes)), cpu.n_rows,
        *(t.numpy() for t in (cpu.overflow_codes, cpu.overflow_labels,
                              cpu.overflow_indices)), device=dev)
    mode = {"pallas_cache": "auto", "pallas_lut": "auto"}.get(engine, engine)
    sp = ivf_pq.SearchParams(n_probes=6, scan_mode=mode, lut_dtype=lut_dtype)
    memory = (sum(ivf_pq.scan_memory_bytes(cpu)) if engine == "pallas_lut"
              else None)
    res = Resources(device=dev, device_memory_bytes=memory)
    assert ivf_pq.plan_search(card, 10, sp, res=res).engine == engine
    gk.reset_launch_counts()
    got = ivf_pq.search(card, q, 10, sp, res=res)
    torch.cuda.synchronize()
    kernel = {"pallas_cache": "fused_ivf_topk",
              "pallas_lut": "fused_pq_topk"}.get(engine)
    if kernel is not None:
        assert gk.LAUNCHES[kernel] == 1
    want = ivf_pq.search(cpu, q, 10, sp, res=Resources(
        device="cpu", device_memory_bytes=memory))
    atol = 1e-4 * float(want[0].abs().max())
    if lut_dtype == "float8_e4m3fn":
        # the card's float32 LUT differs from the CPU's in the last bits, so
        # an fp8 entry may round the other way: one e4m3 step, at most 1/16
        # of its subspace's max-abs, allowed for two entries of a candidate
        atol += 2 * _lut_abs_max(cpu, q) / 16
    agree = assert_topk_close(got, want, atol, 1e-5)
    assert agree["id_agreement"] >= 0.9, agree


def _lut_abs_max(index, queries) -> float:
    """The largest |entry| of the float32 L2 LUTs (‖cb‖² − 2⟨res, cb⟩ per
    subspace) that ``queries`` build against any list of a PER_SUBSPACE
    ``index``: the largest scale of an fp8 LUT."""
    q_rot = queries @ index.rotation.T
    res = q_rot[:, None, :] - index.centers_rot[None]
    sub = res.reshape(*res.shape[:2], index.pq_dim, index.pq_len)
    cb = index.codebooks
    lut = (cb * cb).sum(-1) - 2 * torch.einsum("qlsj,scj->qlsc", sub, cb)
    return float(lut.abs().max())


def _cagra_inputs(dev, n, dim, degree, nq, n_seeds, seed=12):
    g = torch.Generator(device=dev).manual_seed(seed)
    data = _randn(dev, n, dim, seed=seed + 1)
    q = _randn(dev, nq, dim, seed=seed + 2)
    graph = torch.randint(0, n, (n, degree), generator=g, device=dev,
                          dtype=torch.int32)
    graph[::7, :3] = -1  # invalid edges
    graph[3, 0] = n + 5  # an id outside [0, n) is invalid too
    seeds = torch.randint(0, n, (nq, n_seeds), generator=g, device=dev,
                          dtype=torch.int32)
    return q, data, graph, seeds, (q * q).sum(1)


def _cagra_both(args, k, itopk, width):
    max_iter = gk.resolve_max_iter(max(itopk, k), width, 0)
    before = gk.LAUNCHES["fused_cagra_topk"]
    got = gk.fused_cagra_topk(*args, k, itopk, width, 0)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_cagra_topk"] == before + 1
    want = gk.fused_cagra_topk_plain(*args, k, itopk, width, max_iter)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    return got, want


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("itopk", [16, 64, 256, 1024])
@pytest.mark.parametrize("width", [1, 4])
def test_fused_cagra_topk_kernel_matches_plain(dev, k, itopk, width):
    # degree 7: a ragged hop of width·7 targets
    args = _cagra_inputs(dev, 3000, 40, 7, 40, max(itopk, 32))
    _cagra_both(args, k, itopk, width)


@pytest.mark.parametrize("dim,degree,width", [(33, 16, 2), (128, 32, 1),
                                              (5, 8, 8)])
def test_fused_cagra_topk_kernel_scalar_and_wide_hops(dev, dim, degree, width):
    # dim 33 and 5 take the kernel's scalar loads (dim % 4 != 0)
    args = _cagra_inputs(dev, 2000, dim, degree, 30, 64, seed=20)
    _cagra_both(args, 10, 64, width)


def test_fused_cagra_topk_kernel_duplicate_seeds_across_chunks(dev):
    # seed chunks hold 32 entries here (width·degree = 7): copies of the
    # first 40 seeds sit in later chunks
    q, data, graph, seeds, qn = _cagra_inputs(dev, 1000, 16, 7, 20, 200)
    seeds[:, 150:190] = seeds[:, 0:40]
    seeds[:, 199] = -1
    _cagra_both((q, data, graph, seeds, qn), 10, 32, 1)


def test_fused_cagra_topk_wrapper_checks(dev):
    q, data, graph, seeds, qn = _cagra_inputs(dev, 200, 8, 4, 3, 32)
    with pytest.raises(ValueError, match="small-beam"):
        gk.fused_cagra_topk(q, data, graph, seeds, qn, 10, 2048)
    with pytest.raises(TypeError, match="dtype"):
        gk.fused_cagra_topk(q, data, graph.long(), seeds, qn, 10, 64)
    wide = _randn(dev, 200, 60000)
    wq = _randn(dev, 3, 60000)
    with pytest.raises(ValueError, match="shared memory"):
        gk.fused_cagra_topk(wq, wide, graph, seeds, (wq * wq).sum(1), 10, 64)


def _cagra_cpu_and_card(dev, build_algo=cagra.BuildAlgo.NN_DESCENT):
    g = torch.Generator().manual_seed(13)
    db = torch.randn(4000, 32, generator=g)
    q = torch.randn(100, 32, generator=g)
    params = cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                               build_algo=build_algo)
    cpu = cagra.build(db, params, device="cpu")
    return db, q, params, cpu


@pytest.mark.parametrize("mode", ["auto", "xla"])
def test_cagra_search_on_the_card_matches_the_cpu(dev, mode):
    db, q, params, cpu = _cagra_cpu_and_card(dev)
    card = interop.cagra_index_from_numpy(params, db.numpy(),
                                          cpu.graph.numpy(), device=dev)
    sp = cagra.SearchParams(itopk_size=64, search_width=2, scan_mode=mode)
    gk.reset_launch_counts()
    got = cagra.search(card, q, 10, sp)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_cagra_topk"] == (1 if mode == "auto" else 0)
    want = cagra.search(cpu, q, 10, sp)
    if mode == "auto":  # the kernel and its plain version: bitwise
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[0].cpu(), want[0])
    else:
        assert_topk_close(got, want, 1e-4 * float((db * db).sum(1).max()),
                          1e-5)


@pytest.mark.parametrize("algo", ["NN_DESCENT", "IVF_PQ"])
def test_cagra_build_on_the_card_recall_matches_the_cpu(dev, algo):
    db, q, params, cpu = _cagra_cpu_and_card(dev, cagra.BuildAlgo[algo])
    card = cagra.build(db, params, res=Resources(device=dev))
    assert card.graph.device.type == "cuda"
    d = (q * q).sum(1)[:, None] + (db * db).sum(1)[None] - 2 * q @ db.T
    gt = torch.sort(d, dim=1, stable=True).indices[:, :10]
    sp = cagra.SearchParams(itopk_size=64, search_width=2)
    r_card = float(neighborhood_recall(cagra.search(card, q, 10, sp)[1].cpu(),
                                       gt))
    r_cpu = float(neighborhood_recall(cagra.search(cpu, q, 10, sp)[1], gt))
    assert r_card >= r_cpu - 0.02, (r_card, r_cpu)
