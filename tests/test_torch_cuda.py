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
least 90% equal; select_k does no arithmetic and is held to equality (bitwise, both
routes, at the per-query merges' shapes with their ids).
fused_cagra_topk is held to bitwise equality with its plain version (the
plain version repeats the kernel's products and its order of additions),
and so is the CAGRA kernel engine on the card with its CPU run.
fused_l2_argmin: values rtol 1e-5 and atol 1e-4·max‖x‖², ids equal where
the nearest distinct y vector beats the next by more than twice that (in
float64), and equal everywhere for exact copies of a row (whose distances
the kernel computes bitwise alike), including copies in different ranges
of a split y. fused_l2_topk's precision: the largest error of the
returned distances against float64 at the returned ids is at most 4x the
plain version's plus 1e-7·max‖x‖² (one TF32 pass fails this; the 3xTF32
split meets it). ivf_scan: rtol 1e-5 and atol 1e-4·max‖row‖², its
grouping pass equal to the CPU's stable sort. Both kernels, and two
IVF-Flat and IVF-PQ builds from one seed, bitwise equal run to run.
k-means on the card against the CPU: one update from the same centres,
and a whole fit from centres that leave every row far from a tie: labels
and n_iter equal, centres and inertia rtol 1e-5 (the card and the CPU sum
in another order). ring_shift: bitwise against its plain version and its input, on
random bytes of every dtype, one launch per source device (per 32 ranks).
The sharded searches on the card: the three
merge engines bitwise equal, and against the CPU as the searches above.
Sharded k-means on the card against the CPU from the same initial rows:
two card fits bitwise equal, labels equal (every E-step of the CPU's fit
clear of a tie), centres rtol 1e-5. The serving engine on the card:
IVF-Flat rows bitwise equal to ``solo_reference``, CAGRA rows served with
the searcher's cached seed tables bitwise equal to a search that draws
its seeds per call, and no kernel build after ``start()``. Persistence on
the card: each family restored from its file searches bitwise like the
saved index and launches its kernel; a sharded checkpoint's strict restore
(every rank at the largest rank's pad) bitwise the saved index's ring
search, and its full elastic restore bitwise the allgather merge.
Narrow list rows (int8, uint8, fp16) on the card: ``fused_ivf_topk`` and
``ivf_scan`` bitwise equal to the f32 kernel over the same lists cast to
f32 (every narrow value is exact in f32, and the kernels' arithmetic does
not depend on the row type), and to the plain version within the
tolerances above, on both routes of ``fused_ivf_topk``, the 100-byte int8
row and widths that are not a multiple of 4; two narrow IVF-Flat builds
bitwise equal. The bf16 fast scan on the card (one bf16 product with an
fp32 result) against the CPU's (an fp32 product of the bf16-rounded
operands): ids at least 99% equal and distances within the tolerances
above where they agree.
"""

import pytest
import torch

from raft_tpu_torch import interop
from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
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



def _bitwise_equal(a, b) -> bool:
    return all(torch.equal(u.view(torch.int32) if u.is_floating_point() else u,
                           v.view(torch.int32) if v.is_floating_point() else v)
               for u, v in zip(a, b))


# m not a multiple of the 128- or 64-row query tile, n not a multiple of the
# 128-row database tile, several database ranges, the change from two
# consumer warpgroups to one (k 81 / 82), and the route change at
# gk.TC_MAX_K (243: tensor cores; 244: the FMA route)
@pytest.mark.parametrize("m,n,d,k,wgs", [
    (70, 1000, 40, 10, 2), (1, 4099, 33, 7, 2), (200, 70000, 24, 10, 2),
    (65, 129, 8, 3, 2), (130, 1000, 40, 81, 2), (130, 1000, 40, 82, 1),
    (70, 1000, 40, 243, 1), (70, 1000, 40, 244, 0)])
def test_fused_l2_topk_kernel_more_shapes_and_repeatable(dev, m, n, d, k, wgs):
    x, y = _randn(dev, m, d, seed=40), _randn(dev, n, d, seed=41)
    plan = gk.plan_fused_topk(m, n, d, k, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert plan.route == ("tc" if k <= gk.TC_MAX_K else "fma")
    assert plan.wgs == wgs
    got = gk.fused_l2_topk(x, y, k)
    again = gk.fused_l2_topk(x, y, k)
    torch.cuda.synchronize()
    assert _bitwise_equal(got, again)
    assert_topk_close(got, gk.fused_l2_topk_plain(x, y, k),
                      1e-4 * float((y * y).sum(1).max()), 1e-5)
    if n >= k:
        assert bool((got[1] >= 0).all())


def _f64_err(x, y, vals, ids):
    """The largest |returned distance − float64 distance at the returned id|."""
    yy = y.double()[ids.long()]  # [m, k, d]
    ref = ((x.double()[:, None, :] - yy) ** 2).sum(-1)
    return float((vals.double() - ref).abs().max())


@pytest.mark.parametrize("k", [10, 82, 243, 244])
def test_fused_l2_topk_kernel_is_fp32_accurate(dev, k):
    # rows far from the origin and close to each other: the norms are about
    # 50x the distances, so the product's error shows. One TF32 pass
    # (about 2^-11 of the norms) fails this bound; 3xTF32 meets it.
    g = torch.Generator(device=dev).manual_seed(42)
    base = 10.0 + torch.randn(1, 128, generator=g, device=dev)
    y = base + torch.randn(6000, 128, generator=g, device=dev)
    x = base + torch.randn(300, 128, generator=g, device=dev)
    got = gk.fused_l2_topk(x, y, k)
    want = gk.fused_l2_topk_plain(x, y, k)
    torch.cuda.synchronize()
    scale = float((x * x).sum(1).max())
    err, plain_err = _f64_err(x, y, *got), _f64_err(x, y, *want)
    assert err <= 4 * plain_err + 1e-7 * scale, (err, plain_err, scale)
    assert_topk_close(got, want, 1e-4 * scale, 1e-5)

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


def _ivf_inputs(dev, L, pad, rot, nq, P, dtype, probes=None, seed=60):
    data = _randn(dev, L, pad, rot, seed=seed).to(dtype)
    ids = torch.arange(L * pad, device=dev, dtype=torch.int32).reshape(L, pad)
    ids[:, -5:] = -1  # unfilled slots
    if probes is None:
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        probes = torch.randint(0, L, (nq, P), generator=g, device=dev,
                               dtype=torch.int32)
    qres = _randn(dev, nq, P, rot, seed=seed + 2)
    return (probes, qres, (qres ** 2).sum(-1), data, (data.float() ** 2).sum(-1),
            ids)


def _ivf_route(args, k):
    probes, _, _, data = args[:4]
    return gk.plan_fused_ivf(*probes.shape, *data.shape, k,
                             data.element_size(), torch.cuda
                             .get_device_properties(probes.device)
                             .multi_processor_count).route


# the grouped route's last k with carries in registers and the first in
# shared memory, its last k (a pair's carry beside the slab buffers) and
# the per-query route just above it; a skewed probe set (every query probes
# list 3), out-of-range probes among valid ones, rot 20, 100 and 200 (no
# 16-byte rows; two feature steps a chunk), bf16 rows, pads that end
# mid-chunk, a batch of 16,000 pairs (four grouping segments)
@pytest.mark.parametrize("case,k,route", [
    ("random", gk.IVF_TOPK_REG_MAX_K, "grouped"),
    ("random", gk.IVF_TOPK_REG_MAX_K + 1, "grouped"),
    ("random", gk.IVF_TOPK_GROUPED_MAX_K, "grouped"),
    ("random", gk.IVF_TOPK_GROUPED_MAX_K + 1, "per_query"),
    ("one_list", 10, "grouped"), ("one_list", 64, "grouped"),
    ("out_of_range", 10, "grouped"), ("rot20", 64, "grouped"),
    ("bf16_rot100", 10, "grouped"), ("rot200", 10, "grouped"),
    ("main_like", 10, "grouped")])
def test_fused_ivf_topk_kernel_routes_skew_and_repeatable(dev, case, k, route):
    L, pad, rot, nq, P, dtype = 7, 1301, 128, 40, 5, torch.float32
    probes = None
    if case == "one_list":
        probes = torch.full((300, 9), 3, dtype=torch.int32, device=dev)
        nq, P = 300, 9
    elif case == "out_of_range":
        g = torch.Generator(device=dev).manual_seed(61)
        probes = torch.randint(-2, L + 2, (nq, P), generator=g, device=dev,
                               dtype=torch.int32)
    elif case == "rot20":
        rot = 20
    elif case == "bf16_rot100":
        rot, dtype = 100, torch.bfloat16
    elif case == "rot200":
        rot = 200
    elif case == "main_like":
        L, pad, nq, P = 16, 301, 2000, 8
    args = _ivf_inputs(dev, L, pad, rot, nq, P, dtype, probes)
    assert _ivf_route(args, k) == route
    before = gk.LAUNCHES["fused_ivf_topk"]
    got = gk.fused_ivf_topk(*args, k)
    again = gk.fused_ivf_topk(*args, k)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_ivf_topk"] == before + 2
    assert _bitwise_equal(got, again)
    want = gk.fused_ivf_topk_plain(*args, k)
    assert torch.equal(torch.isinf(got[0]), torch.isinf(want[0]))
    assert_topk_close(got, want, 1e-4 * float(args[4].max()), 1e-5)


@pytest.mark.parametrize("k,route", [(2, "grouped"), (10, "grouped"),
                                     (40, "grouped"), (513, "per_query")])
def test_fused_ivf_topk_kernel_ties_go_by_probe_then_slot(dev, k, route):
    # list 1 holds list 0's rows moved one chunk on (slot s → s + 64): a
    # query equal to row s of list 0 ties at the same distance with its copy;
    # the copy in the earlier probe comes first, whatever the slots or runs
    L, pad, rot, nq = 4, 600, 32, 64
    data = _randn(dev, L, pad, rot, seed=62)
    data[1] = torch.roll(data[0], 64, dims=0)
    ids = torch.arange(L * pad, device=dev, dtype=torch.int32).reshape(L, pad)
    slots = torch.arange(nq, device=dev) * 7
    flip = torch.arange(nq, device=dev) % 2 == 1
    probes = torch.stack([flip.int(), 1 - flip.int(), torch.full_like(
        slots, 2, dtype=torch.int32), torch.full_like(slots, 3,
                                                      dtype=torch.int32)], 1)
    probes = probes.to(torch.int32).contiguous()
    qres = data[0][slots][:, None, :].expand(nq, 4, rot).contiguous()
    args = (probes, qres, (qres ** 2).sum(-1), data, (data ** 2).sum(-1), ids)
    assert _ivf_route(args, k) == route
    got = gk.fused_ivf_topk(*args, k)
    torch.cuda.synchronize()
    first = torch.where(flip, ids[1][(slots + 64) % pad], ids[0][slots])
    second = torch.where(flip, ids[0][slots], ids[1][(slots + 64) % pad])
    assert torch.equal(got[0][:, 0].view(torch.int32),
                       got[0][:, 1].view(torch.int32))
    assert torch.equal(got[1][:, 0], first) and torch.equal(got[1][:, 1],
                                                             second)


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


def _select_rows(dev, case, b, n, k, seed=11):
    """select_k's inputs on the card: ``ties`` (a coarse grid: ties across
    chunks, -0.0 beside +0.0), ``specials`` (+inf rows and tails, -inf,
    NaN of both signs), ``merge_runs`` (sorted runs of k with their ids, as
    the per-query merges read them; +inf and id -1 where a run ran short)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if case == "merge_runs":
        runs = -(-n // k)
        v = torch.randn(b, runs, 1, generator=g, device=dev) + torch.randn(
            b, runs, k, generator=g, device=dev).abs()
        v = torch.round(torch.sort(v, dim=2).values * 8) / 8
        short = torch.rand(b, runs, 1, generator=g, device=dev) < 0.2
        v = torch.where(short & (torch.arange(k, device=dev) >= k // 2),
                        torch.inf, v)
        ids = torch.randperm(b * runs * k, generator=g, device=dev).reshape(
            b, runs, k).to(torch.int32)
        ids = torch.where(torch.isinf(v), -1, ids)
        return (v.reshape(b, -1)[:, :n].contiguous(),
                ids.reshape(b, -1)[:, :n].contiguous())
    v = torch.round(torch.randn(b, n, generator=g, device=dev) * 4) / 4
    v = torch.where((v == 0) & (torch.rand(b, n, generator=g, device=dev)
                                < 0.5), -0.0, v)
    if case == "specials":
        v[0, n // 3:] = torch.inf
        v[1] = torch.inf
        v[2, ::5] = -torch.inf
        v[3:, ::7] = torch.nan
        v[4:, 3::11] = -torch.nan
        v[5:, 1::13] = torch.inf
    return v.contiguous(), None


@pytest.mark.parametrize("case", ["ties", "specials", "merge_runs"])
@pytest.mark.parametrize("b,n", [(10000, 50), (1000, 320), (1000, 640),
                                 (1000, 1024), (500, 2560), (300, 77)])
@pytest.mark.parametrize("k", [1, 10, 20, 32, 33])
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_routes_bitwise_at_the_merge_shapes(dev, case, b, n, k,
                                                     select_min):
    # the register route up to k = 32, the shared-memory route at 33; with
    # ids through the C entry the per-query merges launch
    from raft_tpu_torch.bench.kernel_ab import select_k_rows

    v, ids = _select_rows(dev, case, b, n, k)
    want = gk._stable_topk(v if select_min else -v, k, ids)
    want = (want[0] if select_min else -want[0], want[1])
    if ids is None:
        got = gk.streaming_select_k(v, k, select_min)
    else:
        got = select_k_rows(v, ids, k, select_min)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("v", [1, 2, 4, 8, -1])
@pytest.mark.parametrize("passes", [1, 2])
def test_select_k_every_chunk_width_is_bitwise_the_plain_version(dev, v,
                                                                 passes):
    # the widths and passes the planner does not pick at this n still
    # select alike
    from raft_tpu_torch.bench.kernel_ab import select_k_rows

    vals, ids = _select_rows(dev, "merge_runs", 2000, 640, 10)
    want = gk._stable_topk(vals, 10, ids)
    got = select_k_rows(vals, ids, 10, v=v, passes=passes)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


def test_plan_select_k_is_the_launchers_choice(dev):
    lib = gk._lib("select_k")
    for n in (1, 7, 32, 33, 50, 64, 65, 128, 129, 256, 257, 320, 640, 1024,
              2560, 10**6):
        for k in (1, 10, 20, 32, 33, 64, 1024):
            plan = gk.plan_select_k(n, k)
            want = 4 * plan.v + plan.passes if plan.route == "register" else 0
            assert lib.select_k_route(n, k) == want, (n, k)


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


def _pq_route_case(dev, case):
    L, pad, pq_dim, pq_len, nq, P = 9, 1300, 16, 2, 60, 6
    if case == "pq_dim6":  # rows of 6 bytes: no whole words
        pq_dim, pq_len = 6, 3
    elif case == "pq_dim128":  # fewer warps fit beside the staged codes
        pq_dim, pq_len, pad = 128, 1, 700
    elif case == "long_list":  # three runs of 1024 slots
        pad = 2100
    elif case == "wide_rot":  # rot 768: residuals staged a chunk at a time
        pq_dim, pq_len = 96, 8
    elif case == "refine_like":  # the refine shape's k over 64 probes
        L, nq, P = 40, 200, 64
    args = list(_pq_inputs(dev, L, pad, pq_dim, pq_len, nq, P, seed=70))
    if case == "one_list":
        args[0] = torch.full((nq, P), 3, dtype=torch.int32, device=dev)
    elif case == "out_of_range":
        g = torch.Generator(device=dev).manual_seed(71)
        args[0] = torch.randint(-2, L + 2, (nq, P), generator=g, device=dev,
                                dtype=torch.int32)
    return tuple(args)


def _pq_plan(args, k):
    probes, _, _, cb, _, codes = args[:6]
    return gk.plan_fused_pq(*probes.shape, *codes.shape, cb.shape[2], k)


# the grouped route's last k (a warp's register carry) and the per-query
# route above it, the refine shape's k, skewed and out-of-range probes,
# code rows that are not whole words (pq_len 3, read at run time), fewer
# warps, three runs of a list, residuals staged a chunk at a time
@pytest.mark.parametrize("case,k,route", [
    ("random", gk.PQ_GROUPED_MAX_K, "grouped"),
    ("random", gk.PQ_GROUPED_MAX_K + 1, "per_query"),
    ("random", 1, "grouped"), ("refine_like", 20, "grouped"),
    ("one_list", 10, "grouped"), ("out_of_range", 10, "grouped"),
    ("pq_dim6", 10, "grouped"), ("pq_dim128", 10, "grouped"),
    ("long_list", 10, "grouped"), ("wide_rot", 10, "grouped")])
def test_fused_pq_topk_kernel_routes_and_repeatable(dev, case, k, route):
    args = _pq_route_case(dev, case)
    plan = _pq_plan(args, k)
    assert plan.route == route
    if case == "pq_dim128":
        assert plan.warps < gk.PQ_MAX_WARPS
    if case == "long_list":
        assert plan.runs == 3
    # the residuals go whole unless a chunk at a time fits more warps
    assert plan.res_chunked == (gk.pq_grouped_smem_bytes(
        *args[5].shape[2:], args[3].shape[2], plan.warps) > gk.SMEM_LIMIT)
    assert plan.res_chunked or case != "wide_rot"
    before = dict(gk.LAUNCHES)
    got = gk.fused_pq_topk(*args, k)
    again = gk.fused_pq_topk(*args, k)
    torch.cuda.synchronize()
    chunks = -(-args[0].shape[0] // plan.q_chunk)
    assert gk.LAUNCHES["fused_pq_topk"] == before["fused_pq_topk"] + 2 * chunks
    # the grouped route merges each query's partials with select_k's kernel
    merges = 2 * chunks if route == "grouped" else 0
    assert gk.LAUNCHES["select_k"] == before["select_k"] + merges
    assert _bitwise_equal(got, again)
    want = gk.fused_pq_topk_plain(*args, k)
    assert torch.equal(torch.isinf(got[0]), torch.isinf(want[0]))
    scale = float(want[0][torch.isfinite(want[0])].abs().max())
    assert_topk_close(got, want, 1e-4 * scale, 1e-5)


@pytest.mark.parametrize("k", [20, gk.PQ_GROUPED_MAX_K])
def test_fused_pq_topk_grouped_ties_go_by_probe_then_slot(dev, k):
    # list 1 holds list 0's codes moved 1100 slots on (into the other run
    # for most rows), with the same centre; every query probes the two
    # lists, in either order: each row comes back twice at one distance,
    # the copy in the earlier probe first
    L, pad, nq = 3, 1300, 64
    probes, q_rot, centers, cb, cbn, codes, _ = _pq_inputs(
        dev, L, pad, 16, 2, nq, 2, seed=72)
    ids = torch.arange(L * pad, device=dev, dtype=torch.int32).reshape(L, pad)
    codes[1] = torch.roll(codes[0], 1100, dims=0)
    centers[1] = centers[0]
    flip = torch.arange(nq, device=dev) % 2 == 1
    probes = torch.stack([flip.int(), 1 - flip.int()], 1).to(
        torch.int32).contiguous()
    args = (probes, q_rot, centers, cb, cbn, codes, ids)
    assert _pq_plan(args, k).route == "grouped"
    v, i = gk.fused_pq_topk(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(v[:, 0::2].view(torch.int32), v[:, 1::2].view(
        torch.int32))
    slot = i[:, 0::2] % pad  # the earlier probe's list and slot
    copy = torch.where(i[:, 0::2] < pad, pad + (slot + 1100) % pad,
                       (slot - 1100) % pad)
    assert torch.equal(i[:, 0::2] < pad, ~flip[:, None].expand(nq, k // 2))
    assert torch.equal(i[:, 1::2], copy.to(torch.int32))
    want = gk.fused_pq_topk_plain(*args, k)
    assert torch.equal(i, want[1])


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


def _cagra_plan(args, k, itopk, width):
    q, _, graph = args[:3]
    return gk.plan_fused_cagra(max(itopk, k), q.shape[1], width,
                               graph.shape[1])


# the warp route's largest beam and the block route just above it; 64
# candidates a hop (two a lane) and 96 (the block route); width 4; the
# scalar loads of dim 33 and 5; the main path's shape
@pytest.mark.parametrize("itopk,width,degree,dim,route", [
    (gk.CAGRA_WARP_MAX_ITOPK, 1, 32, 40, "warp"),
    (gk.CAGRA_WARP_MAX_ITOPK + 1, 1, 32, 40, "block"),
    (64, 2, 32, 40, "warp"), (64, 3, 32, 40, "block"),
    (64, 4, 7, 33, "warp"), (32, 8, 8, 5, "warp"), (64, 1, 32, 128, "warp")])
def test_fused_cagra_topk_kernel_routes_and_repeatable(dev, itopk, width,
                                                       degree, dim, route):
    args = _cagra_inputs(dev, 3000, dim, degree, 50, 64, seed=30)
    assert _cagra_plan(args, 10, itopk, width).route == route
    before = gk.LAUNCHES["fused_cagra_topk"]
    got, _ = _cagra_both(args, 10, itopk, width)
    again = gk.fused_cagra_topk(*args, 10, itopk, width, 0)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_cagra_topk"] == before + 2
    assert _bitwise_equal(got, again)


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


# ------------------------------------------------------ fused_l2_argmin


def _nn_far_from_ties(x, y, tol):
    """Rows whose nearest distinct y vector beats the next distinct one by
    more than 2·tol (float64 on the host)."""
    xd, yd = x.double().cpu(), torch.unique(y.double().cpu(), dim=0)
    if yd.shape[0] < 2:
        return torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    d = torch.cdist(xd, yd) ** 2
    part = torch.sort(d, dim=1).values
    return (part[:, 1] - part[:, 0] > 2 * tol).to(x.device)


def _argmin_both(x, y, clamp=False, xn=None, yn=None):
    before = gk.LAUNCHES["fused_l2_argmin"]
    got = gk.fused_l2_argmin(x, y, xn, yn, clamp=clamp)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_l2_argmin"] == before + 1
    return got, gk.fused_l2_argmin_plain(x, y, xn, yn, clamp=clamp)


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("m,n,d", [(37, 131, 24), (1000, 1024, 128),
                                   (5, 50000, 100), (130, 3000, 33),
                                   (1, 1, 7), (200, 129, 1)])
def test_fused_l2_argmin_kernel_matches_plain(dev, m, n, d, clamp):
    x, y = _randn(dev, m, d, seed=21), _randn(dev, n, d, seed=22)
    got, want = _argmin_both(x, y, clamp)
    tol = 1e-4 * float(max((x * x).sum(1).max(), (y * y).sum(1).max()))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=tol)
    ok = _nn_far_from_ties(x, y, tol)
    assert torch.equal(got[1][ok], want[1][ok])
    assert got[1].dtype == torch.int32 and int(got[1].min()) >= 0


# both routes of the plan (x resident in shared memory up to d = 160, split
# into scratch planes above), m and n not multiples of the 128-row tiles
@pytest.mark.parametrize("m,n,d,route", [
    (333, 257, 1, "resident"), (1000, 1030, 33, "resident"),
    (4099, 1024, 128, "resident"), (129, 130, 160, "resident"),
    (333, 257, 200, "scratch"), (70, 1, 200, "scratch")])
def test_fused_l2_argmin_kernel_routes_and_repeatable(dev, m, n, d, route):
    assert gk.plan_fused_argmin(m, n, d).route == route
    x, y = _randn(dev, m, d, seed=63), _randn(dev, n, d, seed=64)
    got, want = _argmin_both(x, y, True)
    again = gk.fused_l2_argmin(x, y, clamp=True)
    torch.cuda.synchronize()
    assert _bitwise_equal(got, again)
    tol = 1e-4 * float(max((x * x).sum(1).max(), (y * y).sum(1).max()))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=tol)
    ok = _nn_far_from_ties(x, y, tol)
    assert torch.equal(got[1][ok], want[1][ok])


@pytest.mark.parametrize("d", [24, 128, 200])
def test_fused_l2_argmin_kernel_is_fp32_accurate(dev, d):
    # rows far from the origin and close to each other, as in
    # test_fused_l2_topk_kernel_is_fp32_accurate: one TF32 pass fails this
    # bound, 3xTF32 meets it
    g = torch.Generator(device=dev).manual_seed(65)
    base = 10.0 + torch.randn(1, d, generator=g, device=dev)
    y = base + torch.randn(1024, d, generator=g, device=dev)
    x = base + torch.randn(3000, d, generator=g, device=dev)
    got, want = _argmin_both(x, y, True)
    scale = float((x * x).sum(1).max())
    err = _f64_err(x, y, got[0][:, None], got[1][:, None])
    plain_err = _f64_err(x, y, want[0][:, None], want[1][:, None])
    assert err <= 4 * plain_err + 1e-7 * scale, (err, plain_err, scale)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4 * scale)


@pytest.mark.parametrize("m,copies", [(5, 300), (700, 3)])
def test_fused_l2_argmin_kernel_ties_go_to_the_lowest_index(dev, m, copies):
    # 40 distinct rows repeated every 40 rows: a row's copies lie in several
    # 128-row y tiles and in the columns of several threads of its x row
    base = _randn(dev, 40, 16, seed=23)
    y = base.repeat(copies, 1)
    pick = torch.arange(m, device=dev) % 40
    x = base[pick] + 0.01 * _randn(dev, m, 16, seed=24)
    got, _ = _argmin_both(x, y)
    assert torch.equal(got[1], pick.to(torch.int32))


def test_fused_l2_argmin_kernel_clamp_ties_at_zero(dev):
    # norms stated below the rows' own: every distance is negative; the
    # clamped 1-NN ties at 0 everywhere and takes index 0, across tiles too
    x, y = _randn(dev, 4, 32, seed=25), _randn(dev, 20000, 32, seed=26)
    xn = (x * x).sum(1) - 1e4
    yn = (y * y).sum(1)
    got, want = _argmin_both(x, y, True, xn, yn)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[1], torch.zeros_like(got[1])) and torch.equal(
        want[1], got[1])
    got, want = _argmin_both(x, y, False, xn, yn)
    assert bool((got[0] < 0).all())
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-1)


def test_fused_l2_argmin_checks_its_inputs(dev):
    x = _randn(dev, 8, 16)
    with pytest.raises(TypeError, match="dtype"):
        gk.fused_l2_argmin(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        gk.fused_l2_argmin(x[:, ::2], x[:, ::2])
    with pytest.raises(ValueError, match="disagree"):
        gk.fused_l2_argmin(x, x[:, :8].contiguous())
    with pytest.raises(ValueError, match="no rows"):
        gk.fused_l2_argmin(x, x[:0])
    with pytest.raises(ValueError, match="is on"):
        gk.fused_l2_argmin(x, x.cpu())


# ------------------------------------------------------------ ivf_scan


@pytest.mark.parametrize("L,pad,rot,nq,P,dtype", [
    (50, 600, 128, 64, 8, torch.float32),
    (50, 600, 128, 64, 8, torch.bfloat16),
    (6, 300, 100, 9, 3, torch.bfloat16),   # odd rot, 2-byte rows
    (6, 301, 100, 9, 3, torch.float32),
    (3, 8, 4, 2, 1, torch.float32),
    (4, 37, 1, 3, 2, torch.bfloat16)])
def test_ivf_scan_kernel_matches_plain(dev, L, pad, rot, nq, P, dtype):
    data = _randn(dev, L, pad, rot, seed=27).to(dtype)
    norms = (data.float() ** 2).sum(-1)
    g = torch.Generator(device=dev).manual_seed(28)
    probes = torch.randint(0, L, (nq, P), generator=g, device=dev,
                           dtype=torch.int32)
    qres = _randn(dev, nq, P, rot, seed=29)
    before = gk.LAUNCHES["ivf_scan"]
    got = gk.ivf_scan(probes, qres, data, norms)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["ivf_scan"] == before + 1
    want = gk.ivf_scan_plain(probes, qres, data, norms)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-4 * float(norms.max()))


def test_ivf_scan_kernel_probe_out_of_range(dev):
    data = _randn(dev, 3, 40, 16, seed=30)
    norms = (data ** 2).sum(-1)
    probes = torch.tensor([[0, 3], [-1, 2]], dtype=torch.int32, device=dev)
    qres = _randn(dev, 2, 2, 16, seed=31)
    got = gk.ivf_scan(probes, qres, data, norms)
    torch.cuda.synchronize()
    assert bool(torch.isinf(got[0, 1]).all() and torch.isinf(got[1, 0]).all())
    torch.testing.assert_close(got, gk.ivf_scan_plain(probes, qres, data,
                                                      norms),
                               rtol=1e-5, atol=1e-4 * float(norms.max()))



def _scan_case(dev, case, dtype, rot, L=7, pad=301, nq=40, P=5):
    g = torch.Generator(device=dev).manual_seed(50)
    if case == "one_list":      # every query probes list 3
        probes = torch.full((nq, P), 3, dtype=torch.int32, device=dev)
    elif case == "repeats":     # lists repeated within a query
        probes = torch.randint(0, 2, (nq, P), generator=g, device=dev,
                               dtype=torch.int32)
    else:                        # out-of-range probes among valid ones
        probes = torch.randint(-2, L + 2, (nq, P), generator=g, device=dev,
                               dtype=torch.int32)
    data = _randn(dev, L, pad, rot, seed=51).to(dtype)
    norms = (data.float() ** 2).sum(-1)
    return probes, _randn(dev, nq, P, rot, seed=52), data, norms


@pytest.mark.parametrize("case", ["one_list", "repeats", "out_of_range"])
@pytest.mark.parametrize("dtype,rot", [(torch.float32, 128),
                                       (torch.bfloat16, 100),
                                       (torch.bfloat16, 1),
                                       (torch.float32, 300)])
def test_ivf_scan_kernel_skewed_probes_and_repeatable(dev, case, dtype, rot):
    args = _scan_case(dev, case, dtype, rot)
    got = gk.ivf_scan(*args)
    again = gk.ivf_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = gk.ivf_scan_plain(*args)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-4 * float(args[3].max()))


@pytest.mark.parametrize("case", ["one_list", "repeats", "out_of_range"])
def test_ivf_scan_grouping_on_the_card_is_the_stable_sort(dev, case):
    # more pairs than the grouping pass places at once (1024)
    probes = _scan_case(dev, case, torch.float32, 4, nq=700, P=9)[0]
    got = gk.ivf_scan_groups(probes, 7)
    want = gk.ivf_scan_groups(probes.cpu(), 7)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)

def test_ivf_scan_checks_its_inputs(dev):
    data = _randn(dev, 3, 8, 16)
    norms = (data ** 2).sum(-1)
    probes = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    qres = _randn(dev, 2, 2, 16)
    with pytest.raises(TypeError, match="dtype"):
        gk.ivf_scan(probes.long(), qres, data, norms)
    with pytest.raises(ValueError, match="disagree"):
        gk.ivf_scan(probes, qres[:, :, :8].contiguous(), data, norms)
    with pytest.raises(ValueError, match="contiguous"):
        gk.ivf_scan(probes, qres, data.transpose(0, 1), norms)


# --------------------------------------- k-means and the IVF scan route


def _blobs(seed=32, n=6000):
    """n rows in 12 separated blobs, their means, and 12 random rows."""
    g = torch.Generator().manual_seed(seed)
    means = torch.randn(12, 24, generator=g) * 6
    x = means[torch.randint(0, 12, (n,), generator=g)] + torch.randn(
        n, 24, generator=g)
    return x, means, x[torch.randperm(n, generator=g)[:12]]


def _tie_margin(x, c):
    """The smallest ratio (float64) of a row's gap between its nearest and
    second-nearest centre to 2·(d+4)·2⁻²⁴·(‖x‖+max‖c‖)², a bound on the
    fp32 rounding of either side's distances. Above 1, the kernel and the
    plain version must give every row the same label."""
    xd, cd = x.double(), c.double()
    part = torch.sort(torch.cdist(xd, cd) ** 2, dim=1).values
    bound = 2 * (x.shape[1] + 4) * 2.0 ** -24 * (
        xd.norm(dim=1) + cd.norm(dim=1).max()) ** 2
    return float(((part[:, 1] - part[:, 0]) / bound).min())


def test_update_centroids_on_the_card_matches_the_cpu(dev):
    x, _, c0 = _blobs()
    want = kmeans.update_centroids(x, c0, device="cpu")
    gk.reset_launch_counts()
    got = kmeans.update_centroids(x.to(dev), c0.to(dev))
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_l2_argmin"] == 1
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    # the M-step sums in row order: the same centres on every run
    again = kmeans.update_centroids(x.to(dev), c0.to(dev))
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_kmeans_on_the_card_matches_the_cpu(dev):
    # From random rows at tol 1e-12: the M-step sums the same way on every
    # run, so both fits stop when the labels stop changing, the card at the
    # CPU's n_iter, well before max_iter.
    x, _, c0 = _blobs(seed=33, n=2000)
    p = kmeans.KMeansParams(n_clusters=12, init="array", max_iter=100,
                            tol=1e-12)
    want = kmeans.fit(x, p, init_centers=c0, device="cpu")
    assert want[3] < p.max_iter
    # at every E-step of the CPU's fit each row's nearest centre leads the
    # next by more than the rounding of either side
    c = c0
    for _ in range(want[3] + 1):
        assert _tie_margin(x, c) > 1
        c = kmeans.update_centroids(x, c, device="cpu")[0]
    gk.reset_launch_counts()
    got = kmeans.fit(x, p, init_centers=c0, device=dev)
    torch.cuda.synchronize()
    assert got[3] == want[3]
    assert gk.LAUNCHES["fused_l2_argmin"] == got[3] + 1
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-4)
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(float(got[2]), float(want[2]), rtol=1e-5,
                               atol=0.0)
    pred, inertia = kmeans.predict(got[0], x.to(dev))
    assert torch.equal(pred.cpu(), want[1])
    torch.testing.assert_close(float(inertia), float(want[2]), rtol=1e-5,
                               atol=0.0)
    assert gk.LAUNCHES["fused_l2_argmin"] == got[3] + 2
    # k-means++ on the card: its centres are rows, and Lloyd improves on them
    xd = x.to(dev)
    pp0 = kmeans._kmeans_pp_init(Resources(device=dev, seed=1).generator, xd,
                                 12)
    assert all(bool((xd == c).all(1).any()) for c in pp0)
    pp = kmeans.fit(xd, p, init_centers=pp0, device=dev)
    assert float(pp[2]) <= float(kmeans.cluster_cost(xd, pp0))


def test_kmeans_pp_draw_on_the_card_takes_more_than_2_pow_24_rows(dev):
    n = 2 ** 24 + 10
    w = torch.zeros(n, dtype=torch.float32, device=dev)
    w[n - 5] = 0.25
    gen = Resources(device=dev, seed=2).generator
    assert kmeans._weighted_draw(gen, w).tolist() == [n - 5]


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_filtered_ivf_flat_on_the_card_matches_the_cpu(dev, metric):
    g = torch.Generator().manual_seed(33)
    db = torch.randn(4000, 40, generator=g)
    q = torch.randn(60, 40, generator=g)
    cpu = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=16, metric=metric),
                         device="cpu")
    card = interop.ivf_flat_index_from_numpy(
        cpu.params, *(t.numpy() for t in (cpu.centers, cpu.list_data,
                                          cpu.list_indices, cpu.list_sizes)),
        cpu.n_rows, cpu.overflow_data.numpy(), cpu.overflow_indices.numpy(),
        device=dev)
    mask = torch.rand(4000, generator=g) < 0.9
    sp = ivf_flat.SearchParams(n_probes=6)
    gk.reset_launch_counts()
    got = ivf_flat.search(card, q, 10, sp, filter=Bitset.from_mask(mask))
    torch.cuda.synchronize()
    assert gk.LAUNCHES["ivf_scan"] >= 1 and gk.LAUNCHES["fused_ivf_topk"] == 0
    want = ivf_flat.search(cpu, q, 10, sp, filter=Bitset.from_mask(mask))
    scale = 1.0 if metric == "cosine" else float((db * db).sum(1).max())
    assert_topk_close(got, want, 1e-4 * scale, 1e-5)
    assert bool(mask[got[1][got[1] >= 0].cpu().long()].all())


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_filtered_ivf_pq_cache_on_the_card_matches_the_cpu(dev, metric):
    g = torch.Generator().manual_seed(34)
    db = torch.randn(4000, 32, generator=g)
    q = torch.randn(50, 32, generator=g)
    cpu = ivf_pq.build(db, ivf_pq.IndexParams(n_lists=16, pq_dim=16,
                                              metric=metric), device="cpu")
    card = interop.ivf_pq_index_from_numpy(
        cpu.params, cpu.pq_dim, *(t.numpy() for t in (
            cpu.centers, cpu.rotation, cpu.codebooks, cpu.list_codes,
            cpu.list_indices, cpu.list_sizes)), cpu.n_rows,
        *(t.numpy() for t in (cpu.overflow_codes, cpu.overflow_labels,
                              cpu.overflow_indices)), device=dev)
    mask = torch.rand(4000, generator=g) < 0.9
    sp = ivf_pq.SearchParams(n_probes=6)
    plan = ivf_pq.plan_search(card, 10, sp, True)
    assert plan.engine == "cache" and plan.plan["unfused_ivf_scan"]
    gk.reset_launch_counts()
    got = ivf_pq.search(card, q, 10, sp, filter=Bitset.from_mask(mask))
    torch.cuda.synchronize()
    assert gk.LAUNCHES["ivf_scan"] >= 1
    want = ivf_pq.search(cpu, q, 10, sp, filter=Bitset.from_mask(mask))
    agree = assert_topk_close(got, want, 1e-4 * float(want[0].abs().max()),
                              1e-5)
    assert agree["id_agreement"] >= 0.9, agree


# ------------------------------------------------------------ ring_shift

_RING_BLOCKS = [(torch.uint8, (0,)), (torch.float32, (1,)),
                (torch.float32, (105,)), (torch.bfloat16, (210,)),
                (torch.int32, (105,)), (torch.uint8, (1001,)),
                (torch.float32, (3, 10000, 10)),
                (torch.bfloat16, (3, 10000, 20)),
                (torch.int32, (3, 10000, 10)), (torch.uint8, (1200000,))]


def _ring_blocks(dev, size, dtype, shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(0, 256, (size, *shape, torch.finfo(dtype).bits // 8
                                 if dtype.is_floating_point
                                 else torch.iinfo(dtype).bits // 8),
                        generator=g, device=dev, dtype=torch.uint8)
    return [raw[r].contiguous().view(dtype).reshape(shape)
            for r in range(size)]


@pytest.mark.parametrize("size", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype,shape", _RING_BLOCKS)
def test_ring_shift_kernel_matches_plain_bitwise(dev, size, dtype, shape):
    # random bytes: every bit pattern (NaNs, signed zeros) must survive
    blocks = _ring_blocks(dev, size, dtype, shape)
    n_bytes = blocks[0].numel() * blocks[0].element_size()
    before = gk.LAUNCHES["ring_shift"]
    got = gk.ring_shift(blocks)
    torch.cuda.synchronize()
    # one launch per source device: the ranks here share one card
    assert gk.LAUNCHES["ring_shift"] == before + (1 if n_bytes else 0)
    want = gk.ring_shift_plain(blocks)
    for r in range(size):
        assert got[r].data_ptr() not in {b.data_ptr() for b in blocks} \
            or n_bytes == 0
        assert got[r].dtype == dtype and got[r].shape == blocks[r].shape
        assert torch.equal(got[r].view(torch.uint8), want[r].view(torch.uint8))
        assert torch.equal(got[r].view(torch.uint8),
                           blocks[(r - 1) % size].view(torch.uint8))


def test_ring_shift_kernel_unaligned_and_repeated(dev):
    # views one byte into their storage take the kernel's byte loop; a
    # ring of `size` shifts in a row, each reusing the last one's buffers,
    # returns every block home, also on a side stream
    base = _ring_blocks(dev, 4, torch.uint8, (4097,), seed=1)
    blocks = [b[1:] for b in base]
    assert all(b.data_ptr() % 16 for b in blocks)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        cur = blocks
        for _ in range(4):
            cur = gk.ring_shift(cur)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(cur, blocks))


def test_ring_shift_longer_than_one_launch(dev):
    # 70 ranks on one card: three launches of 32, 32 and 6 pairs
    size = 70
    blocks = _ring_blocks(dev, size, torch.float32, (3, 100, 10), seed=2)
    launches = gk.ring_shift_launches([b.device for b in blocks])
    assert [len(r) for _, r in launches] == [32, 32, 6]
    before = gk.LAUNCHES["ring_shift"]
    got = gk.ring_shift(blocks)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["ring_shift"] == before + 3
    for r in range(size):
        assert torch.equal(got[r].view(torch.uint8),
                           blocks[(r - 1) % size].view(torch.uint8))


def test_ring_shift_checks_its_inputs(dev):
    a = torch.zeros((4, 6), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gk.ring_shift([a[:, :3], a[:, 3:]])
    with pytest.raises(ValueError, match="block 1"):
        gk.ring_shift([a, a[:2].contiguous()])
    with pytest.raises(ValueError, match="CUDA devices"):
        gk.ring_shift([a, a.cpu()])


def test_sharded_knn_engines_bitwise_on_the_card(dev):
    from raft_tpu_torch.parallel import comms, sharded

    g = torch.Generator().manual_seed(40)
    db = torch.randn(20000, 64, generator=g)
    q = torch.randn(300, 64, generator=g)
    tc = comms.init_comms([dev] * 4)
    gk.reset_launch_counts()
    outs = {m: sharded.knn(tc, q, db, 10, merge_mode=m)
            for m in ("allgather", "tree", "ring")}
    torch.cuda.synchronize()
    assert gk.LAUNCHES["ring_shift"] == 3  # a launch a hop: one card
    assert gk.LAUNCHES["fused_l2_topk"] == 3 * 4
    for m in ("tree", "ring"):
        assert torch.equal(outs[m][0].view(torch.int32),
                           outs["allgather"][0].view(torch.int32)), m
        assert torch.equal(outs[m][1], outs["allgather"][1]), m
    cpu = sharded.knn(comms.init_comms(["cpu"] * 4), q, db, 10,
                      merge_mode="ring")
    assert_topk_close(outs["ring"], cpu, 1e-4 * float((db * db).sum(1).max()),
                      1e-5)


def test_sharded_ivf_flat_on_the_card_matches_the_cpu(dev):
    from raft_tpu_torch.parallel import comms, sharded

    g = torch.Generator().manual_seed(41)
    db = torch.randn(8000, 32, generator=g)
    q = torch.randn(200, 32, generator=g)
    cpu_comms = comms.init_comms(["cpu"] * 4)
    cpu = sharded.build_ivf_flat(cpu_comms, db,
                                 ivf_flat.IndexParams(n_lists=16),
                                 res=Resources(device="cpu", seed=1))
    card_comms = comms.init_comms([dev] * 4)
    card = sharded.ShardedIvfFlat(card_comms, [
        interop.ivf_flat_index_from_numpy(
            i.params, *(t.numpy() for t in (i.centers, i.list_data,
                                            i.list_indices, i.list_sizes)),
            i.n_rows, i.overflow_data.numpy(), i.overflow_indices.numpy(),
            device=dev) for i in cpu.indexes], cpu.metric, cpu.n_rows,
        cpu.bounds)
    sp = ivf_flat.SearchParams(n_probes=6)
    gk.reset_launch_counts()
    got = sharded.search_ivf_flat(card, q, 10, sp, merge_mode="ring")
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_ivf_topk"] == 4
    assert gk.LAUNCHES["ring_shift"] == 3  # a launch a hop: one card
    want = sharded.search_ivf_flat(cpu, q, 10, sp, merge_mode="ring")
    assert_topk_close(got, want, 1e-4 * float((db * db).sum(1).max()), 1e-5)
    tree = sharded.search_ivf_flat(card, q, 10, sp, merge_mode="tree")
    assert torch.equal(tree[1], got[1])


def _sharded_kmeans_trajectory(sharded, x, tc, n_iters, **kw):
    """The CPU fit's centres after 0..n_iters iterations."""
    return [sharded.kmeans_fit(tc, x, 12, i, res=Resources(device="cpu"),
                               **kw)[0] for i in range(n_iters + 1)]


@pytest.mark.parametrize("balance", [None, 0.5])
def test_sharded_kmeans_on_the_card_matches_the_cpu(dev, balance,
                                                    monkeypatch):
    # the same initial rows and donors on both; the card's four logical
    # ranks sum each cluster in row order and allreduce in rank order, so
    # two card fits give the same bits and the card tracks the CPU fit
    from raft_tpu_torch.parallel import comms, sharded

    x, _, _ = _blobs(seed=111, n=2000)
    g = torch.Generator().manual_seed(11)
    init = torch.randperm(2000, generator=g)[:12]
    donors = torch.randint(0, 2000, (64,), generator=g)
    monkeypatch.setattr(sharded, "_initial_rows",
                        lambda gen, n, k: init.to(gen.device))
    monkeypatch.setattr(sharded, "_donor_rows",
                        lambda gen, n, p: donors.to(gen.device))
    kw = dict(balance_threshold=balance, donor_pool=64)
    cpu = comms.init_comms(["cpu"] * 4)
    traj = _sharded_kmeans_trajectory(sharded, x, cpu, 8, **kw)
    want = traj[-1], sharded.kmeans_fit(cpu, x, 12, 8,
                                        res=Resources(device="cpu"), **kw)[1]
    # at every E-step of the CPU's fit each row's nearest centre leads the
    # next by more than the rounding of either side
    assert all(_tie_margin(x, c) > 1 for c in traj)
    if balance is not None:  # the rescue re-seeds a centre on this data
        assert not torch.equal(want[0], _sharded_kmeans_trajectory(
            sharded, x, cpu, 8)[-1])
    card = comms.init_comms([dev] * 4)
    got = sharded.kmeans_fit(card, x, 12, 8, res=Resources(device=dev), **kw)
    again = sharded.kmeans_fit(card, x, 12, 8, res=Resources(device=dev),
                               **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)


# ------------------------------------- reproducible IVF builds on the card


def test_ivf_flat_builds_on_the_card_are_bitwise_equal(dev):
    db = _randn(dev, 20000, 32, seed=60)
    builds = [ivf_flat.build(db, ivf_flat.IndexParams(n_lists=64),
                             res=Resources(device=dev, seed=7))
              for _ in range(2)]
    torch.cuda.synchronize()
    a, b = builds
    for name in ("centers", "list_data", "list_indices", "list_sizes",
                 "overflow_data", "overflow_indices"):
        u, v = getattr(a, name), getattr(b, name)
        assert u.shape == v.shape and torch.equal(u, v), name


def test_ivf_pq_builds_on_the_card_are_bitwise_equal(dev):
    db = _randn(dev, 20000, 32, seed=61)
    params = ivf_pq.IndexParams(n_lists=64, pq_dim=16, pq_bits=8,
                                kmeans_n_iters=10)
    builds = [ivf_pq.build(db, params, res=Resources(device=dev, seed=8))
              for _ in range(2)]
    torch.cuda.synchronize()
    a, b = builds
    for name in ("centers", "rotation", "codebooks", "list_codes",
                 "list_indices", "list_sizes", "overflow_codes",
                 "overflow_indices"):
        u, v = getattr(a, name), getattr(b, name)
        assert u.shape == v.shape and torch.equal(u, v), name


def _serve(searcher, queries, k, max_batch=16):
    """Serve every row of ``queries`` through one engine, 4 submitter
    threads, and return (rows, placements, engine warmup info, builds
    after start)."""
    import threading

    from raft_tpu_torch import serving

    rows = [None] * len(queries)
    placements = [None] * len(queries)
    with serving.Engine(searcher, serving.EngineConfig(
            max_batch=max_batch, max_wait_us=2000, warm_ks=(k,))) as eng:
        c0 = serving.compile_count()

        def worker(t):
            for j in range(t, len(queries), 4):
                f = eng.submit(queries[j], k)
                rows[j] = f.result(timeout=60)
                placements[j] = f.placement

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
        builds = serving.compile_count() - c0
    return rows, placements, eng.warmup_info, builds


def test_served_ivf_flat_rows_bitwise_solo_on_the_card(dev):
    from raft_tpu_torch import serving

    db = _randn(dev, 20000, 32, seed=70)
    index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=64),
                           res=Resources(device=dev, seed=3))
    s = serving.ivf_flat_searcher(index, ivf_flat.SearchParams(n_probes=8))
    queries = _randn(dev, 60, 32, seed=71).cpu().numpy()
    rows, placements, info, builds = _serve(s, queries, 10)
    assert builds == 0 and info["device"] == str(s.device)
    assert serving.verify_bit_identity(s, list(queries), rows, 10,
                                       placements) == 0


def test_served_cagra_seed_tables_bitwise_per_call_draw_on_the_card(dev):
    from raft_tpu_torch import serving

    db = _randn(dev, 5000, 32, seed=72)
    g = torch.Generator(device=dev).manual_seed(73)
    graph = torch.randint(0, 5000, (5000, 16), generator=g, device=dev,
                          dtype=torch.int32)
    index = interop.cagra_index_from_numpy(
        cagra.IndexParams(graph_degree=16, intermediate_graph_degree=32),
        db.cpu().numpy(), graph.cpu().numpy(), device=dev)
    sp = cagra.SearchParams(itopk_size=32)
    s = serving.cagra_searcher(index, sp)
    queries = _randn(dev, 40, 32, seed=74).cpu().numpy()
    rows, placements, _, builds = _serve(s, queries, 10)
    assert builds == 0
    for q, (d_row, i_row), (row, bucket) in zip(queries, rows, placements):
        batch = torch.zeros((bucket, 32))
        batch[row] = torch.from_numpy(q)
        d, i = cagra.search(index, batch.to(dev), 10, sp)  # draws seeds
        assert torch.equal(torch.from_numpy(d_row).view(torch.int32),
                           d[row].cpu().view(torch.int32))
        assert torch.equal(torch.from_numpy(i_row), i[row].cpu())


def _bitwise(a, b):
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


@pytest.mark.parametrize("family", ["brute_force", "ivf_flat", "ivf_pq_cache",
                                    "ivf_pq_lut", "cagra", "cagra_no_dataset"])
def test_restore_onto_the_card_searches_bitwise_as_saved(dev, family,
                                                         tmp_path):
    from raft_tpu_torch.neighbors import brute_force

    db = _randn(dev, 20000, 32, seed=80)
    q = _randn(dev, 300, 32, seed=81)
    path = tmp_path / "index"
    res = Resources(device=dev, seed=4)
    if family == "brute_force":
        mod, index, kernel = brute_force, brute_force.build(db, res=res), \
            "fused_l2_topk"
        search = lambda i, r: mod.search(i, q, 10, res=r)  # noqa: E731
    elif family == "ivf_flat":
        mod, kernel = ivf_flat, "fused_ivf_topk"
        index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=64), res=res)
        search = lambda i, r: mod.search(  # noqa: E731
            i, q, 10, ivf_flat.SearchParams(n_probes=8), res=r)
    elif family.startswith("ivf_pq"):
        mod = ivf_pq
        index = ivf_pq.build(db, ivf_pq.IndexParams(n_lists=64, pq_dim=16),
                             res=res)
        lut = family == "ivf_pq_lut"
        kernel = "fused_pq_topk" if lut else "fused_ivf_topk"
        mem = sum(ivf_pq.scan_memory_bytes(index)) if lut else None
        search = lambda i, r: mod.search(  # noqa: E731
            i, q, 10, ivf_pq.SearchParams(n_probes=8),
            res=Resources(device=dev, device_memory_bytes=mem))
    else:
        mod, kernel = cagra, "fused_cagra_topk"
        g = torch.Generator(device=dev).manual_seed(82)
        graph = torch.randint(0, 20000, (20000, 16), generator=g, device=dev,
                              dtype=torch.int32)
        index = cagra.Index(cagra.IndexParams(graph_degree=16), db, graph)
        search = lambda i, r: mod.search(  # noqa: E731
            i, q, 10, cagra.SearchParams(itopk_size=32), res=r)
    before = search(index, res)
    if family == "cagra_no_dataset":
        mod.serialize(index, path, include_dataset=False)
        restored = mod.deserialize(path, dataset=db.cpu().numpy(), res=res)
    else:
        mod.serialize(index, path)
        restored = mod.deserialize(path, res=res)
    assert restored.device == index.device
    gk.reset_launch_counts()
    after = search(restored, res)
    torch.cuda.synchronize()
    assert gk.LAUNCHES[kernel] >= 1
    assert _bitwise(after, before)


def _skewed(dev, n, dim, seed):
    """Two blobs of very different spread: hot lists spill to the overflow
    blocks, and the ranks' list pads differ."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n // 2, dim, generator=g) * 0.05
    b = torch.randn(n - n // 2, dim, generator=g) \
        + torch.randn(n - n // 2, 1, generator=g) * 3.0
    return torch.cat([a, b])[torch.randperm(n, generator=g)].to(dev)


@pytest.mark.parametrize("kind", ["flat", "pq_cache", "pq_lut"])
def test_sharded_restores_on_the_card_bitwise(dev, kind, tmp_path):
    from raft_tpu_torch.parallel import comms, sharded

    db = _skewed(dev, 20000, 32, seed=83)
    q = _randn(dev, 200, 32, seed=84)
    tc = comms.init_comms([dev] * 4)
    res = Resources(device=dev, seed=5)
    prefix = str(tmp_path / "ckpt")
    if kind == "flat":
        index = sharded.build_ivf_flat(tc, db, ivf_flat.IndexParams(
            n_lists=16, list_pad_expansion=1.01), res=res)
        sp, fam = ivf_flat.SearchParams(n_probes=4), "ivf_flat"
    else:
        index = sharded.build_ivf_pq(tc, db, ivf_pq.IndexParams(
            n_lists=16, pq_dim=16, list_pad_expansion=1.01), res=res,
            scan_mode=kind[3:])
        sp, fam = ivf_pq.SearchParams(n_probes=4), "ivf_pq"
    search = getattr(sharded, f"search_{fam}")
    ring = search(index, q, 10, sp, merge_mode="ring")
    gather = search(index, q, 10, sp, merge_mode="allgather")
    getattr(sharded, f"serialize_{fam}")(index, prefix)
    assert sharded.verify_checkpoint(prefix)["ok"]
    strict = getattr(sharded, f"deserialize_{fam}")(prefix, tc)
    # every rank at the largest rank's pad, the searches bitwise as before
    pads = {i.list_indices.shape[1] for i in index.indexes}
    assert len(pads) > 1
    assert {i.list_indices.shape[1] for i in strict.indexes} == {max(pads)}
    assert _bitwise(search(strict, q, 10, sp, merge_mode="ring"), ring)
    full = getattr(sharded, f"deserialize_{fam}_elastic")(prefix,
                                                         res=Resources(dev))
    assert full.device.type == "cuda" and full.coverage == 1.0
    gk.reset_launch_counts()
    got = full.search(q, 10, sp)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["select_k"] >= 1
    assert _bitwise(got, gather)


# ------------------------------------------- narrow list rows, fast scan


def _narrow(dev, shape, dtype, seed):
    """Rows of a narrow type over its range (fp16: normal, std 4)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, device=dev).to(dtype)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g,
                             device=dev).to(dtype)
    return (4 * torch.randn(shape, generator=g, device=dev)).to(dtype)


_NARROW = [torch.uint8, torch.int8, torch.float16]


# both routes (registers, shared memory, per query), SPACEV's 100-byte int8
# row, widths that are not a multiple of 4 (the element copies), two
# feature steps a chunk
@pytest.mark.parametrize("dtype", _NARROW)
@pytest.mark.parametrize("rot,k,route", [
    (128, 10, "grouped"), (100, gk.IVF_TOPK_REG_MAX_K + 1, "grouped"),
    (128, gk.IVF_TOPK_GROUPED_MAX_K + 1, "per_query"), (98, 10, "grouped"),
    (3, 10, "grouped"), (200, 10, "grouped")])
def test_narrow_fused_ivf_topk_is_bitwise_the_f32_kernel(dev, dtype, rot, k,
                                                        route):
    L, pad, nq, P = 7, 301, 40, 5
    data = _narrow(dev, (L, pad, rot), dtype, seed=90)
    probes, qres, qn, _, _, ids = _ivf_inputs(dev, L, pad, rot, nq, P,
                                              torch.float32, seed=91)
    norms = (data.float() ** 2).sum(-1)
    args = (probes, qres, qn, data, norms, ids, k)
    assert _ivf_route(args, k) == route
    before = gk.LAUNCHES["fused_ivf_topk"]
    got = gk.fused_ivf_topk(*args)
    twin = gk.fused_ivf_topk(probes, qres, qn, data.float(), norms, ids, k)
    again = gk.fused_ivf_topk(*args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_ivf_topk"] == before + 3
    assert _bitwise_equal(got, twin) and _bitwise_equal(got, again)
    scale = float(torch.maximum(norms.max(), qn.max()))
    assert_topk_close(got, gk.fused_ivf_topk_plain(*args), 1e-4 * scale,
                      1e-5)


@pytest.mark.parametrize("dtype", _NARROW)
@pytest.mark.parametrize("case", ["repeats", "out_of_range"])
@pytest.mark.parametrize("rot", [128, 100, 98, 3])
def test_narrow_ivf_scan_is_bitwise_the_f32_kernel(dev, dtype, case, rot):
    probes, qres, _, _ = _scan_case(dev, case, torch.float32, rot)
    data = _narrow(dev, (7, 301, rot), dtype, seed=92)
    norms = (data.float() ** 2).sum(-1)
    before = gk.LAUNCHES["ivf_scan"]
    got = gk.ivf_scan(probes, qres, data, norms)
    twin = gk.ivf_scan(probes, qres, data.float(), norms)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["ivf_scan"] == before + 2
    assert torch.equal(got.view(torch.int32), twin.view(torch.int32))
    want = gk.ivf_scan_plain(probes, qres, data, norms)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    scale = float(torch.maximum(norms.max(), (qres ** 2).sum(-1).max()))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * scale)


def test_narrow_wrappers_refuse_other_row_types(dev):
    data = torch.zeros(3, 8, 16, dtype=torch.int16, device=dev)
    norms = torch.zeros(3, 8, device=dev)
    probes = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    qres = _randn(dev, 2, 2, 16)
    with pytest.raises(TypeError, match="dtype"):
        gk.ivf_scan(probes, qres, data, norms)
    with pytest.raises(TypeError, match="dtype"):
        gk.fused_ivf_topk(probes, qres, (qres ** 2).sum(-1), data, norms,
                          torch.zeros(3, 8, dtype=torch.int32, device=dev), 4)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_narrow_ivf_flat_on_the_card_builds_bitwise_and_matches_the_cpu(
        dev, dtype):
    db = _narrow(dev, (6000, 100), dtype, seed=93)
    q = _narrow(dev, (300, 100), dtype, seed=94)
    params = ivf_flat.IndexParams(n_lists=24)
    a = ivf_flat.build(db, params, res=Resources(device=dev, seed=3))
    b = ivf_flat.build(db, params, res=Resources(device=dev, seed=3))
    for name in ("centers", "list_data", "list_indices", "list_sizes",
                 "overflow_data", "overflow_indices"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.list_data.dtype == dtype
    sp = ivf_flat.SearchParams(n_probes=6)
    gk.reset_launch_counts()
    got = ivf_flat.search(a, q, 10, sp)
    filt = Bitset.from_mask(torch.arange(6000, device=dev) % 7 != 0)
    got_f = ivf_flat.search(a, q, 10, sp, filter=filt)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_ivf_topk"] == 1 and gk.LAUNCHES["ivf_scan"] >= 1
    cpu = interop.ivf_flat_index_from_numpy(
        a.params, a.centers.cpu(), a.list_data.cpu(), a.list_indices.cpu(),
        a.list_sizes.cpu(), a.n_rows, a.overflow_data.cpu(),
        a.overflow_indices.cpu(), device="cpu")
    scale = float((db.float() ** 2).sum(-1).max() + (q.float() ** 2).sum(-1)
                  .max())
    assert_topk_close(got, ivf_flat.search(cpu, q.cpu(), 10, sp),
                      1e-4 * scale, 1e-5)
    assert_topk_close(got_f, ivf_flat.search(
        cpu, q.cpu(), 10, sp, filter=Bitset.from_mask(
            torch.arange(6000) % 7 != 0)), 1e-4 * scale, 1e-5)


def _agree_99(got, want, scale):
    """ids at least 99% equal, distances close where they agree."""
    same = got[1].cpu() == want[1]
    assert float(same.float().mean()) >= 0.99
    diff = (got[0].cpu() - want[0]).abs()
    assert bool((diff <= 1e-4 * scale + 1e-5 * want[0].abs())[same].all())


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product", "cosine"])
def test_fast_scan_brute_force_on_the_card_matches_the_cpu(dev, metric):
    from raft_tpu_torch.neighbors import brute_force

    db, q = _randn(dev, 5000, 64, seed=95), _randn(dev, 200, 64, seed=96)
    index = brute_force.build(db, metric=metric)
    got = brute_force.search(index, q, 10, scan_dtype="bfloat16")
    want = brute_force.search(brute_force.build(db.cpu(), metric=metric,
                                                device="cpu"), q.cpu(), 10,
                              scan_dtype="bfloat16")
    _agree_99(got, want, float((db ** 2).sum(-1).max()
                               + (q ** 2).sum(-1).max()))


def test_fast_scan_ivf_flat_and_cagra_on_the_card_match_the_cpu(dev):
    db, q = _randn(dev, 6000, 32, seed=97), _randn(dev, 200, 32, seed=98)
    scale = float((db ** 2).sum(-1).max() + (q ** 2).sum(-1).max())
    index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=16),
                           res=Resources(device=dev, seed=4))
    cpu = interop.ivf_flat_index_from_numpy(
        index.params, index.centers.cpu(), index.list_data.cpu(),
        index.list_indices.cpu(), index.list_sizes.cpu(), index.n_rows,
        index.overflow_data.cpu(), index.overflow_indices.cpu(), device="cpu")
    sp = ivf_flat.SearchParams(n_probes=4, scan_dtype="bfloat16")
    gk.reset_launch_counts()
    got = ivf_flat.search(index, q, 10, sp)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_ivf_topk"] == 0 and gk.LAUNCHES["ivf_scan"] == 0
    _agree_99(got, ivf_flat.search(cpu, q.cpu(), 10, sp), scale)
    graph = torch.randint(0, 6000, (6000, 16), generator=torch.Generator()
                          .manual_seed(99), dtype=torch.int32)
    cparams = cagra.IndexParams(graph_degree=16, intermediate_graph_degree=32)
    c_dev = interop.cagra_index_from_numpy(cparams, db.cpu(), graph,
                                           device=dev)
    c_cpu = interop.cagra_index_from_numpy(cparams, db.cpu(), graph,
                                           device="cpu")
    csp = cagra.SearchParams(itopk_size=32, scan_dtype="bfloat16")
    _agree_99(cagra.search(c_dev, q, 10, csp),
              cagra.search(c_cpu, q.cpu(), 10, csp), scale)


# ------------------------------------------------ the write path and tiers


def _tiered_index(dev, metric="sqeuclidean", kind=0, expansion=1.5,
                  seed=70):
    db = _randn(dev, 6000, 32, seed=seed)
    return db, ivf_pq.build(db, ivf_pq.IndexParams(
        n_lists=48, pq_dim=16, metric=metric, codebook_kind=kind,
        kmeans_n_iters=6, list_pad_expansion=expansion),
        res=Resources(device=dev, seed=9))


@pytest.mark.parametrize("metric,kind,expansion", [
    ("sqeuclidean", 0, 1.5), ("inner_product", 0, 1.5),
    ("euclidean", 1, 1.0), ("inner_product", 1, 1.0)])
def test_tiered_search_bitwise_resident_on_the_card(dev, metric, kind,
                                                    expansion):
    from raft_tpu_torch.neighbors import tiered

    _, idx = _tiered_index(dev, metric, kind, expansion)
    res = Resources(device=dev, seed=0)
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena_slots=24)
    ivf_pq.ensure_scan_cache(idx)
    assert torch.equal(t.tier.norms.view(torch.int32),
                       idx.decoded_norms.cpu().view(torch.int32))
    assert t.tier.codes.is_pinned()
    kernel = "fused_ivf_topk" if metric != "inner_product" else "ivf_scan"
    params = ivf_pq.SearchParams(n_probes=8)
    for i in range(10):  # misses, hits and evictions in 24 slots
        q = _randn(dev, 2, 32, seed=100 + i)
        before = gk.LAUNCHES[kernel]
        got = t.search(q, 10, params, res=res)
        assert gk.LAUNCHES[kernel] > before
        want = ivf_pq.search(idx, q, 10, params, res=res,
                             memory_mode="cache")
        torch.cuda.synchronize()
        assert _bitwise_equal(got, want), i
    c = t.arena.snapshot_counts()
    assert c["evictions"] > 0
    assert c["evictions"] == c["inserts"] - c["occupancy"]


def test_tiered_arena_race_keeps_every_scan_bitwise(dev):
    """Two threads, each on its own stream, through one 24-slot arena (a
    batch probes up to 16 lists, so one thread's resolve often waits for
    the other's scan): a fetch for one thread's batch must never overwrite
    a slot the other's scan resolved and has not yet read."""
    import threading

    from raft_tpu_torch.neighbors import tiered

    _, idx = _tiered_index(dev)
    res = Resources(device=dev, seed=0)
    params = ivf_pq.SearchParams(n_probes=8)
    batches = [[_randn(dev, 2, 32, seed=200 + 100 * th + i)
                for i in range(12)] for th in range(2)]
    want = [[ivf_pq.search(idx, q, 10, params, res=res, memory_mode="cache")
             for q in b] for b in batches]
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena_slots=24)
    got = [[None] * 12 for _ in range(2)]
    errors = []

    def run(th):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for rep in range(3):
                    for i, q in enumerate(batches[th]):
                        out = t.search(q, 10, params, res=res)
                        if rep == 2:
                            got[th][i] = out
                torch.cuda.current_stream(dev).synchronize()
        except Exception as e:  # noqa: BLE001 — relayed to the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(th,)) for th in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not errors, errors
    for th in range(2):
        for i in range(12):
            assert _bitwise_equal(got[th][i], want[th][i]), (th, i)
    c = t.arena.snapshot_counts()
    assert c["evictions"] > 0
    assert c["hits"] + c["misses"] + c["prefetch_hits"] \
        + c["prefetch_fetches"] == c["resolved"]
    assert all(p >= 0 for p in t.arena._pins)


def test_tiered_two_runs_on_the_card_bitwise_and_against_the_cpu(dev):
    from raft_tpu_torch.neighbors import tiered

    _, idx = _tiered_index(dev)
    res = Resources(device=dev, seed=0)
    q = _randn(dev, 40, 32, seed=300)
    params = ivf_pq.SearchParams(n_probes=8)
    runs = [tiered.TieredIvfPq.from_index(idx, res=res, arena_slots=48)
            .search(q, 10, params, res=res) for _ in range(2)]
    torch.cuda.synchronize()
    assert _bitwise_equal(runs[0], runs[1])
    cpu = Resources(device="cpu", seed=0)
    idx_cpu = interop.ivf_pq_index_from_numpy(
        idx.params, idx.pq_dim, idx.centers.cpu().numpy(),
        idx.rotation.cpu().numpy(), idx.codebooks.cpu().numpy(),
        idx.list_codes.cpu().numpy(), idx.list_indices.cpu().numpy(),
        idx.list_sizes.cpu().numpy(), idx.n_rows,
        idx.overflow_codes.cpu().numpy(), idx.overflow_labels.cpu().numpy(),
        idx.overflow_indices.cpu().numpy(), device="cpu")
    t_cpu = tiered.TieredIvfPq.from_index(idx_cpu, res=cpu, arena_slots=48)
    want = t_cpu.search(q.cpu(), 10, params, res=cpu)
    scale = float(want[0][torch.isfinite(want[0])].abs().max())
    agree = assert_topk_close((runs[0][0].cpu(), runs[0][1].cpu()), want,
                              1e-4 * scale, 1e-5, "tiered card vs cpu")
    assert agree["id_agreement"] >= 0.9


def test_mutable_search_launches_the_merge_kernels_on_the_card(dev,
                                                               tmp_path):
    from raft_tpu_torch.neighbors import mutable
    from raft_tpu_torch.obs import metrics as om

    db = _randn(dev, 8000, 32, seed=80)
    base = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=32),
                          res=Resources(device=dev, seed=3))
    w = mutable.MutableIvf(str(tmp_path / "m"), base=base,
                           search_params=ivf_flat.SearchParams(n_probes=8),
                           registry=om.Registry(), group_window_s=0.0)
    assert w.device.type == "cuda"
    add = _randn(dev, 100, 32, seed=81).cpu().numpy()
    w.add(add, ids=torch.arange(10_000, 10_100).numpy())
    w.upsert(add[:5] + 1.0, torch.arange(0, 5).numpy())
    w.delete(torch.arange(5, 25).numpy())
    q = _randn(dev, 64, 32, seed=82)
    gk.reset_launch_counts()
    got = w.search(q, 10)
    torch.cuda.synchronize()
    counts = dict(gk.LAUNCHES)
    shapes = dict(gk.SELECT_K_SHAPES)
    assert counts["fused_ivf_topk"] >= 1
    cap = w._snapshot().cap
    assert shapes.get(("select_k", 10 + cap, 10), 0) == 1  # the merge
    slack = 1 << (25 - 1).bit_length()  # 20 deleted + 5 superseded
    assert shapes.get(("select_k", 10 + slack, 10), 0) == 1  # the filter
    ids = got[1].cpu()
    assert not set(ids.flatten().tolist()) & set(range(5, 25))
    again = w.search(q, 10)
    assert _bitwise_equal(got, again)
    # the same state on the CPU: within the tolerance of the plain versions
    cpu_base = interop.ivf_flat_index_from_numpy(
        base.params, base.centers.cpu().numpy(),
        base.list_data.cpu().numpy(), base.list_indices.cpu().numpy(),
        base.list_sizes.cpu().numpy(), base.n_rows,
        base.overflow_data.cpu().numpy(),
        base.overflow_indices.cpu().numpy(), device="cpu")
    wc = mutable.MutableIvf(str(tmp_path / "c"), base=cpu_base,
                            search_params=ivf_flat.SearchParams(n_probes=8),
                            registry=om.Registry(), group_window_s=0.0)
    wc.add(add, ids=torch.arange(10_000, 10_100).numpy())
    wc.upsert(add[:5] + 1.0, torch.arange(0, 5).numpy())
    wc.delete(torch.arange(5, 25).numpy())
    want = wc.search(q.cpu(), 10)
    assert_topk_close((got[0].cpu(), ids), want,
                      1e-4 * float((db * db).sum(1).max()), 1e-5,
                      "mutable card vs cpu")
    w.close()
    wc.close()


# ------------------------------------------------------ measured dispatch


@pytest.mark.parametrize("family", ["brute_force", "ivf_flat", "ivf_pq",
                                    "cagra"])
@pytest.mark.parametrize("verdict", [True, False, None])
def test_gate_routes_as_the_installed_verdict_on_the_card(dev, family,
                                                          verdict):
    """An installed verdict routes ``auto`` on the card: True the kernel
    (``auto_fused_wins``), False the unfused route (``fused_loses``), none
    the unfused route with a warning (``no_fused_wins_verdict``); each
    ``auto`` result bitwise the forced route's."""
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import select_k as sk

    key = sk.platform_key(dev)
    saved = dict(gk._load_fused_table().get(key, {}))
    db = _randn(dev, 6000, 32, seed=90)
    q = _randn(dev, 16, 32, seed=91)
    res = Resources(device=dev, seed=5)
    if family == "brute_force":
        index = brute_force.build(db, res=res)

        def run(mode):
            return brute_force.search(index, q, 10, scan_mode=mode,
                                      explain=True)
    elif family == "ivf_flat":
        index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=32), res=res)

        def run(mode):
            return ivf_flat.search(index, q, 10, ivf_flat.SearchParams(
                n_probes=8, scan_mode=mode), explain=True)
    elif family == "ivf_pq":
        index = ivf_pq.build(db, ivf_pq.IndexParams(n_lists=32, pq_dim=16),
                             res=res)

        def run(mode):
            return ivf_pq.search(index, q, 10, ivf_pq.SearchParams(
                n_probes=8, scan_mode="cache" if mode == "xla" else mode),
                explain=True)
    else:
        index = cagra.build(db, cagra.IndexParams(
            graph_degree=16, intermediate_graph_degree=32), res=res)

        def run(mode):
            return cagra.search(index, q, 10, cagra.SearchParams(
                itopk_size=32, scan_mode=mode), explain=True)
    try:
        gk.set_fused_crossover(key, {} if verdict is None
                               else {family: verdict})
        gk._reset_fused_warn()
        *auto, rec = run("auto")
        *forced, _ = run("pallas" if verdict else "xla")
        torch.cuda.synchronize()
    finally:
        gk.set_fused_crossover(key, saved or None)
    want = {True: "auto_fused_wins", False: "fused_loses",
            None: "no_fused_wins_verdict"}[verdict]
    assert rec.reason == want
    assert rec.engine.startswith("pallas") == bool(verdict)
    assert _bitwise(auto, forced)


def test_search_with_bitwise_search_for_each_family_on_the_card(dev):
    """``search_with`` with the handle's own params is ``search``, bitwise,
    for every family with knobs; an override is the search at those
    params."""
    from raft_tpu_torch import serving
    from raft_tpu_torch.neighbors import brute_force, mutable, tiered

    db = _randn(dev, 6000, 32, seed=92)
    q = _randn(dev, 16, 32, seed=93)
    res = Resources(device=dev, seed=6)
    flat = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=32), res=res)
    pq = ivf_pq.build(db, ivf_pq.IndexParams(n_lists=32, pq_dim=16), res=res)
    cg = cagra.build(db, cagra.IndexParams(graph_degree=16,
                                           intermediate_graph_degree=32),
                     res=res)
    handles = {
        "brute_force": (serving.brute_force_searcher(
            brute_force.build(db, res=res)), {"scan_mode": "pallas"}),
        "ivf_flat": (serving.ivf_flat_searcher(
            flat, ivf_flat.SearchParams(n_probes=8)), {"n_probes": 16}),
        "ivf_pq": (serving.ivf_pq_searcher(
            pq, ivf_pq.SearchParams(n_probes=8)), {"n_probes": 16}),
        "cagra": (serving.cagra_searcher(
            cg, cagra.SearchParams(itopk_size=32)),
            {"itopk_size": 64, "search_width": 2}),
        "tiered_ivf_pq": (serving.tiered_ivf_pq_searcher(
            tiered.TieredIvfPq.from_index(pq, res=res),
            ivf_pq.SearchParams(n_probes=8)), {"n_probes": 16}),
    }
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        w = mutable.MutableIvf(tmp, base=flat, res=res, group_window_s=0.0)
        handles["mutable_ivf"] = (serving.mutable_ivf_searcher(w),
                                  {"n_probes": 16})
        for fam, (s, override) in handles.items():
            a = s.search(q, 10)
            b = s.search_with(q, 10, {})
            c = s.search_with(q, 10, override)
            torch.cuda.synchronize()
            assert _bitwise(a, b), fam
            assert c[0].shape == (16, 10), fam
        w.close()
    ref = ivf_flat.search(flat, q, 10, ivf_flat.SearchParams(n_probes=16))
    assert _bitwise(handles["ivf_flat"][0].search_with(
        q, 10, {"n_probes": 16}), ref)


def test_planner_engine_builds_nothing_after_start_on_the_card(dev):
    """An engine with a planner warms every frontier point at every bucket:
    0 kernel builds after ``start()``; each served row bitwise a solo
    ``search_with`` at its batch's params."""
    import numpy as np

    from raft_tpu_torch import serving
    from raft_tpu_torch.planner import adaptive

    db = _randn(dev, 20000, 32, seed=94)
    index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=64),
                           res=Resources(device=dev, seed=7))
    s = serving.ivf_flat_searcher(index, ivf_flat.SearchParams(n_probes=8))
    pts = [adaptive.OperatingPoint({"n_probes": 32}, 8, 100.0, 0.99, 1e6),
           adaptive.OperatingPoint({"n_probes": 4}, 8, 900.0, 0.9, 1e-6)]
    doc = {"schema": adaptive.PARETO_SCHEMA, "platform": "test",
           "families": {"ivf_flat": {"frontier": {"10": {
               "8": [p.to_dict() for p in pts]}}}}}
    planner = adaptive.AdaptivePlanner(adaptive.Frontier(doc),
                                       recall_floor=0.85)
    queries = _randn(dev, 64, 32, seed=95).cpu().numpy()
    with serving.Engine(s, serving.EngineConfig(
            max_batch=16, max_wait_us=2000, warm_ks=(10,),
            planner=planner)) as eng:
        c0 = serving.compile_count()
        futs = [eng.submit(q_, 10, deadline_ms=(5000.0 if j % 2 else None))
                for j, q_ in enumerate(queries)]
        rows = [f.result(timeout=60) for f in futs]
        builds = serving.compile_count() - c0
    assert builds == 0 and eng.warmup_info["compiles"] >= 0
    params = [f.params for f in futs]
    assert {"n_probes": 4} in params
    assert serving.verify_bit_identity(
        s, list(queries), rows, 10, [f.placement for f in futs],
        params) == 0
    assert np.all([r[1].shape == (10,) for r in rows])
