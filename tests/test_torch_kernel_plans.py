"""What the CPU can check of the redesigned kernels: their plans, the
precision argument of the 3xTF32 split, and the grouped IVF top-k's
selection rule.

- ``plan_fused_topk`` for every k in [1, 1024] and the feature widths the
  card tests use: a block's shared memory fits, the hi/lo planes' width is
  a multiple of 32, the scratch stays within its budget, the database
  ranges cover every row once, and the routes change where stated (two
  consumer warpgroups up to ``TC_WGS2_MAX_K`` = 81, tensor cores up to
  ``TC_MAX_K`` = 243).
- ``ivf_scan_groups`` (the plain version of ivf_scan.cu's grouping pass)
  at random and adversarial probes: every (query, probe) pair is covered
  once, in stable order, each group's pairs share one list, and the groups
  stay within the grid the host sizes.
- A numpy emulation of the 3xTF32 product (rna rounding to 10 mantissa
  bits, exact products, fp32 sums): its largest distance error against
  float64 is at most 4x the fp32 product's plus 1e-7·max‖x‖², the bound
  the card test holds the kernel to, and one TF32 pass misses it.
- ``plan_fused_ivf`` for every k in [1, 1024] at the main path's and the
  card tests' shapes: the grouped route up to ``IVF_TOPK_GROUPED_MAX_K``
  (512) and the per-query route above, a block's shared memory fits, the
  runs cover every slot once, and the partials stay within their budget,
  with the queries chunked beyond it.
- A plain torch emulation of the grouped route (each pair's top k of every
  run of slots by (value, slot), then each query's first k of its partials
  in (probe, run, rank) order) is bitwise equal to
  ``fused_ivf_topk_plain``: ties across probes, duplicate and out-of-range
  probes, -1 ids, more k than candidates.
- ``plan_fused_argmin`` at d = 1, 33, 128 and 256 (the x rows resident in
  shared memory up to d = 160), and a numpy emulation of the 3xTF32
  argmin at k-means-like shapes: its labels equal the fp32 product's
  wherever a row's two nearest centres are further apart than either
  side's rounding (``_tie_margin`` of tests/test_torch_cuda.py, per row).
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import gpu_kernels as gk

# (m, n) of the main path and the card tests
_SHAPES = [(10000, 1_000_000), (10000, 250_000), (1_000_000, 1024),
           (23, 300), (130, 3000), (1, 4099), (70, 1000), (200, 70000)]


@pytest.mark.parametrize("d", [8, 16, 24, 33, 40, 128])
def test_plan_fused_topk_every_k_fits(d):
    for k in range(1, gk.MAX_K + 1):
        for m, n in _SHAPES:
            plan = gk.plan_fused_topk(m, n, d, k, 132)
            assert plan.smem <= gk.SMEM_LIMIT, (m, n, d, k)
            assert plan.route == ("tc" if k <= gk.TC_MAX_K else "fma")
            assert plan.split_len % 128 == 0
            assert (plan.splits - 1) * plan.split_len < n <= \
                plan.splits * plan.split_len
            if plan.route == "fma":
                assert plan.smem == gk.l2_topk_fma_smem_bytes(k)
                continue
            assert plan.wgs == (2 if k <= gk.TC_WGS2_MAX_K else 1)
            assert plan.d_pad % 32 == 0 and d <= plan.d_pad < d + 32
            assert plan.scratch_bytes <= gk.L2_TOPK_SCRATCH_BUDGET
            assert 2 <= plan.stages <= 4 and plan.chunk_splits >= 1
            assert plan.smem == gk.l2_topk_tc_smem_bytes(k, plan.stages,
                                                         plan.wgs)


def test_tc_route_changes_where_shared_memory_runs_out():
    assert (gk.TC_MAX_K, gk.TC_WGS2_MAX_K) == (243, 81)
    assert gk.l2_topk_tc_smem_bytes(243, 2) <= gk.SMEM_LIMIT
    assert gk.l2_topk_tc_smem_bytes(244, 2) > gk.SMEM_LIMIT
    assert gk.l2_topk_tc_smem_bytes(81, 2, 2) <= gk.SMEM_LIMIT
    assert gk.l2_topk_tc_smem_bytes(82, 2, 2) > gk.SMEM_LIMIT


@pytest.mark.parametrize("m,n", [(10000, 100_000_000), (3_000_000, 1_000_000)])
def test_plan_fused_topk_chunks_what_exceeds_the_scratch_budget(m, n):
    plan = gk.plan_fused_topk(m, n, 128, 10, 132)
    assert plan.scratch_bytes <= gk.L2_TOPK_SCRATCH_BUDGET
    assert plan.q_chunk < m or plan.chunk_splits < plan.splits
    assert plan.q_chunk == m or plan.q_chunk % (64 * plan.wgs) == 0


def _probes(case, rng, nq=300, n_probes=9, n_lists=50):
    if case == "random":
        return rng.integers(0, n_lists, (nq, n_probes))
    if case == "one_list":
        return np.full((nq, n_probes), 7)
    if case == "repeats":
        return rng.integers(0, 2, (nq, n_probes))
    if case == "out_of_range":
        return rng.integers(-3, n_lists + 3, (nq, n_probes))
    return rng.integers(40, 43, (nq, n_probes))  # most lists empty


@pytest.mark.parametrize("case", ["random", "one_list", "repeats",
                                  "out_of_range", "sparse"])
def test_ivf_scan_groups_cover_every_pair_once(case):
    n_lists, group = 50, gk.IVF_SCAN_GROUP
    probes = _probes(case, np.random.default_rng(3))
    order, start, count, group_end = (t.numpy() for t in gk.ivf_scan_groups(
        torch.from_numpy(probes.astype(np.int32)), n_lists))
    flat = probes.reshape(-1)
    key = np.where((flat >= 0) & (flat < n_lists), flat, n_lists)
    np.testing.assert_array_equal(np.sort(order), np.arange(flat.size))
    np.testing.assert_array_equal(count, np.bincount(key,
                                                     minlength=n_lists + 1))
    blocks, _ = gk.ivf_scan_grid(flat.size, n_lists, 301)
    assert group_end[-1] <= blocks
    seen = np.zeros(flat.size, int)
    for b in range(blocks):  # the kernel's block → (list, group) mapping
        lst = int(np.searchsorted(group_end, b, side="right"))
        if lst > n_lists:
            continue
        g = b - (group_end[lst - 1] if lst else 0)
        pairs = order[start[lst] + g * group:
                      start[lst] + min((g + 1) * group, count[lst])]
        assert 1 <= len(pairs) <= group
        assert (key[pairs] == lst).all()
        assert (np.diff(pairs) > 0).all()  # stable: (query, probe) order
        seen[pairs] += 1
    assert (seen == 1).all()


def _tf32(a):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away
    from zero: cvt.rna.tf32.f32."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _l2(xn, yn, dot):
    return np.maximum((xn[:, None] + yn[None, :]) - np.float32(2) * dot,
                      np.float32(0))


@pytest.mark.parametrize("d", [33, 128])
def test_three_tf32_passes_meet_the_float64_bound(d):
    rng = np.random.default_rng(4)
    base = 10 + rng.standard_normal((1, d))
    x = (base + rng.standard_normal((200, d))).astype(np.float32)
    y = (base + rng.standard_normal((1500, d))).astype(np.float32)
    xn = (x * x).sum(1, dtype=np.float32)
    yn = (y * y).sum(1, dtype=np.float32)
    exact = ((x.astype(np.float64)[:, None, :]
              - y.astype(np.float64)[None]) ** 2).sum(-1)
    xh, yh = _tf32(x), _tf32(y)
    xl, yl = _tf32(x - xh), _tf32(y - yh)
    # tf32 × tf32 products are exact in fp32; the sums run in fp32
    split3 = (xh @ yh.T) + (xh @ yl.T) + (xl @ yh.T)
    errs = {name: float(np.abs(_l2(xn, yn, dot) - exact).max())
            for name, dot in (("fp32", x @ y.T), ("3xtf32", split3),
                              ("1xtf32", xh @ yh.T))}
    bound = 4 * errs["fp32"] + 1e-7 * float(xn.max())
    assert errs["3xtf32"] <= bound, errs
    assert errs["1xtf32"] > bound, errs


# ------------------------------------------------------ fused_ivf_topk

# (nq, P, n_lists, pad, rot, elem bytes) of the main path (IVF-Flat f32,
# IVF-PQ's bf16 cache, a 250,000-row shard) and of the card tests
_IVF_SHAPES = [(10000, 32, 1024, 1456, 128, 4), (10000, 32, 1024, 1456, 128, 2),
               (10000, 32, 1024, 368, 128, 4), (10000, 64, 1024, 1456, 128, 4),
               (64, 8, 50, 600, 128, 4), (64, 8, 50, 600, 128, 2),
               (9, 3, 6, 300, 20, 4), (2, 1, 3, 8, 4, 4),
               (40, 5, 7, 301, 100, 2), (700, 9, 7, 301, 1, 2)]


@pytest.mark.parametrize("shape", _IVF_SHAPES)
def test_plan_fused_ivf_every_k_fits(shape):
    nq, n_probes, n_lists, pad, rot, elem = shape
    chunks = -(-pad // gk.IVF_SCAN_SLOTS)
    for k in range(1, gk.MAX_K + 1):
        plan = gk.plan_fused_ivf(nq, n_probes, n_lists, pad, rot, k, elem, 132)
        assert plan.smem <= gk.SMEM_LIMIT, (shape, k)
        if k > gk.IVF_TOPK_GROUPED_MAX_K:
            assert plan.route == "per_query", (shape, k)
            assert plan.smem == gk.ivf_topk_per_query_smem_bytes(rot, k)
            continue
        assert plan.route == "grouped", (shape, k)
        assert plan.smem == gk.ivf_topk_smem_bytes(k, elem)
        assert (plan.runs - 1) * plan.chunks_per_run < chunks <= \
            plan.runs * plan.chunks_per_run
        assert 1 <= plan.q_chunk <= nq
        partials = plan.q_chunk * n_probes * plan.runs * k * 8
        assert partials <= gk.IVF_TOPK_SCRATCH_BUDGET or plan.q_chunk == 1
        assert plan.scratch_bytes == partials + 4 * gk.ivf_group_scratch(
            plan.q_chunk * n_probes, n_lists)


def test_ivf_grouped_route_ends_where_a_pair_carry_no_longer_fits():
    # carries in registers take no shared memory; above 16, a chunk's
    # survivors and the carries of the 32 pairs do
    assert gk.ivf_topk_smem_bytes(1, 4) == gk.ivf_topk_smem_bytes(16, 4)
    assert gk.ivf_topk_smem_bytes(17, 4) > gk.ivf_topk_smem_bytes(16, 4)
    assert gk.IVF_TOPK_GROUPED_MAX_K == 512
    assert gk.ivf_topk_smem_bytes(512, 4) <= gk.SMEM_LIMIT
    assert gk.ivf_topk_smem_bytes(513, 4) > gk.SMEM_LIMIT
    # the main path's shape: one run of the whole list
    plan = gk.plan_fused_ivf(10000, 32, 1024, 1456, 128, 10, 4, 132)
    assert (plan.route, plan.runs, plan.q_chunk) == ("grouped", 1, 10000)
    # few pairs a list: the slots cut into runs to fill the card
    plan = gk.plan_fused_ivf(64, 8, 50, 600, 128, 10, 4, 132)
    assert plan.runs > 1


@pytest.mark.parametrize("nq,k", [(10000, 512), (200000, 10)])
def test_plan_fused_ivf_chunks_queries_beyond_the_budget(nq, k):
    plan = gk.plan_fused_ivf(nq, 32, 1024, 1456, 128, k, 4, 132)
    assert plan.route == "grouped" and plan.q_chunk < nq
    assert plan.q_chunk * 32 * plan.runs * k * 8 <= \
        gk.IVF_TOPK_SCRATCH_BUDGET


def _ivf_case(case, dtype, seed=9, L=6, pad=150, rot=12, nq=40, P=5):
    """Inputs of fused_ivf_topk (torch, CPU) for one adversarial case."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((L, pad, rot)).astype(np.float32)
    ids = np.arange(L * pad, dtype=np.int32).reshape(L, pad)
    ids[:, pad - 7:] = -1  # unfilled slots at the end of every list
    ids[2, 10:20] = -1     # and a hole in one list
    probes = rng.integers(0, L, (nq, P))
    queries = rng.standard_normal((nq, rot)).astype(np.float32)
    if case == "ties_across_probes":
        # list 1 a copy of list 0 moved one chunk on, and the query the same
        # for every probe: equal distances in two probes and in two runs,
        # resolved by probe order
        data[1] = np.roll(data[0], 64, axis=0)
        probes[:, :2] = rng.permutation([[0, 1], [1, 0]] * (nq // 2))
        queries[: nq // 2] = data[0, : nq // 2]  # distance 0 ties too
    elif case == "duplicate_probes":
        probes = rng.integers(0, 2, (nq, P))
    elif case == "out_of_range":
        probes = rng.integers(-2, L + 2, (nq, P))
    elif case == "fewer_than_k":
        probes = rng.integers(0, L, (nq, 1))
        ids[:, 5:] = -1
    qres = np.repeat(queries[:, None, :], probes.shape[1], axis=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    data_t = t(data).to(dtype)
    return (t(probes.astype(np.int32)), t(qres), t((qres * qres).sum(-1)),
            data_t, (data_t.float() ** 2).sum(-1), t(ids))


def _grouped_emulation(probes, qres, qn, data, norms, ids, k, clamp, plan):
    """The grouped route in plain torch: the plain version's distances (the
    same expression on the same shapes), each pair's top k of every run of
    ``plan.chunks_per_run`` 64-slot chunks by (value, slot), then each
    query's first k of its P·runs·k partials in (probe, run, rank) order."""
    nq, n_probes = probes.shape
    n_lists, pad, _ = data.shape
    pr = probes.to(torch.int64)
    valid = (pr >= 0) & (pr < n_lists)
    pr = pr.clamp(0, n_lists - 1)
    dots = torch.einsum("tpr,tplr->tpl", qres.to(torch.float32),
                        data[pr].to(torch.float32))
    d = (qn[:, :, None] + norms[pr]) - 2.0 * dots
    if clamp:
        d = torch.clamp_min(d, 0.0)
    cid = ids[pr]
    d = torch.where((cid < 0) | ~valid[:, :, None], torch.inf, d)
    run_len = plan.chunks_per_run * gk.IVF_SCAN_SLOTS
    part_v, part_i = [], []
    for r in range(plan.runs):
        seg = slice(r * run_len, (r + 1) * run_len)
        v, i = gk._stable_topk(d[:, :, seg].reshape(nq * n_probes, -1), k,
                               cid[:, :, seg].reshape(nq * n_probes, -1))
        part_v.append(v.reshape(nq, n_probes, 1, k))
        part_i.append(i.reshape(nq, n_probes, 1, k))
    return gk._stable_topk(torch.cat(part_v, 2).reshape(nq, -1), k,
                           torch.cat(part_i, 2).reshape(nq, -1))


@pytest.mark.parametrize("case", ["random", "ties_across_probes",
                                  "duplicate_probes", "out_of_range",
                                  "fewer_than_k"])
@pytest.mark.parametrize("dtype,clamp", [(torch.float32, True),
                                         (torch.bfloat16, False)])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_grouped_ivf_emulation_is_bitwise_the_plain_version(case, dtype,
                                                           clamp, k):
    args = _ivf_case(case, dtype)
    nq, n_probes = args[0].shape
    n_lists, pad, rot = args[3].shape
    want = gk.fused_ivf_topk_plain(*args, k, clamp)
    planned = gk.plan_fused_ivf(nq, n_probes, n_lists, pad, rot, k,
                                args[3].element_size(), 132)
    chunks = -(-pad // gk.IVF_SCAN_SLOTS)
    # the planner's runs and two others: one chunk a run, the whole list
    for cpr in sorted({planned.chunks_per_run, 1, chunks}):
        plan = gk.IvfTopkPlan("grouped", cpr, -(-chunks // cpr), nq,
                              planned.smem, 0)
        got = _grouped_emulation(*args, k, clamp, plan)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), (case, cpr)
        assert torch.equal(got[1], want[1]), (case, cpr)


# ----------------------------------------------------- fused_l2_argmin


@pytest.mark.parametrize("d,route,d_pad,stages", [
    (1, "resident", 32, 4), (33, "resident", 64, 4),
    (128, "resident", 128, 3), (160, "resident", 160, 2),
    (200, "scratch", 224, 3), (256, "scratch", 256, 3)])
def test_plan_fused_argmin(d, route, d_pad, stages):
    for m, n in [(1_000_000, 1024), (37, 131), (1, 1), (5, 50000)]:
        plan = gk.plan_fused_argmin(m, n, d)
        assert (plan.route, plan.d_pad, plan.stages) == (route, d_pad, stages)
        assert plan.smem == gk.l2_argmin_smem_bytes(route, d_pad, stages)
        assert plan.smem <= gk.SMEM_LIMIT
        assert gk.l2_argmin_smem_bytes(route, d_pad, stages + 1) > \
            gk.SMEM_LIMIT or stages == 4
        y_planes = n * 2 * d_pad * 4
        if route == "resident":
            assert plan.x_chunk == m and plan.scratch_bytes == y_planes
        else:
            assert 1 <= plan.x_chunk <= m or plan.x_chunk == 128
            assert plan.x_chunk == m or plan.x_chunk % 128 == 0
            assert plan.scratch_bytes - y_planes <= \
                gk.L2_TOPK_SCRATCH_BUDGET // 2


def _row_tie_margin(x, c):
    """Per row: the gap between its nearest and second-nearest centre
    (float64) over 2·(d+4)·2⁻²⁴·(‖x‖+max‖c‖)², a bound on the fp32
    rounding of either side's distances (``_tie_margin`` of
    tests/test_torch_cuda.py, before its minimum over the rows)."""
    xd, cd = x.astype(np.float64), c.astype(np.float64)
    dist = ((xd[:, None, :] - cd[None]) ** 2).sum(-1)
    part = np.sort(dist, axis=1)
    bound = 2 * (x.shape[1] + 4) * 2.0 ** -24 * (
        np.linalg.norm(xd, axis=1) + np.linalg.norm(cd, axis=1).max()) ** 2
    return (part[:, 1] - part[:, 0]) / bound


def _argmin(xn, cn, dot):
    d = np.maximum((xn[:, None] + cn[None, :]) - np.float32(2) * dot,
                   np.float32(0))
    return d.argmin(1)


@pytest.mark.parametrize("seed,m,n_c,d,scale", [
    (32, 6000, 12, 24, 6.0), (33, 2000, 12, 24, 6.0), (5, 3000, 256, 128, 1.0),
    (6, 4000, 1024, 32, 0.5)])
def test_three_tf32_argmin_labels_match_fp32_away_from_ties(seed, m, n_c, d,
                                                           scale):
    # k-means-like: rows around cluster means, centres drawn from the rows
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((n_c, d)) * scale
    x = (means[rng.integers(0, n_c, m)]
         + rng.standard_normal((m, d))).astype(np.float32)
    c = x[rng.permutation(m)[:n_c]]
    xn = (x * x).sum(1, dtype=np.float32)
    cn = (c * c).sum(1, dtype=np.float32)
    xh, ch = _tf32(x), _tf32(c)
    xl, cl = _tf32(x - xh), _tf32(c - ch)
    fp32 = _argmin(xn, cn, x @ c.T)
    split3 = _argmin(xn, cn, (xh @ ch.T) + (xh @ cl.T) + (xl @ ch.T))
    clear = _row_tie_margin(x, c) > 1
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(split3[clear], fp32[clear])
