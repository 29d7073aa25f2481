"""What the CPU can check of the redesigned kernels: their plans, the
precision argument of the 3xTF32 split, the grouped routes' and
select_k's selection rules, and ring_shift's launches.

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
- ``plan_fused_pq`` for every pq_dim up to 256, pq_len up to 16 and the k
  around its boundaries that ``fused_pq_fits`` admits: a block's shared
  memory fits, the grouped route holds k up to ``PQ_GROUPED_MAX_K`` (32,
  a warp's register carry) and the per-query route takes over above; the
  runs cover every slot once and the partials stay within their budget.
  A torch emulation of the grouped route (each pair's top k of every run
  of 64·warps slots by (value, slot), then each query's first k of its
  partials in (probe, run, rank) order) is bitwise equal to
  ``fused_pq_topk_plain``: copies of a list's codes in two lists (ties
  across probes and runs), duplicate and out-of-range probes, -1 ids.
- ``plan_fused_cagra``: the warp route up to itopk 256 and 64 candidates
  a hop, the block route beyond, shared memory within a block's. The warp
  route's fold of a batch of 8 rows (half the rows exchanged at levels 16,
  8 and 4, then the ladder) is bitwise the xor ladder's sum of each row,
  and a torch emulation of its
  walk (seed chunks of 32 or 64, candidates dropped against the beam and,
  by the lowest lane of equal ids, against earlier candidates, a sort by
  (value, position) and a merge by rank with the beam first on ties) is
  bitwise equal to ``fused_cagra_topk_plain`` over random graphs with
  invalid edges, duplicate seeds across chunks and ties.
- ``plan_select_k``: the register route up to ``SELECT_REG_MAX_K`` (32)
  at every main-path shape, its chunk width and passes, and the
  shared-memory route above, up to k = 1024. A numpy emulation of the
  register route lane by lane (chunks of 32·V values; in two passes, the
  bound from each lane's two smallest keys; a step's survivors strictly
  below entry k-1 and at or below the bound; up to ``SELECT_INSERT_MAX``
  inserted by rank, more sorted and merged) is bitwise equal to
  ``_stable_topk`` in one pass and in two: ties across chunks and ±0.0,
  +inf tails, -inf and NaN of both signs, rows shorter than k or not a
  multiple of 32, ``select_min=False``, and rows built as the per-query
  merges build them (sorted runs of k with ids).
- ``ring_shift_launches``: one launch of 4 pairs for four ranks on one
  card, one a device for two cards, runs of ``RING_SHIFT_MAX_PAIRS`` (32)
  for a longer ring.
"""

import dataclasses

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


# ------------------------------------------------------- fused_pq_topk


@pytest.mark.parametrize("pq_len", [1, 2, 3, 4, 8, 16])
def test_plan_fused_pq_fits_and_ends_with_the_register_carry(pq_len):
    ks = [1, 2, 10, 16, 20, 31, 32, 33, 64, 256, 1024]
    for pq_dim in range(1, 257):
        for k in ks:
            if not gk.fused_pq_fits(pq_dim, pq_len, k):
                continue
            plan = gk.plan_fused_pq(10000, 32, 1024, 1456, pq_dim, pq_len, k)
            assert plan.smem <= gk.SMEM_LIMIT, (pq_dim, pq_len, k)
            if k > gk.PQ_GROUPED_MAX_K:
                assert plan.route == "per_query", (pq_dim, pq_len, k)
                assert plan.smem == gk.pq_topk_smem_bytes(pq_dim, pq_len, k)
                continue
            assert plan.route == "grouped", (pq_dim, pq_len, k)
            assert plan.smem == gk.pq_grouped_smem_bytes(
                pq_dim, pq_len, plan.warps, plan.res_chunked)
            # the residuals go whole unless a chunk at a time fits more warps
            assert plan.res_chunked == (gk.pq_grouped_smem_bytes(
                pq_dim, pq_len, plan.warps) > gk.SMEM_LIMIT)
            rows = gk.PQ_ROWS_PER_WARP * plan.warps
            assert (plan.runs - 1) * rows < 1456 <= plan.runs * rows
            assert 1 <= plan.warps <= gk.PQ_MAX_WARPS


def test_plan_fused_pq_at_the_main_shapes():
    # the LUT regime (32 probes, k=10) and refine (64 probes, k=20): 16
    # warps (1024 slots a run), every query in one launch
    for n_probes, k in [(32, 10), (64, 20)]:
        plan = gk.plan_fused_pq(10000, n_probes, 1024, 1456, 64, 2, k)
        assert (plan.route, plan.warps, plan.res_chunked, plan.runs,
                plan.q_chunk) == ("grouped", 16, False, 2, 10000)
        assert plan.scratch_bytes - 4 * gk.ivf_group_scratch(
            10000 * n_probes, 1024) <= gk.IVF_TOPK_SCRATCH_BUDGET
    assert gk.plan_fused_pq(10, 3, 8, 100, 64, 2, 32).route == "grouped"
    assert gk.plan_fused_pq(10, 3, 8, 100, 64, 2, 33).route == "per_query"
    # a short list needs no more warps than its slots
    assert gk.plan_fused_pq(10, 3, 8, 100, 64, 2, 10).warps == 2
    # a wide rotation (768 = 96 × 8): its residuals whole leave no room for
    # a warp, a chunk at a time for 15 (the codes take 24 words a row)
    plan = gk.plan_fused_pq(10, 3, 8, 1456, 96, 8, 10)
    assert gk.pq_grouped_smem_bytes(96, 8, 1) > gk.SMEM_LIMIT
    assert (plan.route, plan.res_chunked, plan.warps) == ("grouped", True,
                                                          15)
    # queries chunked where the partials would exceed the budget
    plan = gk.plan_fused_pq(200000, 64, 1024, 1456, 64, 2, 32)
    assert plan.q_chunk < 200000
    assert plan.q_chunk * 64 * plan.runs * 32 * 8 <= \
        gk.IVF_TOPK_SCRATCH_BUDGET


def _pq_case(case, seed=19, L=6, pad=150, pq_dim=8, pq_len=2, nq=40, P=5):
    """Inputs of fused_pq_topk (torch, CPU) for one adversarial case."""
    rng = np.random.default_rng(seed)
    rot = pq_dim * pq_len
    centers = rng.standard_normal((L, rot)).astype(np.float32)
    cb = rng.standard_normal((pq_dim, 256, pq_len)).astype(np.float32)
    codes = rng.integers(0, 256, (L, pad, pq_dim)).astype(np.uint8)
    ids = np.arange(L * pad, dtype=np.int32).reshape(L, pad)
    ids[:, pad - 7:] = -1  # unfilled slots at the end of every list
    ids[2, 10:20] = -1     # and a hole in one list
    probes = rng.integers(0, L, (nq, P))
    q_rot = rng.standard_normal((nq, rot)).astype(np.float32)
    if case == "ties_across_probes":
        # list 1 holds list 0's codes moved 70 slots on (another run at
        # 64 slots a run) with the same centre: equal distances in two
        # probes and two runs, resolved by probe order
        codes[1] = np.roll(codes[0], 70, axis=0)
        centers[1] = centers[0]
        probes[:, :2] = rng.permutation([[0, 1], [1, 0]] * (nq // 2))
        codes[0, 30:40] = codes[0, 0]  # and ties within a list
    elif case == "duplicate_probes":
        probes = rng.integers(0, 2, (nq, P))
    elif case == "out_of_range":
        probes = rng.integers(-2, L + 2, (nq, P))
    elif case == "fewer_than_k":
        probes = rng.integers(0, L, (nq, 1))
        ids[:, 5:] = -1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    cb_t = t(cb)
    return (t(probes.astype(np.int32)), t(q_rot), t(centers), cb_t,
            (cb_t * cb_t).sum(-1), t(codes), t(ids))


def _pq_grouped_emulation(args, k, plan):
    """The grouped route in plain torch: the plain version's distances,
    each pair's top k of every run of 64·warps slots by (value, slot), then
    each query's first k of its P·runs·k partials in (probe, run, rank)
    order."""
    nq, n_probes = args[0].shape
    d, cid = gk._pq_distances(*args)
    run_len = gk.PQ_ROWS_PER_WARP * plan.warps
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
@pytest.mark.parametrize("k", [1, 10, 20, 32])
def test_grouped_pq_emulation_is_bitwise_the_plain_version(case, k):
    args = _pq_case(case)
    nq, n_probes = args[0].shape
    n_lists, pad, pq_dim = args[5].shape
    want = gk.fused_pq_topk_plain(*args, k)
    planned = gk.plan_fused_pq(nq, n_probes, n_lists, pad, pq_dim,
                               args[3].shape[2], k)
    assert planned.route == "grouped"
    # the planner's runs and two others: 64 and 128 slots a run
    for warps in sorted({planned.warps, 1, 2}):
        runs = -(-pad // (gk.PQ_ROWS_PER_WARP * warps))
        plan = dataclasses.replace(planned, warps=warps, runs=runs)
        got = _pq_grouped_emulation(args, k, plan)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), (case, warps)
        assert torch.equal(got[1], want[1]), (case, warps)
    if case == "ties_across_probes" and k > 1:
        # copies tie and come back in probe order
        v = want[0]
        assert bool((v[:, 1:] == v[:, :-1]).any())


# ---------------------------------------------------- fused_cagra_topk


def test_plan_fused_cagra_routes():
    plan = gk.plan_fused_cagra(64, 128, 1, 32)  # the main path
    assert (plan.route, plan.warps) == ("warp", gk.CAGRA_WARPS)
    assert plan.smem == gk.CAGRA_WARPS * gk.cagra_warp_smem_bytes(64, 128, 1,
                                                                  32)
    for itopk in range(1, gk.MAX_ITOPK + 1, 3):
        for dim, width, degree in [(40, 1, 7), (40, 4, 7), (128, 2, 32),
                                   (5, 8, 8), (33, 2, 16), (128, 1, 64),
                                   (128, 3, 32), (100, 1, 65)]:
            plan = gk.plan_fused_cagra(itopk, dim, width, degree)
            warp = (itopk <= gk.CAGRA_WARP_MAX_ITOPK
                    and width * degree <= gk.CAGRA_WARP_MAX_CANDS)
            assert plan.route == ("warp" if warp else "block")
            assert plan.smem <= gk.SMEM_LIMIT
            if warp:
                assert 1 <= plan.warps <= gk.CAGRA_WARPS
    assert gk.plan_fused_cagra(256, 40, 1, 7).route == "warp"
    assert gk.plan_fused_cagra(257, 40, 1, 7).route == "block"
    assert gk.plan_fused_cagra(64, 40, 8, 8).route == "warp"
    assert gk.plan_fused_cagra(64, 40, 5, 13).route == "block"
    # a query row too wide for a warp's slice takes the block route
    assert gk.plan_fused_cagra(64, 60000, 1, 4).route == "block"


def _xor_ladder(v):
    """fused_cagra_topk's fold of lane sums: v[lane] + v[lane ^ o] for o =
    16, 8, 4, 2, 1 (every lane ends with the same value), in float32."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[lanes ^ o]).astype(np.float32)
    return v[0]


def _batch_fold(p):
    """The warp route's fold of a batch of 8 rows: p[lane, row] partials;
    at levels 16, 8 and 4 a lane keeps the half of its rows on its side of
    that bit and adds the partner's copy of them, at levels 2 and 1 it adds
    the partner's sum of its one row (the ladder); lane l ends with row
    ((l >> 4) & 1)·4 + ((l >> 3) & 1)·2 + ((l >> 2) & 1)'s sum."""
    lanes = np.arange(32)
    p = p.copy()
    for h, o in ((4, 16), (2, 8), (1, 4)):
        up = (lanes & o) != 0
        keep = np.where(up[:, None], p[:, h:2 * h], p[:, :h])
        send = np.where(up[:, None], p[:, :h], p[:, h:2 * h])
        p = (keep + send[lanes ^ o]).astype(np.float32)
    v = p[:, 0]
    for o in (2, 1):
        v = (v + v[lanes ^ o]).astype(np.float32)
    return v


def _fold_lane(r):
    return ((r >> 2) & 1) * 16 + ((r >> 1) & 1) * 8 + (r & 1) * 4


def test_batch_fold_is_bitwise_the_xor_ladder():
    rng = np.random.default_rng(5)
    for scale in (1.0, 1e-3, 1e6):
        # wide magnitudes and cancellations, where the order of the sums
        # decides the last bits
        p = (rng.standard_normal((32, 8)) * scale
             * 10.0 ** rng.integers(-3, 4, (32, 8))).astype(np.float32)
        p[:, 5] = -p[::-1, 5]
        p[:, 7] = 0.0
        got = _batch_fold(p)
        for r in range(8):
            held = np.array([(l >> 4 & 1) * 4 + (l >> 3 & 1) * 2
                             + (l >> 2 & 1) == r for l in range(32)])
            want = _xor_ladder(p[:, r])
            assert held[_fold_lane(r)]
            np.testing.assert_array_equal(
                got[held].view(np.int32),
                np.full(held.sum(), want, np.float32).view(np.int32))
    # and it is the plain version's order of additions
    x = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    lane_sums = x.reshape(8, 32, 4)  # row, lane, element of the lane
    acc = lane_sums[:, :, 0] + lane_sums[:, :, 1]
    acc = (acc + lane_sums[:, :, 2]) + lane_sums[:, :, 3]
    got = _batch_fold(acc.numpy().T.copy())
    want = gk.lane_order_sum(x).numpy()
    np.testing.assert_array_equal(
        got[[_fold_lane(r) for r in range(8)]].view(np.int32),
        want.view(np.int32))


def _cagra_case(case, seed=23, n=600, dim=20, degree=7, nq=30, n_seeds=80):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    if case == "ties":
        data[300:400] = data[200:300]  # copies of rows: equal distances
        data = np.round(data * 2) / 2  # and coarse values, more ties
    graph = rng.integers(0, n, (n, degree)).astype(np.int32)
    graph[::5, :2] = -1
    graph[7, 0] = n + 3  # outside [0, n): invalid too
    graph[:, -1] = graph[:, 0]  # a repeated edge in every row
    seeds = rng.integers(0, n, (nq, n_seeds)).astype(np.int32)
    seeds[:, 40:60] = seeds[:, 0:20]  # copies across seed chunks
    seeds[:, 5] = -1
    q = rng.standard_normal((nq, dim)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    qt = t(q)
    return qt, t(data), t(graph), t(seeds), gk.beam_norms(qt)


def _warp_route_emulation(queries, dataset, graph, seeds, q_norms, k, itopk,
                          width, max_iter):
    """The warp route in plain torch, all queries at once: seed chunks of
    the warp's candidate slots, each step's candidates dropped against the
    beam and against earlier candidates (lanes of equal ids keep the
    lowest; the second row of lanes also checks the first), scored by the
    plain version's distances, sorted by (value, position) and merged by
    rank (a beam entry moves down by the candidates strictly below it, a
    candidate by the beam entries at or below it)."""
    nq = queries.shape[0]
    n, degree = graph.shape
    cap = 32 if width * degree <= 32 else 64
    bd = torch.full((nq, itopk), torch.inf)
    bi = torch.full((nq, itopk), -1, dtype=torch.int64)
    bf = torch.zeros((nq, itopk), dtype=torch.bool)

    def step(bd, bi, bf, cand):
        cand = cand.to(torch.int64)
        drop = (cand < 0) | (cand >= n)
        drop |= (cand[:, :, None] == bi[:, None, :]).any(-1)
        lane = torch.arange(cand.shape[1])
        for half in range(cand.shape[1] // 32):
            cols = slice(32 * half, 32 * half + 32)
            c = cand[:, cols]
            lower = lane[:32][None, :] < lane[:32][:, None]  # [j, s]: s < j
            drop[:, cols] |= ((c[:, :, None] == c[:, None, :])
                              & lower[None]).any(-1)
            if half:
                drop[:, cols] |= (c[:, :, None]
                                  == cand[:, None, :32]).any(-1)
        tv = torch.where(drop, -1, cand)
        cd = gk.beam_distances(queries, q_norms, dataset, tv)
        sd, order = torch.sort(cd, dim=1, stable=True)  # (value, position)
        ns = torch.isfinite(sd).sum(1)
        si = torch.gather(tv, 1, order)
        pos = torch.arange(itopk)[None] + torch.searchsorted(
            sd, bd.contiguous(), right=False)
        fin = torch.isfinite(sd)
        cpos = torch.arange(sd.shape[1])[None] + torch.searchsorted(
            bd.contiguous(), sd.contiguous(), right=True)
        nd = torch.full_like(bd, torch.inf)
        ni = torch.full_like(bi, -1)
        nf = torch.zeros_like(bf)
        for b in range(nq):
            keep = pos[b] < itopk
            nd[b, pos[b][keep]] = bd[b][keep]
            ni[b, pos[b][keep]] = bi[b][keep]
            nf[b, pos[b][keep]] = bf[b][keep]
            take = fin[b] & (cpos[b] < itopk)
            nd[b, cpos[b][take]] = sd[b][take]
            ni[b, cpos[b][take]] = si[b][take]
        moved = (ns > 0)[:, None]
        return (torch.where(moved, nd, bd), torch.where(moved, ni, bi),
                torch.where(moved, nf, bf))

    n_seeds = seeds.shape[1]
    for base in range(0, n_seeds, cap):
        chunk = torch.full((nq, cap), -1, dtype=torch.int64)
        part = seeds[:, base:base + cap]
        chunk[:, :part.shape[1]] = part
        bd, bi, bf = step(bd, bi, bf, chunk)
    for _ in range(max_iter):
        avail = ~bf & torch.isfinite(bd)
        rank = torch.cumsum(avail.to(torch.int32), 1)
        par = torch.full((nq, width), -1, dtype=torch.int64)
        for w in range(width):
            hit = avail & (rank == w + 1)
            ok = hit.any(1)
            pos = hit.to(torch.int8).argmax(1)
            bf[ok, pos[ok]] = True
            par[:, w] = torch.where(ok, pos, -1)
        if not bool((par[:, 0] >= 0).any()):
            break
        pid = torch.gather(bi, 1, par.clamp_min(0))
        tg = graph[pid.clamp_min(0)].to(torch.int64)  # [nq, width, degree]
        tg = torch.where(par[:, :, None] < 0, -1, tg).reshape(nq, -1)
        cand = torch.full((nq, cap), -1, dtype=torch.int64)
        cand[:, :tg.shape[1]] = tg
        bd, bi, bf = step(bd, bi, bf, cand)
    return bd[:, :k], bi[:, :k].to(torch.int32)


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("itopk,width,degree", [(16, 1, 7), (64, 1, 7),
                                                (64, 4, 7), (32, 2, 16),
                                                (256, 1, 32), (64, 8, 8)])
def test_warp_route_emulation_is_bitwise_the_plain_version(case, itopk, width,
                                                           degree):
    q, data, graph, seeds, qn = _cagra_case(case, degree=degree)
    assert gk.plan_fused_cagra(itopk, q.shape[1], width, degree).route == \
        "warp"
    max_iter = gk.resolve_max_iter(itopk, width, 0)
    want = gk.fused_cagra_topk_plain(q, data, graph, seeds, qn, 10, itopk,
                                     width, max_iter)
    got = _warp_route_emulation(q, data, graph, seeds, qn, 10, itopk, width,
                                max_iter)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


# ------------------------------------------------------------- select_k


@pytest.mark.parametrize("n,k,route,v", [
    # the main path: the coarse probe selection and the per-query merges of
    # fused_l2_topk (5 ranges), fused_ivf_topk (32 probes, one run) and
    # fused_pq_topk (LUT: 32 probes, two runs; refine: 64 probes, k = 20)
    (1024, 32, "register", 8), (50, 10, "register", 2),
    (320, 10, "register", 8), (640, 10, "register", 8),
    (2560, 20, "register", 8),
    # both sides of k = 32, and k up to MAX_K on the shared route
    (1024, 33, "shared", 4), (1024, 64, "shared", 4), (5000, 1024, "shared", 4),
    (7, 10, "register", 1), (32, 1, "register", 1), (33, 1, "register", 2),
    (128, 32, "register", 4), (129, 32, "register", 8),
    (2**31, 10, "shared", 4)])
def test_plan_select_k_routes(n, k, route, v):
    plan = gk.plan_select_k(n, k)
    assert (plan.route, plan.v, plan.rows_per_warp) == (route, v, 1)
    assert plan.passes == (2 if route == "register"
                           and n > gk.SELECT_TWO_PASS_MIN_N else 1)
    assert (plan.route == "register") == (k <= gk.SELECT_REG_MAX_K
                                          and n < 2**31)
    if plan.route == "register":  # a chunk covers the row up to 8 steps
        assert 32 * plan.v >= min(n, 32 * gk.SELECT_REG_MAX_V)


_NO_KEY = np.uint64(0xFFFFFFFF)


def _select_keys(v):
    """select_key of topk_carry.cuh: order-preserving uint32 keys with -0.0
    as +0.0; +inf and NaN take 0xffffffff, which never enters."""
    f = v.astype(np.float32) + np.float32(0.0)
    u = f.view(np.uint32).astype(np.uint64)
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(f) | (key >= 0xFF800000), _NO_KEY, key)


def _key_values(key):
    u = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return np.where(key == _NO_KEY, np.float32(np.inf),
                    u.astype(np.uint32).view(np.float32))


def _register_route_emulation(vals, ids, k, select_min, passes, stats):
    """select_reg_kernel lane by lane: a sorted carry of 32 64-bit keys
    (order key << 32 | position) and ids; chunks of 32·v values, each
    32-value step filtered strictly below entry k-1's order key, up to
    SELECT_INSERT_MAX survivors inserted in position order by rank, more
    sorted and merged (carry[l] against survivor[31 - l], then sorted), the
    first step with survivors sorted straight into the empty carry. With
    two passes only keys at or below the bound enter: the k-th smallest of
    the lanes' two smallest keys over the row (lane l reads positions l,
    l + 32, ...)."""
    b, n = vals.shape
    v = gk.plan_select_k(n, k).v
    lanes = np.arange(32, dtype=np.uint64)
    out_v = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    for row in range(b):
        keys = _select_keys(vals[row] if select_min else -vals[row])
        limit = _NO_KEY
        if passes == 2:
            lanes_keys = np.full(-(-n // 32) * 32, _NO_KEY, np.uint64)
            lanes_keys[:n] = keys
            two = np.sort(lanes_keys.reshape(-1, 32), axis=0)[:2]
            limit = np.sort(two.ravel())[k - 1]
            stats["bounded"] += 1
        carry = np.full(32, ~np.uint64(0), np.uint64)
        cid = np.full(32, -1, np.int64)
        thr, empty = _NO_KEY, True
        for base in range(0, n, 32 * v):
            for j in range(v):
                pos = np.uint64(base + 32 * j) + lanes
                inside = pos < n
                at = np.minimum(pos, n - 1).astype(np.int64)
                key = np.where(inside, keys[at], _NO_KEY)
                nid = np.where(inside, ids[row, at], -1) if ids is not None \
                    else np.zeros(32, np.int64)
                enter = (key < thr) & (key <= limit)
                if not enter.any():
                    continue
                nk = np.where(enter, (key << np.uint64(32)) | pos,
                              ~np.uint64(0))
                if enter.sum() <= gk.SELECT_INSERT_MAX:
                    stats["insert"] += 1
                    for src in np.flatnonzero(enter):
                        rank = int((carry < nk[src]).sum())
                        if rank >= k:
                            continue
                        carry = np.concatenate([carry[:rank], nk[src:src + 1],
                                                carry[rank:31]])
                        cid = np.concatenate([cid[:rank], nid[src:src + 1],
                                              cid[rank:31]])
                else:
                    stats["merge"] += 1
                    order = np.argsort(nk, kind="stable")
                    sk, sid = nk[order], nid[order]
                    if empty:
                        carry, cid = sk, sid
                    else:
                        take = sk[::-1] < carry
                        low = np.where(take, sk[::-1], carry)
                        lid = np.where(take, sid[::-1], cid)
                        order = np.argsort(low, kind="stable")
                        carry, cid = low[order], lid[order]
                empty = False
                thr = carry[k - 1] >> np.uint64(32)
        key = carry[:k] >> np.uint64(32)
        val = _key_values(key)
        out_v[row] = val if select_min else -val
        pos_id = (carry[:k] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        out_i[row] = np.where(key == _NO_KEY, -1,
                              cid[:k] if ids is not None else pos_id)
    return torch.from_numpy(out_v), torch.from_numpy(out_i)


def _select_case(case, b, n, k, seed=31):
    """Rows of select_k's inputs: ``ties`` (values on a coarse grid, ties
    across chunks, -0.0 beside +0.0), ``specials`` (+inf tails, -inf, NaN),
    ``merge_runs`` (rows as the per-query merges build them: sorted runs of
    k, their ids, +inf and id -1 where a run ran short)."""
    rng = np.random.default_rng(seed)
    if case == "merge_runs":
        runs = -(-n // k)
        base = rng.standard_normal((b, runs, 1)).astype(np.float32)
        vals = np.sort(base + np.abs(rng.standard_normal((b, runs, k))
                                     .astype(np.float32)), axis=2)
        vals = np.round(vals * 8) / 8  # ties within and across runs
        short = rng.random((b, runs)) < 0.2
        vals[:, :, k // 2:][short] = np.inf
        ids = rng.permutation(b * runs * k).reshape(b, runs, k)
        ids = np.where(np.isinf(vals), -1, ids)
        return (vals.reshape(b, -1)[:, :n].astype(np.float32),
                ids.reshape(b, -1)[:, :n].astype(np.int32))
    vals = np.round(rng.standard_normal((b, n)) * 4) / 4
    vals = vals.astype(np.float32)
    vals[vals == 0] = np.where(rng.random(int((vals == 0).sum())) < 0.5,
                               np.float32(-0.0), np.float32(0.0))
    if case == "specials":
        vals[0, n // 3:] = np.inf  # a row short of finite values
        vals[1] = np.inf
        vals[2, ::5] = -np.inf
        vals[3:, ::7] = np.nan
        vals[4:, 3::11] = -np.nan
        vals[5:, 1::13] = np.inf
    return vals, None


@pytest.mark.parametrize("case", ["ties", "specials", "merge_runs"])
@pytest.mark.parametrize("n,k", [(7, 10), (50, 10), (77, 32), (320, 10),
                                 (640, 20), (1000, 1), (300, 32)])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("passes", [1, 2])
def test_register_route_emulation_is_bitwise_the_plain_version(case, n, k,
                                                               select_min,
                                                               passes):
    # the planner takes two passes above SELECT_TWO_PASS_MIN_N; the kernel
    # runs either at any n (select_k_rows' ``passes``)
    vals, ids = _select_case(case, 12, n, k)
    stats = {"insert": 0, "merge": 0, "bounded": 0}
    got = _register_route_emulation(vals, ids, k, select_min, passes, stats)
    v = torch.from_numpy(vals)
    sv, si = gk._stable_topk(v if select_min else -v, k,
                             None if ids is None else torch.from_numpy(ids))
    want = (sv if select_min else -sv, si)
    if ids is None:
        plain = gk.streaming_select_k_plain(v, k, select_min)
        assert torch.equal(plain[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(plain[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert stats["bounded"] == (vals.shape[0] if passes == 2 else 0)
    if passes == 1 and n >= 300 and k > 1:  # long rows take both paths
        assert stats["insert"] > 0 and stats["merge"] > 0, stats


# ------------------------------------------------------------- ring_shift


@pytest.mark.parametrize("devices,launches", [
    (["cuda:0"] * 4, [("cuda:0", [0, 1, 2, 3])]),
    (["cuda:0", "cuda:1"] * 2, [("cuda:0", [0, 2]), ("cuda:1", [1, 3])]),
    (["cuda:1", "cuda:1", "cuda:0"], [("cuda:1", [0, 1]), ("cuda:0", [2])]),
    (["cuda:0"] * 67, [("cuda:0", list(range(0, 32))),
                       ("cuda:0", list(range(32, 64))),
                       ("cuda:0", list(range(64, 67)))])])
def test_ring_shift_launches_group_the_ranks_by_source_device(devices,
                                                              launches):
    assert gk.RING_SHIFT_MAX_PAIRS == 32
    devs = [torch.device(d) for d in devices]
    got = gk.ring_shift_launches(devs)
    assert [(str(d), r) for d, r in got] == launches
    # every rank sends once, from its own device
    assert sorted(r for _, ranks in got for r in ranks) == list(
        range(len(devices)))
    assert all(devs[r] == d for d, ranks in got for r in ranks)
