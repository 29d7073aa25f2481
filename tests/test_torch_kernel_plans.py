"""What the CPU can check of the two redesigned kernels: their plans and the
precision argument of the 3xTF32 split.

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
