"""The roofline yardstick against hand counts, and its independence of the
program's list pad and query chunks."""

from __future__ import annotations

import torch

from vsbench import roofline
from vsbench.run import ROOT, load_module

SIZES = torch.tensor([3, 5, 0, 2])
PROBES = torch.tensor([[0, 1], [1, 3], [0, 3]])  # 3 queries, 2 probes


def test_probed_rows_by_hand():
    # scanned: (3+5) + (5+2) + (3+2); probed once: lists 0, 1, 3
    assert roofline.probed_rows(SIZES, PROBES) == (10, 20)


def test_ivf_topk_work_by_hand():
    # queries 3·4, norms 3, probes 3·2 floats; 10 rows of 4 floats, a norm
    # and an id; 3·2 values and ids out; 2·4 operations a row scanned
    assert roofline.ivf_topk_work(3, 2, 4, 4, 2, 10, 20) == (
        4 * (12 + 3 + 6) + 10 * (16 + 8) + 8 * 3 * 2, 2 * 4 * 20)


def test_ivf_scan_work_by_hand():
    # probes and queries in; 10 rows with norms; a partial a row scanned
    assert roofline.ivf_scan_work(3, 2, 4, 4, 10, 20) == (
        4 * (6 + 12) + 10 * (16 + 4) + 4 * 20, 2 * 4 * 20)


def test_pq_topk_work_by_hand():
    # nq 3, 2 probes, rot 4, 4 lists, pq_dim 2, pq_len 2, book 4, 2 code
    # bytes, k 2; LUT entries 3·2·2·4 at 2·2+2 operations, 20·2 adds
    got = roofline.pq_topk_work(3, 2, 4, 4, 2, 2, 4, 2, 2, 10, 20)
    assert got == (4 * (6 + 12 + 16 + 16 + 8) + 10 * (2 + 4) + 8 * 3 * 2,
                   3 * 2 * 2 * 4 * 6 + 20 * 2)


def test_bound_takes_the_slower_of_bytes_and_operations():
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = roofline.bound_s(1.0, 165e12)
    assert by == "operations" and abs(t - 1.0) < 1e-12


def _state(pad: int) -> dict:
    """An IVF-Flat index state of SIZES with ``pad`` slots a list."""
    ids = torch.full((4, pad), -1, dtype=torch.int32)
    nxt = 0
    for lst, size in enumerate(SIZES.tolist()):
        ids[lst, :size] = torch.arange(nxt, nxt + size)
        nxt += size
    gen = torch.Generator().manual_seed(0)
    return {"centers": torch.randn((4, 8), generator=gen), "list_ids": ids,
            "list_sizes": SIZES.clone(), "overflow_ids": torch.zeros(0),
            "elem_bytes": 4}


def test_count_is_the_same_at_any_pad_and_any_chunking():
    family = load_module(ROOT, "families", "ivf_flat")
    config = {"search": {"n_probes": 2}}
    queries = torch.randn((12, 8), generator=torch.Generator().manual_seed(1))
    counts = {family.work(kernel, _state(pad), queries, config, 2)
              for pad in (5, 8, 64) for kernel in ("fused_ivf_topk",)}
    assert len(counts) == 1
    # a batch in chunks: the rows scanned add up, each list is read once
    probes = roofline.coarse_probes(queries, _state(8)["centers"], 2)
    whole = roofline.probed_rows(SIZES, probes)
    parts = [roofline.probed_rows(SIZES, probes[i:i + 4])
             for i in range(0, 12, 4)]
    assert whole[1] == sum(p[1] for p in parts)
    assert whole[0] == roofline.probed_rows(
        SIZES, torch.cat([probes[i:i + 4] for i in range(0, 12, 4)]))[0]
    assert whole[0] <= sum(p[0] for p in parts)
