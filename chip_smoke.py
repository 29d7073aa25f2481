#!/usr/bin/env python3
"""Drive raft_tpu_torch's main path on one CUDA card and check every kernel.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``. At SIFT-1M's shape (1,000,000 × 128 float32 rows made from the
seed, 10,000 queries, k=10, L2) it

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the three CUDA kernels from ``raft_tpu_torch/csrc`` (timed);
3. runs exact search (``brute_force.build`` + ``search``), the main path's
   first half, with the launch counts set to 0 just before and read just
   after; its result is the ground truth;
4. runs IVF-Flat (``ivf_flat.build`` with 1024 lists + ``search`` with 32
   probes) the same way and checks recall@10 >= 0.90 against phase 3;
5. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gave it, and times kernel, plain version and, where
   one PyTorch call computes the same function, that call;
6. prints one ``{"kernels": [...]}`` line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Every phase prints one JSON line. Any failed check raises, and the script
then exits non-zero without the last line. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 10_000, 10
N_LISTS, N_PROBES, RECALL_FLOOR = 1024, 32, 0.90


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn):
    """(fn(), host seconds), the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (after one warm-up run
    unless the caller has just run it)."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from raft_tpu_torch.bench.datagen import low_rank_clusters
        from raft_tpu_torch.neighbors import brute_force, ivf_flat
        from raft_tpu_torch.ops import gpu_kernels as gk
        from raft_tpu_torch.ops.distance import row_norms_sq
        from raft_tpu_torch.stats import neighborhood_recall
        from raft_tpu_torch.testing import assert_topk_close
    except ImportError as e:
        print(f"chip_smoke: raft_tpu_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build the kernels
    paths, build_kernels_s = timed(gk.build_all)
    emit({"phase": "build", "seconds": build_kernels_s,
          "libraries": {k: str(v.name) for k, v in paths.items()}})

    # data at SIFT-1M's shape, from the seed (set-up, not timed)
    rng = np.random.default_rng(args.seed)
    rows = low_rank_clusters(rng, N_ROWS + N_QUERIES, DIM)
    dataset = torch.from_numpy(rows[:N_ROWS]).to(dev)
    queries = torch.from_numpy(rows[N_ROWS:]).to(dev)
    torch.cuda.synchronize()

    # ---- 3. exact search: the ground truth. The first call also loads
    # the kernel's library; the second is the warm request.
    bf = brute_force.build(dataset, metric="sqeuclidean")
    gk.reset_launch_counts()
    (gt_v, gt_i), bf_cold_s = timed(lambda: brute_force.search(bf, queries, K))
    (gt_v, gt_i), bf_s = timed(lambda: brute_force.search(bf, queries, K))
    bf_launches = dict(gk.LAUNCHES)
    if bf_launches["fused_l2_topk"] < 1:
        raise AssertionError("brute_force.search did not launch fused_l2_topk")
    if gt_v.shape != (N_QUERIES, K) or not bool(torch.isfinite(gt_v).all()) \
            or bool((gt_i < 0).any()):
        raise AssertionError("brute-force result is not finite and complete")
    emit({"phase": "brute_force", "queries": N_QUERIES, "rows": N_ROWS,
          "k": K, "first_call_seconds": bf_cold_s, "seconds": bf_s,
          "qps": N_QUERIES / bf_s, "launches": bf_launches})

    # ---- 4. IVF-Flat build + search, recall against phase 3
    gk.reset_launch_counts()
    index, build_s = timed(lambda: ivf_flat.build(
        dataset, ivf_flat.IndexParams(n_lists=N_LISTS)))
    n_probes = N_PROBES
    while True:
        params = ivf_flat.SearchParams(n_probes=n_probes)
        _, first_s = timed(lambda: ivf_flat.search(index, queries, K, params))
        (iv, ii), search_s = timed(lambda: ivf_flat.search(index, queries, K,
                                                           params))
        recall = float(neighborhood_recall(ii, gt_i))
        if recall >= RECALL_FLOOR or n_probes >= N_LISTS:
            break
        n_probes *= 2
    ivf_launches = dict(gk.LAUNCHES)
    emit({"phase": "ivf_flat", "n_lists": N_LISTS, "n_probes": n_probes,
          "list_pad": index.list_data.shape[1],
          "overflow_rows": int((index.overflow_indices >= 0).sum()),
          "build_seconds": build_s, "first_call_seconds": first_s,
          "search_seconds": search_s, "qps": N_QUERIES / search_s,
          "recall_at_10": recall, "launches": ivf_launches})
    if recall < RECALL_FLOOR:
        raise AssertionError(f"IVF-Flat recall {recall} < {RECALL_FLOOR}")
    for name in ("fused_ivf_topk", "select_k"):
        if ivf_launches[name] < 1:
            raise AssertionError(f"ivf_flat.search did not launch {name}")
    if not bool(torch.isfinite(iv).all()):
        raise AssertionError("IVF-Flat distances are not finite")
    main_launches = {name: bf_launches[name] + ivf_launches[name]
                     for name in gk.LAUNCHES}

    # ---- 5. each kernel against its plain version, at the main path's
    # shapes (launches here are not counted in the kernels line)
    kernels = []
    x = queries
    xn, yn = row_norms_sq(x), bf.norms
    scale = float(torch.maximum(xn.max(), yn.max()))
    got = gk.fused_l2_topk(x, dataset, K, xn, yn)
    want = gk.fused_l2_topk_plain(x, dataset, K, xn, yn)
    res = assert_topk_close(got, want, 1e-4 * scale, 1e-5, "fused_l2_topk")
    torch.cuda.synchronize()
    m, n = N_QUERIES, N_ROWS
    l2_bytes = 4 * (m * DIM + n * DIM + m + n) + 8 * m * K
    l2_ops = 2 * m * n * DIM
    kernels.append(dict(
        name="fused_l2_topk", route="cuda",
        source="raft_tpu_torch/csrc/fused_l2_topk.cu",
        replaces="raft_tpu/ops/pallas_kernels.py:610",
        launches=main_launches["fused_l2_topk"], agrees_with_plain=True, **res,
        ms=cuda_ms(lambda: gk.fused_l2_topk(x, dataset, K, xn, yn), 3),
        plain_ms=cuda_ms(lambda: gk.fused_l2_topk_plain(x, dataset, K, xn,
                                                        yn), 1, False),
        bound_ms=1e3 * max(l2_bytes / PEAK_BYTES_PER_S,
                           l2_ops / PEAK_FP32_FLOPS),
        bound_by="operations" if l2_ops / PEAK_FP32_FLOPS
        > l2_bytes / PEAK_BYTES_PER_S else "bytes",
        library_ms=None))
    emit({"phase": "kernel_check", **kernels[-1]})

    # the IVF kernel's inputs, as the fused search builds them
    qf = queries.to(torch.float32)
    scores, _ = ivf_flat._coarse_scores(qf, index.centers, index.metric)
    scores = scores.contiguous()
    _, probes = gk.streaming_select_k(scores, n_probes)
    qv = qf[:, None, :].expand(N_QUERIES, n_probes, DIM).contiguous()
    qn = row_norms_sq(qf)[:, None].expand(N_QUERIES, n_probes).contiguous()
    ivf_args = (probes, qv, qn, index.list_data, index.ensure_row_norms(),
                index.safe_ids(), K)
    res = assert_topk_close(gk.fused_ivf_topk(*ivf_args),
                            gk.fused_ivf_topk_plain(*ivf_args), 1e-4 * scale,
                            1e-5, "fused_ivf_topk")
    torch.cuda.synchronize()
    pad = index.list_data.shape[1]
    probed = torch.unique(probes.long())
    sizes = index.list_sizes.long()
    rows_scanned = int(sizes[probes.long()].sum())
    ivf_bytes = (4 * probes.numel() + 4 * qv.numel() + 4 * qn.numel()
                 + probed.numel() * pad * (DIM * 4 + 4 + 4)
                 + 8 * N_QUERIES * K)
    ivf_ops = 2 * DIM * rows_scanned
    kernels.append(dict(
        name="fused_ivf_topk", route="cuda",
        source="raft_tpu_torch/csrc/fused_ivf_topk.cu",
        replaces="raft_tpu/ops/pallas_kernels.py:798",
        launches=main_launches["fused_ivf_topk"], agrees_with_plain=True,
        **res,
        ms=cuda_ms(lambda: gk.fused_ivf_topk(*ivf_args), 5),
        plain_ms=cuda_ms(lambda: gk.fused_ivf_topk_plain(*ivf_args), 1, False),
        bound_ms=1e3 * max(ivf_bytes / PEAK_BYTES_PER_S,
                           ivf_ops / PEAK_FP32_FLOPS),
        bound_by="operations" if ivf_ops / PEAK_FP32_FLOPS
        > ivf_bytes / PEAK_BYTES_PER_S else "bytes",
        library_ms=None, rows_scanned=rows_scanned,
        # what one block per query reads: every probed row, per query
        design_read_bytes=rows_scanned * DIM * 4))
    emit({"phase": "kernel_check", **kernels[-1]})

    res = assert_topk_close(gk.streaming_select_k(scores, n_probes),
                            gk.streaming_select_k_plain(scores, n_probes),
                            0.0, 0.0, "select_k")
    torch.cuda.synchronize()
    sel_bytes = 4 * scores.numel() + 8 * N_QUERIES * n_probes
    sel_ops = scores.numel()
    kernels.append(dict(
        name="select_k", route="cuda", source="raft_tpu_torch/csrc/select_k.cu",
        replaces="raft_tpu/ops/pallas_kernels.py:428",
        launches=main_launches["select_k"], agrees_with_plain=True, **res,
        ms=cuda_ms(lambda: gk.streaming_select_k(scores, n_probes), 20),
        plain_ms=cuda_ms(lambda: gk.streaming_select_k_plain(scores,
                                                             n_probes), 3),
        bound_ms=1e3 * max(sel_bytes / PEAK_BYTES_PER_S,
                           sel_ops / PEAK_FP32_FLOPS),
        bound_by="bytes" if sel_bytes / PEAK_BYTES_PER_S
        >= sel_ops / PEAK_FP32_FLOPS else "operations",
        library_ms=cuda_ms(lambda: torch.topk(scores, n_probes, largest=False),
                           20)))
    emit({"phase": "kernel_check", **kernels[-1]})

    for kern in kernels:
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} was not launched on the "
                                 "main path")

    # ---- 6. the kernels line, then the result line
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
