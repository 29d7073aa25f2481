#!/usr/bin/env python3
"""Drive raft_tpu_torch's main path on one CUDA card and check every kernel.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``. At SIFT-1M's shape (1,000,000 × 128 float32 rows made from the
seed, 10,000 queries, k=10, L2) it

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the five CUDA kernels from ``raft_tpu_torch/csrc`` (timed);
3. runs exact search (``brute_force.build`` + ``search``), the main path's
   first part, with the launch counts set to 0 just before and read just
   after; its result is the ground truth;
4. runs IVF-Flat (``ivf_flat.build`` with 1024 lists + ``search`` with 32
   probes) the same way and checks recall@10 >= 0.90 against phase 3;
5. runs IVF-PQ at the repository's ``raft_ivf_pq.d64b8n1024`` configuration
   (1024 lists, pq_dim 64, pq_bits 8, 20 k-means iterations): the build;
   search with 32 probes in the decoded-cache regime the card's own memory
   picks (``fused_ivf_topk`` over a bf16 cache); the same search in the LUT
   regime, under a stated device memory that holds the packed codes but not
   the cache (``fused_pq_topk``); and 64 probes with k·2 candidates refined
   exactly. Recall@10 >= 0.80 in both regimes and >= 0.95 after refine (the
   probes double until a floor is met; no floor is lowered);
5b. runs CAGRA at the repository's ``raft_cagra.d32`` configuration
   (graph_degree 32, intermediate_graph_degree 64, NN-descent with 20
   iterations, then ``optimize``): the build, split into NN-descent and
   optimize; search with itopk 64, width 1 and the auto plan through
   ``fused_cagra_topk`` (recall@10 >= 0.90, itopk doubling up to 512 until
   met); and the glue engine (``scan_mode="xla"``) on the first 1,000
   queries, held against the kernel path's result;
6. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gave it, and times kernel, plain version and, where
   one PyTorch call computes the same function, that call;
7. prints one ``{"kernels": [...]}`` line, then, as the last line,
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
# raft_tpu/bench/conf/sift-128-euclidean.json, raft_ivf_pq.d64b8n1024
PQ_DIM, PQ_BITS, PQ_RECALL_FLOOR, REFINE_PROBES, REFINE_RECALL_FLOOR = (
    64, 8, 0.80, 64, 0.95)
# raft_tpu/bench/conf/sift-128-euclidean.json:118-143, raft_cagra.d32
CAGRA_DEGREE, CAGRA_INTER, CAGRA_ITOPK, CAGRA_MAX_ITOPK = 32, 64, 64, 512
CAGRA_RECALL_FLOOR, CAGRA_GLUE_QUERIES = 0.90, 1000


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
        from raft_tpu_torch.core.resources import Resources
        from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
        from raft_tpu_torch.neighbors.refine import refine
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

    # ---- 5. IVF-PQ: build, the two regimes of the fused dispatch, refine
    gk.reset_launch_counts()
    pq_index, pq_build_s = timed(lambda: ivf_pq.build(
        dataset, ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                                    pq_bits=PQ_BITS, kmeans_n_iters=20)))
    pq_build_launches = dict(gk.LAUNCHES)
    pq_pad = pq_index.list_codes.shape[1]
    packed_bytes, cache_bytes = ivf_pq.scan_memory_bytes(pq_index)
    emit({"phase": "ivf_pq_build", "n_lists": N_LISTS, "pq_dim": PQ_DIM,
          "pq_bits": PQ_BITS, "build_seconds": pq_build_s,
          "list_pad": pq_pad,
          "overflow_rows": int((pq_index.overflow_indices >= 0).sum()),
          "packed_bytes": packed_bytes, "cache_bytes": cache_bytes,
          "launches": pq_build_launches})

    def pq_phase(name, res, engine, floor, start_probes):
        """Search until the recall floor is met (probes doubling), with the
        launch counts set to 0 just before; the engine is asserted first."""
        n_probes = start_probes
        gk.reset_launch_counts()
        while True:
            params = ivf_pq.SearchParams(n_probes=n_probes)
            plan = ivf_pq.plan_search(pq_index, K, params, res=res)
            if plan.engine != engine:
                raise AssertionError(f"{name}: engine {plan.engine} "
                                     f"({plan.reason}), expected {engine}")
            _, first_s = timed(lambda: ivf_pq.search(pq_index, queries, K,
                                                     params, res=res))
            (v, i), search_s = timed(lambda: ivf_pq.search(
                pq_index, queries, K, params, res=res))
            recall = float(neighborhood_recall(i, gt_i))
            if recall >= floor or n_probes >= N_LISTS:
                break
            n_probes *= 2
        launches = dict(gk.LAUNCHES)
        emit({"phase": name, "engine": plan.engine, "reason": plan.reason,
              "n_probes": n_probes, "first_call_seconds": first_s,
              "search_seconds": search_s, "qps": N_QUERIES / search_s,
              "recall_at_10": recall, "launches": launches})
        if recall < floor:
            raise AssertionError(f"{name} recall {recall} < {floor}")
        if v.shape != (N_QUERIES, K) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: distances not finite and complete")
        return n_probes, launches

    card_res = Resources()
    pq_probes, pq_cache_launches = pq_phase(
        "ivf_pq", card_res, "pallas_cache", PQ_RECALL_FLOOR, N_PROBES)
    for name in ("fused_ivf_topk", "select_k"):
        if pq_cache_launches[name] < 1:
            raise AssertionError(f"ivf_pq (cache regime) did not launch {name}")
    # the cache regime's kernel inputs, kept for the kernel check; the index
    # drops its cache so that the LUT regime runs without one
    pq_cache = (pq_index.list_decoded, pq_index.decoded_norms)
    ivf_pq.drop_scan_cache(pq_index)
    lut_res = Resources(device_memory_bytes=packed_bytes + cache_bytes)
    lut_probes, pq_lut_launches = pq_phase(
        "ivf_pq_lut", lut_res, "pallas_lut", PQ_RECALL_FLOOR, N_PROBES)
    if pq_lut_launches["fused_pq_topk"] < 1:
        raise AssertionError("ivf_pq (LUT regime) did not launch fused_pq_topk")
    if pq_index.list_decoded is not None:
        raise AssertionError("the LUT regime built the decoded cache")

    gk.reset_launch_counts()
    refine_probes = REFINE_PROBES
    while True:
        params = ivf_pq.SearchParams(n_probes=refine_probes)

        def search_refine():
            _, cand = ivf_pq.search(pq_index, queries, 2 * K, params,
                                    res=lut_res)
            return refine(dataset, queries, cand, K)

        _, refine_first_s = timed(search_refine)
        (rv, ri), refine_s = timed(search_refine)
        refine_recall = float(neighborhood_recall(ri, gt_i))
        if refine_recall >= REFINE_RECALL_FLOOR or refine_probes >= N_LISTS:
            break
        refine_probes *= 2
    refine_launches = dict(gk.LAUNCHES)
    emit({"phase": "ivf_pq_refine", "n_probes": refine_probes,
          "candidates": 2 * K, "first_call_seconds": refine_first_s,
          "seconds": refine_s, "qps": N_QUERIES / refine_s,
          "recall_at_10": refine_recall, "launches": refine_launches})
    if refine_recall < REFINE_RECALL_FLOOR:
        raise AssertionError(f"refined recall {refine_recall} < "
                             f"{REFINE_RECALL_FLOOR}")
    if not bool(torch.isfinite(rv).all()):
        raise AssertionError("refined distances are not finite")

    # ---- 5b. CAGRA: build (NN-descent + optimize), the kernel engine, the
    # glue engine on a slice of the queries
    gk.reset_launch_counts()
    cg_params = cagra.IndexParams(graph_degree=CAGRA_DEGREE,
                                  intermediate_graph_degree=CAGRA_INTER,
                                  nn_descent_niter=20)
    cg_index, cg_build_s = timed(lambda: cagra.build(dataset, cg_params))
    cg_build_launches = dict(gk.LAUNCHES)
    g = cg_index.graph
    if g.shape != (N_ROWS, CAGRA_DEGREE) or bool((g < 0).any()) \
            or bool((g >= N_ROWS).any()):
        raise AssertionError("the CAGRA graph is not complete and in range")
    emit({"phase": "cagra_build", "graph_degree": CAGRA_DEGREE,
          "intermediate_graph_degree": CAGRA_INTER, "nn_descent_niter": 20,
          "build_seconds": cg_build_s,
          "nn_descent_seconds": cg_index.build_seconds["knn_graph"],
          "optimize_seconds": cg_index.build_seconds["optimize"],
          "launches": cg_build_launches})
    itopk = CAGRA_ITOPK
    gk.reset_launch_counts()
    while True:
        cg_sp = cagra.SearchParams(itopk_size=itopk, search_width=1)
        cg_plan = cagra.plan_search(cg_index, K, cg_sp)
        if cg_plan.engine != "pallas":
            raise AssertionError(f"cagra: engine {cg_plan.engine} "
                                 f"({cg_plan.reason}), expected pallas")
        _, cg_first_s = timed(lambda: cagra.search(cg_index, queries, K,
                                                   cg_sp))
        (cv, ci), cg_s = timed(lambda: cagra.search(cg_index, queries, K,
                                                    cg_sp))
        cg_recall = float(neighborhood_recall(ci, gt_i))
        if cg_recall >= CAGRA_RECALL_FLOOR or itopk >= CAGRA_MAX_ITOPK:
            break
        itopk *= 2
    cagra_launches = dict(gk.LAUNCHES)
    if cagra_launches["fused_cagra_topk"] < 1:
        raise AssertionError("cagra.search did not launch fused_cagra_topk")
    if cv.shape != (N_QUERIES, K) or not bool(torch.isfinite(cv).all()):
        raise AssertionError("cagra: distances not finite and complete")
    # the walk's counts, from the plain version on the same inputs (its
    # result equals the kernel's bitwise, checked in phase 6)
    cg_args = (queries, dataset, cg_index.graph,
               cagra.seed_table(cg_sp, N_QUERIES, N_ROWS,
                                cg_plan.plan["n_seeds"], dev),
               gk.beam_norms(queries))
    cg_max_iter = cg_plan.plan["max_iter"]
    *_, cg_stats = gk.fused_cagra_topk_plain(*cg_args, K, itopk, 1,
                                             cg_max_iter, return_stats=True)
    cg_hops, cg_rows = (int(cg_stats["hops"].sum()),
                        int(cg_stats["rows_scored"].sum()))
    cg_touched, cg_expanded = (cg_stats["rows_touched"],
                               cg_stats["nodes_expanded"])
    nq_glue = CAGRA_GLUE_QUERIES
    glue_sp = cagra.SearchParams(itopk_size=itopk, search_width=1,
                                 scan_mode="xla")
    glue, glue_s = timed(lambda: cagra.search(cg_index, queries[:nq_glue], K,
                                              glue_sp))
    glue_agree = assert_topk_close(
        glue, (cv[:nq_glue], ci[:nq_glue]),
        1e-4 * float(torch.maximum(row_norms_sq(queries).max(),
                                   bf.norms.max())), 1e-5, "cagra glue")
    emit({"phase": "cagra", "itopk": itopk, "search_width": 1,
          "max_iter": cg_max_iter, "n_seeds": cg_plan.plan["n_seeds"],
          "first_call_seconds": cg_first_s, "search_seconds": cg_s,
          "qps": N_QUERIES / cg_s, "recall_at_10": cg_recall,
          "mean_hops": cg_hops / N_QUERIES, "rows_scored": cg_rows,
          "rows_touched": cg_touched, "nodes_expanded": cg_expanded,
          "glue_queries": nq_glue, "glue_seconds": glue_s,
          "glue_vs_kernel": glue_agree, "launches": cagra_launches})
    if cg_recall < CAGRA_RECALL_FLOOR:
        raise AssertionError(f"cagra recall {cg_recall} < "
                             f"{CAGRA_RECALL_FLOOR}")
    main_phases = (bf_launches, ivf_launches, pq_build_launches,
                   pq_cache_launches, pq_lut_launches, refine_launches,
                   cg_build_launches, cagra_launches)
    main_launches = {name: sum(ph[name] for ph in main_phases)
                     for name in gk.LAUNCHES}

    # ---- 6. each kernel against its plain version, at the main path's
    # shapes (launches here are not counted in the kernels line)
    def bound(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_FLOPS
        return {"bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "operations" if t_ops > t_bytes else "bytes"}

    def check(entry, kernel, plain, args, atol, rtol, reps):
        """Hold kernel(*args) against plain(*args), time both, add the
        kernel's entry to the kernels line."""
        res = assert_topk_close(kernel(*args), plain(*args), atol, rtol,
                                entry["name"])
        torch.cuda.synchronize()
        entry.update(agrees_with_plain=True, **res,
                     ms=cuda_ms(lambda: kernel(*args), reps),
                     plain_ms=cuda_ms(lambda: plain(*args), 1, False))
        kernels.append(entry)
        emit({"phase": "kernel_check", **entry})

    def adc_scale(plain, args):
        """The largest finite distance of the plain result: the scale of the
        ADC distances' tolerance."""
        v = plain(*args)[0]
        return float(v[torch.isfinite(v)].abs().max())

    kernels = []
    x = queries
    xn, yn = row_norms_sq(x), bf.norms
    scale = float(torch.maximum(xn.max(), yn.max()))
    m, n = N_QUERIES, N_ROWS
    check(dict(name="fused_l2_topk", route="cuda",
               source="raft_tpu_torch/csrc/fused_l2_topk.cu",
               replaces="raft_tpu/ops/pallas_kernels.py:610",
               shape=f"{m} x {n} x {DIM}, k={K}",
               launches=main_launches["fused_l2_topk"], library_ms=None,
               **bound(4 * (m * DIM + n * DIM + m + n) + 8 * m * K,
                       2 * m * n * DIM)),
          gk.fused_l2_topk, gk.fused_l2_topk_plain, (x, dataset, K, xn, yn),
          1e-4 * scale, 1e-5, 3)

    # the IVF kernel's inputs, as the fused IVF-Flat search builds them
    qf = queries.to(torch.float32)
    scores, _ = ivf_flat._coarse_scores(qf, index.centers, index.metric)
    scores = scores.contiguous()
    _, probes = gk.streaming_select_k(scores, n_probes)
    qv = qf[:, None, :].expand(N_QUERIES, n_probes, DIM).contiguous()
    qn = row_norms_sq(qf)[:, None].expand(N_QUERIES, n_probes).contiguous()
    pad = index.list_data.shape[1]
    rows_scanned = int(index.list_sizes.long()[probes.long()].sum())
    n_probed = torch.unique(probes.long()).numel()
    check(dict(name="fused_ivf_topk", route="cuda",
               source="raft_tpu_torch/csrc/fused_ivf_topk.cu",
               replaces="raft_tpu/ops/pallas_kernels.py:798",
               shape=f"ivf_flat: {N_QUERIES} queries x {n_probes} probes, "
                     f"pad {pad}, rot {DIM}, f32, clamp",
               launches=ivf_launches["fused_ivf_topk"], library_ms=None,
               rows_scanned=rows_scanned,
               **bound(4 * (probes.numel() + qv.numel() + qn.numel())
                       + n_probed * pad * (DIM * 4 + 4 + 4)
                       + 8 * N_QUERIES * K, 2 * DIM * rows_scanned)),
          gk.fused_ivf_topk, gk.fused_ivf_topk_plain,
          (probes, qv, qn, index.list_data, index.ensure_row_norms(),
           index.safe_ids(), K), 1e-4 * scale, 1e-5, 5)

    # the IVF-PQ cache regime's kernel inputs, as _search_fused_cache_core
    # builds them
    rot = pq_index.rot_dim
    pq_sizes = pq_index.list_sizes.long()
    q_rot, centers_rot, pq_pr = ivf_pq._coarse_probes_rot(queries, pq_index,
                                                         pq_probes)
    qr_res = (q_rot[:, None, :] - centers_rot[pq_pr.long()]).contiguous()
    qr_n = (qr_res * qr_res).sum(-1).contiguous()
    args = (pq_pr, qr_res, qr_n, pq_cache[0], pq_cache[1],
            pq_index.safe_ids(), K, False)
    rows_scanned = int(pq_sizes[pq_pr.long()].sum())
    n_probed = torch.unique(pq_pr.long()).numel()
    check(dict(name="fused_ivf_topk", route="cuda",
               source="raft_tpu_torch/csrc/fused_ivf_topk.cu",
               replaces="raft_tpu/ops/pallas_kernels.py:798",
               shape=f"ivf_pq cache: {N_QUERIES} queries x {pq_probes} probes,"
                     f" pad {pq_pad}, rot {rot}, bf16, no clamp",
               launches=pq_cache_launches["fused_ivf_topk"], library_ms=None,
               rows_scanned=rows_scanned,
               **bound(4 * (pq_pr.numel() + qr_res.numel() + qr_n.numel())
                       + n_probed * pq_pad * (rot * 2 + 4 + 4)
                       + 8 * N_QUERIES * K, 2 * rot * rows_scanned)),
          gk.fused_ivf_topk, gk.fused_ivf_topk_plain, args,
          1e-4 * adc_scale(gk.fused_ivf_topk_plain, args), 1e-5, 5)
    del pq_cache, args, qr_res

    # the LUT regime's kernel inputs, as _search_fused_lut_core builds them
    q_rot, centers_rot, lut_pr = ivf_pq._coarse_probes_rot(queries, pq_index,
                                                          lut_probes)
    codebooks = pq_index.codebooks.contiguous()
    cb_norms = (codebooks * codebooks).sum(-1).contiguous()
    args = (lut_pr, q_rot, centers_rot, codebooks, cb_norms,
            pq_index.list_codes, pq_index.safe_ids(), K)
    rows_scanned = int(pq_sizes[lut_pr.long()].sum())
    n_probed = torch.unique(lut_pr.long()).numel()
    n_luts = lut_pr.numel()
    pq_len = pq_index.pq_len
    check(dict(name="fused_pq_topk", route="cuda",
               source="raft_tpu_torch/csrc/fused_pq_topk.cu",
               replaces="raft_tpu/ops/pallas_kernels.py:989",
               shape=f"ivf_pq lut: {N_QUERIES} queries x {lut_probes} probes,"
                     f" pad {pq_pad}, pq_dim {PQ_DIM}, pq_len {pq_len}",
               launches=pq_lut_launches["fused_pq_topk"], library_ms=None,
               rows_scanned=rows_scanned, luts=n_luts,
               **bound(4 * (lut_pr.numel() + q_rot.numel()
                            + centers_rot.numel() + codebooks.numel()
                            + cb_norms.numel())
                       + n_probed * pq_pad * (PQ_DIM + 4) + 8 * N_QUERIES * K,
                       n_luts * PQ_DIM * 256 * (2 * pq_len + 2)
                       + rows_scanned * PQ_DIM)),
          gk.fused_pq_topk, gk.fused_pq_topk_plain, args,
          1e-4 * adc_scale(gk.fused_pq_topk_plain, args), 1e-5, 3)

    res = assert_topk_close(gk.streaming_select_k(scores, n_probes),
                            gk.streaming_select_k_plain(scores, n_probes),
                            0.0, 0.0, "select_k")
    torch.cuda.synchronize()
    kernels.append(dict(
        name="select_k", route="cuda", source="raft_tpu_torch/csrc/select_k.cu",
        replaces="raft_tpu/ops/pallas_kernels.py:428",
        shape=f"[{N_QUERIES} x {N_LISTS}], k={n_probes}",
        launches=main_launches["select_k"], agrees_with_plain=True, **res,
        ms=cuda_ms(lambda: gk.streaming_select_k(scores, n_probes), 20),
        plain_ms=cuda_ms(lambda: gk.streaming_select_k_plain(scores,
                                                             n_probes), 3),
        **bound(4 * scores.numel() + 8 * N_QUERIES * n_probes, scores.numel()),
        library_ms=cuda_ms(lambda: torch.topk(scores, n_probes, largest=False),
                           20)))
    emit({"phase": "kernel_check", **kernels[-1]})

    # the beam walk: each row it touches read once, each node's graph row
    # once; a dot product per (query, row) scored and one norm per row
    n_seeds = cg_plan.plan["n_seeds"]
    check(dict(name="fused_cagra_topk", route="cuda",
               source="raft_tpu_torch/csrc/fused_cagra_topk.cu",
               replaces="raft_tpu/ops/pallas_kernels.py:1368",
               shape=f"cagra: {N_QUERIES} queries, itopk {itopk}, width 1, "
                     f"degree {CAGRA_DEGREE}, dim {DIM}, {n_seeds} seeds, "
                     f"max_iter {cg_max_iter}",
               launches=cagra_launches["fused_cagra_topk"], library_ms=None,
               hops=cg_hops, rows_scored=cg_rows, rows_touched=cg_touched,
               nodes_expanded=cg_expanded,
               **bound(cg_touched * DIM * 4 + cg_expanded * CAGRA_DEGREE * 4
                       + 4 * N_QUERIES * (DIM + 1 + n_seeds)
                       + 8 * N_QUERIES * K,
                       2 * DIM * (cg_rows + cg_touched))),
          lambda *a: gk.fused_cagra_topk(*a, K, itopk, 1, cg_max_iter),
          lambda *a: gk.fused_cagra_topk_plain(*a, K, itopk, 1, cg_max_iter),
          cg_args, 0.0, 0.0, 5)

    # a model, not a measurement: the bytes the one-block-per-query designs
    # would read if nothing were reused between blocks (every probed row
    # once per query; the LUT kernel's codebooks and their norms once per
    # (query, probe); the beam walk's rows once per visit and its graph rows
    # once per hop); nothing in the run measures it
    rows = [k["rows_scanned"] for k in kernels[1:4]]
    emit({"phase": "read_model", "measured": False,
          "fused_ivf_topk_ivf_flat_bytes": rows[0] * DIM * 4,
          "fused_ivf_topk_ivf_pq_cache_bytes": rows[1] * rot * 2,
          "fused_pq_topk_code_and_id_bytes": rows[2] * PQ_DIM
          + n_luts * pq_pad * 4,
          "fused_pq_topk_codebook_bytes": n_luts * PQ_DIM * 256
          * (pq_len + 1) * 4,
          "fused_cagra_topk_visit_bytes": cg_rows * DIM * 4
          + cg_hops * CAGRA_DEGREE * 4})

    for kern in kernels:
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} was not launched on the "
                                 "main path")

    # ---- 7. the kernels line, then the result line
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
