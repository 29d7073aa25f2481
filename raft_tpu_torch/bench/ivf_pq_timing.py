"""Warm IVF-PQ search times on one saved index, to time two trees alike.

    python3 raft_tpu_torch/bench/ivf_pq_timing.py --index PATH --build
    PYTHONPATH=TREE python3 raft_tpu_torch/bench/ivf_pq_timing.py --index PATH

``--build`` builds chip_smoke.py's IVF-PQ index (``raft_ivf_pq.d64b8n1024``
on SIFT-1M's shape from the seed: 1,000,000 × 128 rows, 1024 lists, pq_dim
64, pq_bits 8) and saves it to PATH without its scan cache; without it the
script loads PATH. Run as a file, it imports the ``raft_tpu_torch`` that
``PYTHONPATH`` names, so one saved index times the package of two trees
(the builds' spill varies run to run, which would otherwise mix with the
code's own cost). It then times, on 10,000 queries with k=10, warm searches
with the card synchronised around each (host clock): 32 probes in the
decoded-cache regime, 32 probes in the LUT regime (under
``Resources(device_memory_bytes=packed + cache)``), and 64 probes for 20
candidates refined exactly; and, with CUDA events, the fused engines'
overflow step (``_fused_merge_overflow``: the overflow scan and one
``select_k``) and its ``select_k`` alone. Prints one JSON line with every
time and the package's path. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 10_000, 10
N_LISTS, N_PROBES, REFINE_PROBES, PQ_DIM, PQ_BITS = 1024, 32, 64, 64, 8


def _wall_s(fn, reps: int) -> list:
    fn()  # warm
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _event_ms(fn, reps: int) -> float:
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
    parser.add_argument("--index", required=True)
    parser.add_argument("--build", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=7)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ivf_pq_timing: no CUDA device", file=sys.stderr)
        return 2
    import raft_tpu_torch
    from raft_tpu_torch.bench.datagen import low_rank_clusters
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops.select_k import select_k

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gk.build_all()
    rows = low_rank_clusters(np.random.default_rng(args.seed),
                             N_ROWS + N_QUERIES, DIM)
    dataset = torch.from_numpy(rows[:N_ROWS]).to(dev)
    queries = torch.from_numpy(rows[N_ROWS:]).to(dev)
    if args.build:
        index = ivf_pq.build(dataset, ivf_pq.IndexParams(
            n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=PQ_BITS,
            kmeans_n_iters=20))
        ivf_pq.drop_scan_cache(index)
        torch.save(index, args.index)
    else:
        index = torch.load(args.index, map_location=dev, weights_only=False)
    out = {"package": raft_tpu_torch.__file__,
           "overflow_rows": int((index.overflow_indices >= 0).sum())}
    params = ivf_pq.SearchParams(n_probes=N_PROBES)
    out["cache_s"] = _wall_s(
        lambda: ivf_pq.search(index, queries, K, params), args.reps)
    out["cache_engine"] = ivf_pq.plan_search(index, K, params).engine
    v, i = ivf_pq.search(index, queries, K, params)
    q_rot, _, _ = ivf_pq._coarse_probes_rot(queries, index, N_PROBES)
    if index.overflow_codes.shape[0] > 0:
        od, oi = ivf_pq._pq_overflow_scan(
            q_rot, index.overflow_decoded, index.overflow_norms,
            index.overflow_indices, None, index.metric, torch.inf)
        cat_v, cat_i = torch.cat([v, od], 1), torch.cat([i, oi], 1)
        out["merge_width"] = cat_v.shape[1]
        out["overflow_step_ms"] = _event_ms(
            lambda: ivf_pq._fused_merge_overflow(v, i, q_rot, index, K),
            args.reps)
        out["merge_select_k_ms"] = _event_ms(
            lambda: select_k(cat_v, K, select_min=True, indices=cat_i),
            args.reps)
    ivf_pq.drop_scan_cache(index)
    lut_res = Resources(device_memory_bytes=sum(
        ivf_pq.scan_memory_bytes(index)))
    out["lut_engine"] = ivf_pq.plan_search(index, K, params,
                                           res=lut_res).engine
    out["lut_s"] = _wall_s(
        lambda: ivf_pq.search(index, queries, K, params, res=lut_res),
        args.reps)
    ref_params = ivf_pq.SearchParams(n_probes=REFINE_PROBES)

    def search_refine():
        _, cand = ivf_pq.search(index, queries, 2 * K, ref_params,
                                res=lut_res)
        return refine(dataset, queries, cand, K)

    out["refine_s"] = _wall_s(search_refine, args.reps)
    for name in ("cache_s", "lut_s", "refine_s"):
        out[name.replace("_s", "_median_s")] = float(np.median(out[name]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
