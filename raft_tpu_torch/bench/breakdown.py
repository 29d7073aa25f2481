"""Where a warm search's time goes on the card, by kernel.

    python3 -m raft_tpu_torch.bench.breakdown [--seed N]

Builds chip_smoke.py's configuration (SIFT-1M's shape from the seed:
1,000,000 × 128 rows, 10,000 queries, k=10; IVF-Flat with 1024 lists and
32 probes; IVF-PQ at ``raft_ivf_pq.d64b8n1024`` with 32 probes, in the
decoded-cache regime the card's memory picks and in the LUT regime of a
stated device memory that holds the packed codes but not the cache; CAGRA
at ``raft_cagra.d32`` with itopk 64, through the kernel engine on every
query and the glue engine on the first 1,000; IVF-Flat and the IVF-PQ cache
engine again under chip_smoke.py's filter, which removes 10% of the row
ids and sends both through the ``ivf_scan`` kernel; inner-product IVF-Flat
at chip_smoke.py's glove-100-inner shape (1,183,514 × 100 unit-norm rows
from the seed, 1024 lists, 32 probes), also through ``ivf_scan``; Lloyd
k-means with 1024
clusters, k-means++ init and 20 iterations; the sharded path over 4 logical
ranks on the card: exact kNN with each merge engine, IVF-Flat and IVF-PQ
(cache regime), 1024 lists a rank, with the ring merge), runs
each call once to warm up, then once under ``torch.profiler``, and prints
one JSON line per call: host wall time, the device time summed over
kernels, their share of the wall time, and the kernels that take the most
device time. For each sharded search a second line profiles its cross-rank
merge alone, on the candidates the search handed it. ``--only sharded``
runs the sharded part alone. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.parallel import comms, sharded

N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 10_000, 10
N_LISTS, N_PROBES = 1024, 32
PQ_DIM, PQ_BITS = 64, 8
CAGRA_DEGREE, CAGRA_INTER, CAGRA_ITOPK, CAGRA_GLUE_QUERIES = 32, 64, 64, 1000
KM_CLUSTERS, KM_ITERS, FILTER_REMOVED = 1024, 20, 0.10
N_RANKS = 4
IP_ROWS, IP_DIM = 1_183_514, 100  # raft-ann-bench glove-100-inner


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_call(name: str, fn, top: int = 8,
                 label: Optional[str] = None) -> dict:
    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): the CPU ops that launched
    # them, and the trace ranges around them, report the same time again
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)
               and e.key not in (f"{name}.search", f"{name}.build")
               and _device_us(e) > 0]
    kernels.sort(key=lambda t: -t[1])
    device_ms = sum(us for _, us, _ in kernels) / 1e3
    return {"search": label or name, "wall_ms": wall_s * 1e3,
            "device_ms": device_ms,
            "device_busy_share": device_ms / (wall_s * 1e3),
            "top_kernels": [{"name": n[:80], "ms": us / 1e3, "calls": c}
                            for n, us, c in kernels[:top]]}


def profile_sharded(dataset, queries, seed: int) -> None:
    """The sharded searches over N_RANKS logical ranks on the card, and
    each one's merge alone (on the candidates its last call merged)."""
    ring = comms.init_comms([dataset.device] * N_RANKS)
    merges, plan_merge = [], sharded._plan_merge

    def keep_merge(*a):
        merges.append(a)
        return plan_merge(*a)

    sharded._plan_merge = keep_merge
    try:
        for mode in ("allgather", "tree", "ring"):
            print(json.dumps(profile_call(
                "sharded.knn", lambda: sharded.knn(ring, queries, dataset, K,
                                                   merge_mode=mode),
                label=f"sharded_knn_{mode}")))
            print(json.dumps(profile_call(
                "sharded.merge", lambda: plan_merge(*merges[-1]),
                label=f"sharded_knn_{mode}_merge")))
        index = sharded.build_ivf_flat(ring, dataset, ivf_flat.IndexParams(
            n_lists=N_LISTS), res=Resources(seed=seed))
        params = ivf_flat.SearchParams(n_probes=N_PROBES)
        print(json.dumps(profile_call(
            "sharded.ivf_flat", lambda: sharded.search_ivf_flat(
                index, queries, K, params, merge_mode="ring"),
            label="sharded_ivf_flat_ring")))
        print(json.dumps(profile_call(
            "sharded.merge", lambda: plan_merge(*merges[-1]),
            label="sharded_ivf_flat_ring_merge")))
        del index
        index = sharded.build_ivf_pq(ring, dataset, ivf_pq.IndexParams(
            n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=PQ_BITS),
            res=Resources(seed=seed), scan_mode="cache")
        pq_params = ivf_pq.SearchParams(n_probes=N_PROBES)
        print(json.dumps(profile_call(
            "sharded.ivf_pq", lambda: sharded.search_ivf_pq(
                index, queries, K, pq_params, merge_mode="ring"),
            label="sharded_ivf_pq_cache_ring")))
    finally:
        sharded._plan_merge = plan_merge


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("all", "sharded"), default="all")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rows = low_rank_clusters(np.random.default_rng(args.seed),
                             N_ROWS + N_QUERIES, DIM)
    dataset = torch.from_numpy(rows[:N_ROWS]).to(dev)
    queries = torch.from_numpy(rows[N_ROWS:]).to(dev)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    if args.only == "sharded":
        profile_sharded(dataset, queries, args.seed)
        return 0
    bf = brute_force.build(dataset, metric="sqeuclidean")
    index = ivf_flat.build(dataset, ivf_flat.IndexParams(n_lists=N_LISTS))
    params = ivf_flat.SearchParams(n_probes=N_PROBES)
    print(json.dumps(profile_call(
        "brute_force", lambda: brute_force.search(bf, queries, K))))
    print(json.dumps(profile_call(
        "ivf_flat", lambda: ivf_flat.search(index, queries, K, params))))
    # chip_smoke.py's filter: 10% of the row ids removed, drawn from the seed
    keep = np.ones(N_ROWS, bool)
    keep[np.random.default_rng(args.seed).choice(
        N_ROWS, int(FILTER_REMOVED * N_ROWS), replace=False)] = False
    filt = Bitset.from_mask(torch.from_numpy(keep).to(dev))
    print(json.dumps(profile_call(
        "ivf_flat", lambda: ivf_flat.search(index, queries, K, params,
                                            filter=filt),
        label="ivf_flat_filtered")))
    del index
    pq_index = ivf_pq.build(dataset, ivf_pq.IndexParams(
        n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=PQ_BITS))
    pq_params = ivf_pq.SearchParams(n_probes=N_PROBES)
    print(json.dumps(profile_call(
        "ivf_pq", lambda: ivf_pq.search(pq_index, queries, K, pq_params),
        label="ivf_pq_cache")))
    print(json.dumps(profile_call(
        "ivf_pq", lambda: ivf_pq.search(pq_index, queries, K, pq_params,
                                        filter=filt),
        label="ivf_pq_cache_filtered")))
    ivf_pq.drop_scan_cache(pq_index)
    ip_rows = low_rank_clusters(np.random.default_rng(args.seed + 1),
                                IP_ROWS + N_QUERIES, IP_DIM)
    ip_rows /= np.linalg.norm(ip_rows, axis=1, keepdims=True)
    ip_data = torch.from_numpy(ip_rows[:IP_ROWS]).to(dev)
    ip_queries = torch.from_numpy(ip_rows[IP_ROWS:]).to(dev)
    ip_index = ivf_flat.build(ip_data, ivf_flat.IndexParams(
        n_lists=N_LISTS, metric="inner_product"))
    print(json.dumps(profile_call(
        "ivf_flat", lambda: ivf_flat.search(ip_index, ip_queries, K, params),
        label="ivf_flat_inner_product")))
    del ip_rows, ip_data, ip_queries, ip_index
    lut_res = Resources(device_memory_bytes=sum(
        ivf_pq.scan_memory_bytes(pq_index)))
    if ivf_pq.plan_search(pq_index, K, pq_params,
                          res=lut_res).engine != "pallas_lut":
        raise AssertionError("the stated device memory did not pick the "
                             "fused LUT engine")
    print(json.dumps(profile_call(
        "ivf_pq", lambda: ivf_pq.search(pq_index, queries, K, pq_params,
                                        res=lut_res), label="ivf_pq_lut")))
    del pq_index
    cg_index = cagra.build(dataset, cagra.IndexParams(
        graph_degree=CAGRA_DEGREE, intermediate_graph_degree=CAGRA_INTER,
        nn_descent_niter=20))
    for mode, nq in (("auto", N_QUERIES), ("xla", CAGRA_GLUE_QUERIES)):
        sp = cagra.SearchParams(itopk_size=CAGRA_ITOPK, scan_mode=mode)
        print(json.dumps(profile_call(
            "cagra", lambda: cagra.search(cg_index, queries[:nq], K, sp),
            label=f"cagra_{cagra.plan_search(cg_index, K, sp).engine}"
                  f"_{nq}_queries")))
    del cg_index
    km_params = kmeans.KMeansParams(n_clusters=KM_CLUSTERS, max_iter=KM_ITERS)
    print(json.dumps(profile_call(
        "kmeans", lambda: kmeans.fit(dataset, km_params,
                                     res=Resources(seed=args.seed)),
        label="kmeans_fit")))
    profile_sharded(dataset, queries, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
