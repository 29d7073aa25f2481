"""Where a warm search's time goes on the card, by kernel.

    python3 -m raft_tpu_torch.bench.breakdown [--seed N]

Builds chip_smoke.py's configuration (SIFT-1M's shape from the seed:
1,000,000 × 128 rows, 10,000 queries, k=10; IVF-Flat with 1024 lists and
32 probes; IVF-PQ at ``raft_ivf_pq.d64b8n1024`` with 32 probes, in the
decoded-cache regime the card's memory picks and in the LUT regime of a
stated device memory that holds the packed codes but not the cache; CAGRA
at ``raft_cagra.d32`` with itopk 64, through the kernel engine on every
query and the glue engine on the first 1,000), runs
each search once to warm up, then once under ``torch.profiler``, and prints
one JSON line per search: host wall time, the device time summed over
kernels, their share of the wall time, and the kernels that take the most
device time. Needs a CUDA card.
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
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 10_000, 10
N_LISTS, N_PROBES = 1024, 32
PQ_DIM, PQ_BITS = 64, 8
CAGRA_DEGREE, CAGRA_INTER, CAGRA_ITOPK, CAGRA_GLUE_QUERIES = 32, 64, 64, 1000


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
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
    bf = brute_force.build(dataset, metric="sqeuclidean")
    index = ivf_flat.build(dataset, ivf_flat.IndexParams(n_lists=N_LISTS))
    params = ivf_flat.SearchParams(n_probes=N_PROBES)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    print(json.dumps(profile_call(
        "brute_force", lambda: brute_force.search(bf, queries, K))))
    print(json.dumps(profile_call(
        "ivf_flat", lambda: ivf_flat.search(index, queries, K, params))))
    del index
    pq_index = ivf_pq.build(dataset, ivf_pq.IndexParams(
        n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=PQ_BITS))
    pq_params = ivf_pq.SearchParams(n_probes=N_PROBES)
    print(json.dumps(profile_call(
        "ivf_pq", lambda: ivf_pq.search(pq_index, queries, K, pq_params),
        label="ivf_pq_cache")))
    ivf_pq.drop_scan_cache(pq_index)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
