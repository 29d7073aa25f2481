"""Micro-benchmarks for the primitive layer.

Counterpart of ``raft_tpu.bench.prims``. Reference: ``cpp/bench/prims`` —
google-benchmark suites with CUDA-event timing for distance, select_k,
fused L2 NN, k-means and random prims. Here each case is timed on the card
(default) by ``bench.timing.time_dispatches``: a warm call, then calls
launched back to back and one synchronise. Run as
``python -m raft_tpu_torch.bench.prims [case ...] [--device cpu]``; one
JSON line per case: {"case", "shape", "ms", "gb_s" | "gflops"}.
"""

from __future__ import annotations

import json
from typing import Callable, Dict

import numpy as np
import torch

from raft_tpu_torch.bench.timing import prepare, time_dispatches


def _inputs(device, *shapes):
    rng = np.random.default_rng(0)
    return [prepare(rng.standard_normal(s).astype(np.float32), device)
            for s in shapes]


def bench_pairwise(device, m=4096, n=4096, d=128, metric="sqeuclidean"):
    from raft_tpu_torch.ops.distance import pairwise_core, resolve_metric

    x, y = _inputs(device, (m, d), (n, d))
    mt = resolve_metric(metric)
    dt = time_dispatches(lambda: pairwise_core(x, y, mt), iters=10)
    return {"case": f"pairwise_{metric}", "shape": [m, n, d],
            "ms": round(dt * 1e3, 3),
            "gflops": round(2.0 * m * n * d / dt / 1e9, 1)}


def bench_fused_l2_nn(device, m=100_000, n=1024, d=128):
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.ops.fused_l2_nn import fused_l2_nn_argmin

    x, y = _inputs(device, (m, d), (n, d))
    res = Resources(device=device)
    dt = time_dispatches(lambda: fused_l2_nn_argmin(x, y, res=res),
                         iters=10)
    return {"case": "fused_l2_nn", "shape": [m, n, d],
            "ms": round(dt * 1e3, 3),
            "gflops": round(2.0 * m * n * d / dt / 1e9, 1)}


def bench_select_k(device, batch=1024, n=16384, k=64):
    from raft_tpu_torch.ops.select_k import select_k

    (x,) = _inputs(device, (batch, n))
    dt = time_dispatches(lambda: select_k(x, k, select_min=True), iters=10)
    return {"case": "select_k", "shape": [batch, n, k],
            "ms": round(dt * 1e3, 3),
            "gb_s": round(batch * n * 4 / 1e9 / dt, 1)}


def bench_kmeans_iter(device, m=100_000, d=96, c=1024):
    from raft_tpu_torch.cluster.kmeans import _assign
    from raft_tpu_torch.ops.distance import row_norms_sq

    x, cen = _inputs(device, (m, d), (c, d))
    xn = row_norms_sq(x)
    dt = time_dispatches(lambda: _assign(x, xn, cen), iters=10)
    return {"case": "kmeans_assign", "shape": [m, d, c],
            "ms": round(dt * 1e3, 3),
            "gflops": round(2.0 * m * c * d / dt / 1e9, 1)}


def bench_rng(device, n=10_000_000):
    from raft_tpu_torch.ops import rng as rrng

    dt = time_dispatches(lambda: rrng.normal(0, (n,), device=device),
                         iters=10)
    return {"case": "rng_normal", "shape": [n], "ms": round(dt * 1e3, 3),
            "gb_s": round(n * 4 / dt / 1e9, 1)}


CASES: Dict[str, Callable] = {
    "pairwise": bench_pairwise,
    "fused_l2_nn": bench_fused_l2_nn,
    "select_k": bench_select_k,
    "kmeans_assign": bench_kmeans_iter,
    "rng": bench_rng,
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.bench.prims")
    ap.add_argument("cases", nargs="*", default=list(CASES))
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device or "cuda")
    for name in args.cases:
        print(json.dumps(CASES[name](device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
