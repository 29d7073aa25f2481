"""Offline operating-point sweep → the committed Pareto frontier.

Counterpart of ``raft_tpu.planner.sweep`` and of the JAX package's
``tools/autotune.py``, as ``python -m raft_tpu_torch.planner.sweep``. Per
family/shape/k, measure every (params, query bucket) grid point **through
the serving handles' ``search_with``** (the code path the engine's adaptive
policy replays online) against an exact numpy oracle, then prune to the
Pareto-optimal QPS-vs-recall frontier
(:func:`raft_tpu_torch.planner.adaptive.pareto_prune`).

Each surviving point carries:

- ``qps``: queries/second at its bucket (bucket / best-of-N per-batch
  wall time, fenced by ``bench.timing``: the card synchronised);
- ``recall``: mean neighborhood recall vs the exact oracle over the
  whole eval query set;
- ``predicted_ms``: the per-batch device-time prediction the serving
  policy budgets against (the measured best-of-N batch time);
- ``roofline_min_ms``: the roofline floor of the family's dominant scan
  at this point (``obs.costs``' formulas and peaks; None on the CPU) — the
  anchor that flags a prediction promising less than physics allows.

``mini=True`` shrinks the grids to test scale (seconds on the CPU).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from raft_tpu_torch.planner import adaptive

__all__ = ["FAMILIES", "default_grid", "exact_oracle", "build_searcher",
           "sweep_family", "build_artifact", "check_artifact", "main"]

FAMILIES = ("brute_force", "ivf_flat", "ivf_pq", "cagra",
            "tiered_ivf_pq")


def default_grid(family: str, mini: bool = False) -> List[Dict[str, object]]:
    """The params grid per family: every knob combination the sweep
    measures (the frontier prune discards the dominated ones)."""
    if family == "brute_force":
        # exact search: the only speed/recall knob is the select stage's
        # exactness relaxation
        grid = [{"select_recall": 1.0}]
        if not mini:
            grid.append({"select_recall": 0.9})
        return grid
    if family in ("ivf_flat", "ivf_pq", "tiered_ivf_pq"):
        # tiered shares ivf_pq's knob: n_probes trades recall for scan
        # work AND arena churn (more probes -> more distinct lists per
        # batch -> lower hit rate at fixed slots), so the measured
        # frontier already prices the tier's fetch stalls
        probes = (4, 32) if mini else (4, 8, 16, 32, 64)
        return [{"n_probes": int(p)} for p in probes]
    if family == "cagra":
        if mini:
            combos = ((32, 1), (64, 4))
        else:
            combos = ((32, 1), (64, 1), (64, 4), (128, 4))
        # scan_mode is a knob: "auto" follows the card's measured probe
        # verdict, "pallas" forces the fused walk, so the frontier holds
        # a fused point wherever the kernel wins whatever the verdict. On
        # the CPU both run the plain version (the same rows, about the
        # same ms) and the prune drops the duplicate.
        modes = ("auto",) if mini else ("auto", "pallas")
        return [{"itopk_size": int(it), "search_width": int(w),
                 "scan_mode": mode}
                for it, w in combos for mode in modes]
    raise ValueError(f"unknown family {family!r}; expected one of "
                     f"{FAMILIES}")


def _params_key(params: Dict[str, object]) -> str:
    return json.dumps(params, sort_keys=True)


def exact_oracle(db: np.ndarray, queries: np.ndarray,
                 k: int) -> np.ndarray:
    """Ground-truth top-k indices by squared L2, pure numpy (no device,
    no jit — the oracle must not share code with the thing it grades)."""
    d2 = ((queries ** 2).sum(1)[:, None] + (db ** 2).sum(1)[None, :]
          - 2.0 * queries @ db.T)
    part = np.argpartition(d2, kth=k - 1, axis=1)[:, :k]
    order = np.take_along_axis(d2, part, axis=1).argsort(axis=1)
    return np.take_along_axis(part, order, axis=1)


def build_searcher(family: str, db: np.ndarray, res,
                    mini: bool = False):
    """One index + serving handle per family at the JAX package's sweep
    build params."""
    from raft_tpu_torch import serving
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

    n_lists = 32 if mini else 128
    if family == "brute_force":
        index = brute_force.build(db, metric="sqeuclidean", res=res)
        searcher = serving.brute_force_searcher(index, res=res)
        shape = {}
    elif family == "ivf_flat":
        index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=n_lists),
                               res=res)
        searcher = serving.ivf_flat_searcher(index, res=res)
        shape = {"n_lists": n_lists}
    elif family == "ivf_pq":
        index = ivf_pq.build(
            db, ivf_pq.IndexParams(n_lists=n_lists, pq_dim=32), res=res)
        searcher = serving.ivf_pq_searcher(index, res=res)
        shape = {"n_lists": n_lists, "pq_dim": 32}
    elif family == "cagra":
        index = cagra.build(db, cagra.IndexParams(
            graph_degree=32, intermediate_graph_degree=64), res=res)
        searcher = serving.cagra_searcher(index, res=res)
        shape = {"graph_degree": 32}
    elif family == "tiered_ivf_pq":
        # the ivf_pq index with its lists demoted to pinned host memory;
        # the arena holds every list, so the sweep prices the steady-state
        # hit path (arena churn under pressure is phase 6e's)
        from raft_tpu_torch.neighbors import tiered
        index = ivf_pq.build(
            db, ivf_pq.IndexParams(n_lists=n_lists, pq_dim=32), res=res)
        t = tiered.TieredIvfPq.from_index(
            index, res=res, arena_slots=n_lists, namespace="sweep")
        searcher = serving.tiered_ivf_pq_searcher(t, res=res)
        shape = {"n_lists": n_lists, "pq_dim": 32,
                 "arena_slots": t.arena.slots}
    else:
        raise ValueError(f"unknown family {family!r}")
    shape.update({"rows": int(db.shape[0]), "dim": int(db.shape[1])})
    return searcher, shape


def _device_peaks(device=None):
    """ChipPeaks of the device the sweep runs on (None on the CPU or an
    unknown card)."""
    from raft_tpu_torch.obs import costs as obs_costs

    return obs_costs.peaks_for_device(device)


def _roofline_min_ms(family: str, params: Dict[str, object], shape: dict,
                     bucket: int, peaks) -> Optional[float]:
    """The roofline floor of one (family, params, bucket) point: the JAX
    package's rule, max(scan bytes / memory peak, scan operations /
    arithmetic peak) a batch, the least device time of the dominant scan
    at this point (``obs.costs.roofline_bound``). None on the CPU (no
    peaks) and for cagra (the greedy walk is latency-bound)."""
    from raft_tpu_torch.obs import costs as obs_costs

    if peaks is None:
        return None
    rows, dim = int(shape["rows"]), int(shape["dim"])
    if family == "brute_force":
        scanned_rows, row_bytes = rows, dim * 4
        flops = 2.0 * bucket * rows * dim
    elif family == "ivf_flat":
        frac = int(params.get("n_probes", 20)) / max(
            int(shape.get("n_lists", 1)), 1)
        scanned_rows, row_bytes = min(frac, 1.0) * rows, dim * 4
        flops = 2.0 * bucket * scanned_rows * dim
    elif family in ("ivf_pq", "tiered_ivf_pq"):
        # the tiered hit path scans the same decoded slabs, so the ivf_pq
        # floor is its floor too
        frac = int(params.get("n_probes", 20)) / max(
            int(shape.get("n_lists", 1)), 1)
        scanned_rows = min(frac, 1.0) * rows
        row_bytes = int(shape.get("pq_dim", 32))  # one code byte per dim
        flops = 2.0 * bucket * scanned_rows * row_bytes
    else:
        return None
    return obs_costs.roofline_bound(scanned_rows * row_bytes, flops,
                                    peaks)["bound_ms"]


def _time_batch_s(searcher, batch: np.ndarray, k: int,
                  params: Dict[str, object], reps: int) -> float:
    """Best-of-``reps`` fenced wall time of one batch (best-of drops the
    host's hiccups). The batch is staged on the device once, outside the
    timing."""
    from raft_tpu_torch.bench import timing

    q = searcher.to_device(batch)
    timing.fence(searcher.search_with(q, k, params))  # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        timing.fence(searcher.search_with(q, k, params))
        best = min(best, time.perf_counter() - t0)
    return best


def sweep_family(family: str, db: np.ndarray, queries: np.ndarray,
                 ks: Sequence[int], buckets: Sequence[int],
                 grid: Optional[List[Dict[str, object]]] = None,
                 res=None, reps: int = 3, mini: bool = False,
                 log=None, built=None) -> dict:
    """Sweep one family: returns the artifact's per-family payload
    (``shape``, ``build_s``, ``frontier`` keyed ``str(k) -> str(bucket)
    -> [point dicts]``, and sweep accounting). ``built``: a ``(searcher,
    shape)`` pair from ``build_searcher`` to sweep instead of building one
    (a caller that serves the swept index afterwards)."""
    from raft_tpu_torch.core.resources import ensure_resources

    res = ensure_resources(res)
    grid = grid if grid is not None else default_grid(family, mini=mini)
    t0 = time.perf_counter()
    searcher, shape = built if built is not None else build_searcher(
        family, db, res, mini=mini)
    build_s = time.perf_counter() - t0
    peaks = _device_peaks(res.device)
    n_swept = 0
    frontier: Dict[str, Dict[str, list]] = {}
    eval_bucket = max(buckets)
    for k in ks:
        gt = exact_oracle(db, queries, int(k))
        # recall is per-params, NOT per-bucket: the search cores are
        # row-wise and padding rows are zeros, so a row's result is
        # bucket-invariant (the serving bit-identity guarantee) — grade
        # once at the largest bucket and reuse across the bucket sweep
        recalls: Dict[str, float] = {}
        for params in grid:
            hits, total = 0, 0
            for j in range(0, len(queries), eval_bucket):
                chunk = queries[j:j + eval_bucket]
                batch = np.zeros((eval_bucket, db.shape[1]), np.float32)
                batch[:len(chunk)] = chunk
                _, idx = searcher.search_with(searcher.to_device(batch),
                                              int(k), params)
                idx = idx.cpu().numpy()[:len(chunk)]
                for row, ref in zip(idx, gt[j:j + eval_bucket]):
                    hits += np.isin(row, ref).sum()
                    total += len(ref)
            recalls[_params_key(params)] = hits / max(total, 1)
        per_bucket: Dict[str, list] = {}
        for bucket in buckets:
            points = []
            for params in grid:
                recall = recalls[_params_key(params)]
                batch = np.zeros((bucket, db.shape[1]), np.float32)
                batch[:] = queries[:bucket] if len(queries) >= bucket \
                    else np.resize(queries, (bucket, db.shape[1]))
                batch_s = _time_batch_s(searcher, batch, int(k), params,
                                        reps)
                points.append(adaptive.OperatingPoint(
                    params=dict(params), bucket=int(bucket),
                    qps=bucket / batch_s, recall=float(recall),
                    predicted_ms=batch_s * 1e3,
                    roofline_min_ms=_roofline_min_ms(
                        family, params, shape, bucket, peaks)))
                n_swept += 1
                if log is not None:
                    log(f"  {family} k={k} b={bucket} {params}: "
                        f"recall={recall:.4f} "
                        f"batch={batch_s * 1e3:.2f} ms")
            pruned = adaptive.pareto_prune(points)
            per_bucket[str(int(bucket))] = [p.to_dict() for p in pruned]
        frontier[str(int(k))] = per_bucket
    return {"shape": shape, "build_s": round(build_s, 2),
            "frontier": frontier, "n_swept": n_swept,
            "grid": [dict(g) for g in grid]}


def build_artifact(platform: str, families: Dict[str, dict],
                   config: Optional[dict] = None) -> dict:
    """Assemble the committed ``PARETO_<platform>.json`` document:
    schema tag, per-family frontiers, and the flat ``"metrics"`` mirror
    (hypervolume and best QPS per recall band of each curve)."""
    doc = {
        "schema": adaptive.PARETO_SCHEMA,
        "platform": platform,
        "when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "config": dict(config or {}),
        "families": families,
    }
    doc["metrics"] = adaptive.frontier_metrics(doc)
    # round-trip through the loader so a malformed artifact can never be
    # written in the first place
    adaptive.Frontier(doc)
    return doc


def check_artifact(path: str) -> int:
    """Round-trip gate: the validating load, then every curve a monotone
    non-dominated frontier of sane points. 0 when it holds."""
    try:
        frontier = adaptive.load_frontier(path)
    except (OSError, ValueError) as e:
        print(f"sweep --check: {path}: {e}", file=sys.stderr)
        return 1
    n_curves = n_points = 0
    for family in frontier.families:
        for k in frontier.ks(family):
            doc = frontier.doc["families"][family]["frontier"][str(k)]
            for b_key, raw in doc.items():
                pts = [adaptive.OperatingPoint.from_dict(p) for p in raw]
                pruned = adaptive.pareto_prune(pts)
                if [p.to_dict() for p in pruned] != \
                        [p.to_dict() for p in pts]:
                    print(f"sweep --check: {path}: {family} k={k} b={b_key}"
                          f": not a monotone non-dominated curve",
                          file=sys.stderr)
                    return 1
                for p in pts:
                    if p.predicted_ms <= 0 or not 0 <= p.recall <= 1:
                        print(f"sweep --check: {path}: {family} k={k} "
                              f"b={b_key}: bad point {p.to_dict()}",
                              file=sys.stderr)
                        return 1
                n_curves += 1
                n_points += len(pts)
    print(f"sweep --check: {path}: OK, {len(frontier.families)} families, "
          f"{n_curves} curves, {n_points} points")
    return 0


def main(argv=None) -> int:
    """``python -m raft_tpu_torch.planner.sweep``: sweep the families on
    synthetic data (``bench.datagen.low_rank_clusters``) and write
    ``raft_tpu_torch/artifacts/PARETO_cuda.json`` (``PARETO_cpu.json`` with
    ``--device cpu``), keyed by the card's name; ``--check PATH`` only
    validates an artifact."""
    import argparse
    import os

    import torch

    from raft_tpu_torch.bench import datagen
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.ops import select_k

    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.planner.sweep")
    ap.add_argument("--families", nargs="+", default=list(FAMILIES),
                    choices=list(FAMILIES))
    ap.add_argument("--rows", type=int, default=10000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--nq", type=int, default=256,
                    help="eval queries (recall is over all of them)")
    ap.add_argument("--ks", type=int, nargs="+", default=[10])
    ap.add_argument("--buckets", type=int, nargs="+", default=None,
                    help="query buckets (default 8 64; --mini: 8)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--mini", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' rehearses")
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", metavar="PATH", default=None)
    args = ap.parse_args(argv)
    if args.check is not None:
        return check_artifact(args.check)
    device = torch.device(args.device or "cuda")
    res = Resources(device=device, seed=args.seed)
    suffix = "cuda" if device.type == "cuda" else "cpu"
    out_path = args.out or os.path.join(select_k.ARTIFACT_DIR,
                                        f"PARETO_{suffix}.json")
    nq = min(args.nq, 64) if args.mini else args.nq
    buckets = args.buckets or ([8] if args.mini else [8, 64])
    rng = np.random.default_rng(args.seed)
    db = datagen.low_rank_clusters(rng, args.rows + nq, args.dim)
    db, queries = db[:args.rows], db[args.rows:]
    t0 = time.perf_counter()
    families = {}
    for family in args.families:
        print(f"sweep: {family} (rows={args.rows} dim={args.dim} "
              f"ks={args.ks} buckets={buckets})", flush=True)
        families[family] = sweep_family(
            family, db, queries, args.ks, buckets, res=res, reps=args.reps,
            mini=args.mini, log=lambda m: print(m, flush=True))
    from raft_tpu_torch.bench.probe import card_line

    doc = build_artifact(
        select_k.platform_key(device), families,
        config={"rows": args.rows, "dim": args.dim, "nq": nq,
                "ks": list(args.ks), "buckets": list(buckets),
                "reps": args.reps, "seed": args.seed,
                "mini": bool(args.mini), "card": card_line()})
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"sweep: wrote {out_path} in {time.perf_counter() - t0:.1f} s")
    return check_artifact(out_path)


if __name__ == "__main__":
    sys.exit(main())
