"""Result export + QPS-vs-recall pareto plots.

Counterpart of ``raft_tpu.bench.export`` (host-only: a copy). Reference:
``raft-ann-bench.data_export`` (CSV + throughput/latency pareto frontiers)
and ``raft-ann-bench.plot`` (QPS-vs-recall pareto curves)."""

from __future__ import annotations

import csv
import json
from typing import Dict, List


def load_results(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def pareto_frontier(rows: List[Dict], x_key: str = "recall",
                    y_key: str = "qps") -> List[Dict]:
    """Points not dominated by any other (higher recall AND higher qps).
    Ties on x are broken by y so a dominated equal-recall point never
    survives."""
    out = []
    best_y = -float("inf")
    for r in sorted(rows, key=lambda r: (-r[x_key], -r[y_key])):
        if r[y_key] > best_y:
            out.append(r)
            best_y = r[y_key]
    return list(reversed(out))


def export_csv(rows: List[Dict], path: str,
               pareto: bool = False) -> None:
    """Flat CSV of result rows (data_export analog); optionally only the
    per-algo pareto frontier."""
    if pareto:
        by_algo: Dict[str, List[Dict]] = {}
        for r in rows:
            by_algo.setdefault(r.get("name", r.get("algo", "?")), []).append(r)
        rows = [p for rs in by_algo.values() for p in pareto_frontier(rs)]
    if not rows:
        return
    # leading columns use the reference data_export names (index_name /
    # recall / throughput / latency, data_export/__main__.py:159-162) so
    # its downstream plotting tooling reads our CSVs unchanged; the
    # richer native fields follow
    keys = ["index_name", "recall", "throughput", "latency",
            "dataset", "name", "algo", "k", "batch_size", "qps",
            "latency_ms", "build_time", "search_param"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
        w.writeheader()
        for r in rows:
            r = dict(r)
            r["index_name"] = r.get("name", r.get("algo", "?"))
            r["throughput"] = r.get("qps")
            r["latency"] = (r.get("latency_ms", 0.0) or 0.0) / 1e3
            r["search_param"] = json.dumps(r.get("search_param", {}))
            w.writerow(r)


def plot(rows: List[Dict], path: str, title: str = "QPS vs recall") -> None:
    """QPS-vs-recall pareto plot per algo (plot CLI analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    by_algo: Dict[str, List[Dict]] = {}
    for r in rows:
        by_algo.setdefault(r.get("name", r.get("algo", "?")), []).append(r)
    fig, ax = plt.subplots(figsize=(7, 5))
    for name, rs in sorted(by_algo.items()):
        front = pareto_frontier(rs)
        ax.plot([r["recall"] for r in front], [r["qps"] for r in front],
                marker="o", label=name)
    ax.set_xlabel("recall@k")
    ax.set_ylabel("QPS")
    ax.set_yscale("log")
    ax.set_title(title)
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
