"""A copy of the benchmark with tiny cells, which runs on the CPU.

The copy holds the repository's ``vsbench/`` and ``BENCHMARK.json`` and, as
new files and new entries only, a tiny IVF-Flat and IVF-PQ configuration
(4,000 × 32 rows) with a cell of each traffic mix."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_DATA = {"n_centers": 12, "intrinsic": 8, "spread": 1.5, "dataset_seed": 0}
TINY_CONFIGS = {
    "tiny-ivf_flat": {
        "family": "ivf_flat", "n_rows": 4000, "dim": 32,
        "data": TINY_DATA,
        "index": {"n_lists": 16, "kmeans_n_iters": 5},
        "search": {"n_probes": 4, "scan_mode": "auto"}},
    "tiny-ivf_pq": {
        "family": "ivf_pq", "n_rows": 4000, "dim": 32,
        "data": TINY_DATA,
        "index": {"n_lists": 16, "pq_dim": 16, "pq_bits": 8,
                  "kmeans_n_iters": 5},
        "search": {"n_probes": 4, "lut_dtype": "float32",
                   "internal_distance_dtype": "float32",
                   "scan_mode": "auto"},
        "memory_mode": "lut", "control_search": {"lut_dtype": "bfloat16"}},
}
TINY_MIXES = {
    "tiny-batch": {"kind": "batch", "batch": 100, "pool": 300, "k": 10,
                   "filter_removed": 0.0, "judged_rows": 32,
                   "state_rows": 500},
    "tiny-filtered": {"kind": "batch", "batch": 100, "pool": 300, "k": 10,
                      "filter_removed": 0.1, "judged_rows": 32,
                      "state_rows": 500},
}
#: the cells' limits; at 4,000 rows the build's quality is judged on 500
#: rows and a codebook trained on 2,000, which read up to 0.07 where the
#: repository's cells read under 0.01, so its limits here are wider
LIMITS = {"dist_gap": 1e-5, "rank_gap": 1e-5, "assign_gap": 5e-6,
          "code_gap": 1e-5, "recall": 0.5, "kmeans_excess": 0.2,
          "pq_excess": 0.2}
#: cell → (configuration, traffic mix); each reports the metrics of the
#: repository's cell of its name with "sift1m-" for "tiny-"
TINY_CELLS = {
    "tiny-ivf_flat.batch": ("tiny-ivf_flat", "tiny-batch"),
    "tiny-ivf_flat.filtered": ("tiny-ivf_flat", "tiny-filtered"),
    "tiny-ivf_pq.batch": ("tiny-ivf_pq", "tiny-batch"),
}


def make_copy(dest: Path) -> Path:
    """The benchmark with the tiny cells added; returns its root."""
    shutil.copytree(REPO / "vsbench", dest / "vsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        cfg = dict(cfg, name=name, source="tests", reduced=[], assumed=[])
        (dest / "vsbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
    for name, mix in TINY_MIXES.items():
        (dest / "vsbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    for cell, (config, mix) in TINY_CELLS.items():
        spec = {"config": config, "traffic": mix, "chips": 1, "why": "test",
                "limits": LIMITS}
        (dest / "vsbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps(spec))
        bench["workloads"].append({"name": cell, **spec})
        twin = "sift1m-" + cell.removeprefix("tiny-")
        for section in ("end_to_end", "per_layer"):
            for m in bench[section]:
                if twin in m.get("workloads", []):
                    m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("vsbench_copy"))
