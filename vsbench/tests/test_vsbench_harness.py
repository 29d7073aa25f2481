"""The harness: every name resolves, the file meets the benchmark contract,
a cell is added by new files alone, no card means no result, and nothing
a run or the reference loads is JAX, the JAX package, or (for the
reference) the program."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from vsbench.run import ROOT, cell_metrics, execute, load_cell, load_module

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    found = load_cell(ROOT, cell)
    for key in ("config", "traffic", "chips", "why"):
        assert found.spec[key] == entry[key]
    assert found.config["name"] == entry["config"]
    load_module(ROOT, "families", found.config["family"])
    kind = load_module(ROOT, "traffic", found.traffic["kind"])
    assert hasattr(kind, "Run")
    reported = {m["name"] for m in cell_metrics(BENCH, "end_to_end", cell)}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell_metrics(BENCH, "per_layer", cell)
    for name in found.spec["limits"]:
        assert name in ("dist_gap", "rank_gap", "assign_gap", "code_gap",
                        "recall", "kmeans_excess", "pq_excess")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_is_found_by_name(metric):
    assert callable(load_module(ROOT, "metrics", metric).read)


def test_benchmark_json_meets_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        names.add(c["name"])
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.add(w["name"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])
    assert {w["config"] for w in BENCH["workloads"]} == names
    e2e = {}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]]
        assert f"| {m['layer']} |" in perf  # PERF.md's list of layers
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    all_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(all_names) == len(set(all_names))


def test_a_cell_is_added_by_new_files_alone(tiny_root):
    """The copy adds configurations, traffic mixes and cells as new files;
    here also a per-layer metric, and a run reports it."""
    (tiny_root / "vsbench" / "metrics" / "tiny.batches.py").write_text(
        "def read(view):\n    return float(view.run.n_steps)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "tiny.batches", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "entry points", "moves": "qps",
        "workloads": ["tiny-ivf_flat.batch"]})
    for old in (ROOT / "vsbench").rglob("*"):
        rel = old.relative_to(ROOT)
        if old.is_file() and "tests" not in rel.parts \
                and "__pycache__" not in rel.parts:
            assert (tiny_root / rel).read_bytes() == old.read_bytes(), rel
    result = execute(load_cell(tiny_root, "tiny-ivf_flat.batch"), bench, 7,
                     0.2, True, "cpu", time.perf_counter())
    assert result["correct"]
    assert result["metrics"]["tiny.batches"]["value"] >= 1
    assert "search.return_ms" in result["metrics"]


def test_a_machine_without_a_card_gets_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "vsbench", "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


_RUN_AND_LIST = """
import json, sys, time
sys.path.insert(0, {repo!r})
from pathlib import Path
from vsbench.run import execute, load_cell
root = Path({root!r})
bench = json.loads((root / "BENCHMARK.json").read_text())
for cell in ("tiny-ivf_flat.filtered", "tiny-ivf_pq.batch"):
    r = execute(load_cell(root, cell), bench, 3, 0.2, False, "cpu",
                time.perf_counter())
    assert r["correct"], r
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE_AND_LIST = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
from vsbench.reference.build import BuildReference
from vsbench.reference.ivf import IvfReference, search_tf32
rows = torch.randn((200, 8))
state = {{"centers": rows[:4].clone(),
         "list_ids": torch.arange(200).reshape(4, 50),
         "list_sizes": torch.full((4,), 50),
         "overflow_ids": torch.zeros(0, dtype=torch.int64)}}
ref = IvfReference(rows, None, state, 2, 5)
ref.prepare(rows[:10])
d, i = search_tf32(ref, rows[:10], 5, 2)
ref.judge(torch.arange(10), d, i)
ref.state_gaps(torch.arange(20))
own = BuildReference(rows, {{"n_lists": 4, "pq_dim": 4, "pq_bits": 4,
                             "kmeans_n_iters": 3}}, 1)
own.kmeans_excess(rows[:4])
own.pq_excess(torch.arange(20), torch.ones(20))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd="/")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    tops = _tops(_RUN_AND_LIST.format(repo=str(ROOT), root=str(tiny_root)))
    assert "raft_tpu_torch" in tops  # the program under test
    assert not tops & {"jax", "jaxlib", "flax", "raft_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(_REFERENCE_AND_LIST.format(repo=str(ROOT)))
    assert not tops & {"jax", "jaxlib", "flax", "raft_tpu", "raft_tpu_torch"}


def test_the_sources_name_no_forbidden_top_level_module():
    """No harness file imports jax or raft_tpu (whole top-level names), and
    the reference imports nothing of the program."""
    pattern = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_]\w*)", re.M)
    for path in (ROOT / "vsbench").rglob("*.py"):
        tops = set(pattern.findall(path.read_text()))
        assert not tops & {"jax", "jaxlib", "flax", "raft_tpu"}, path
        if "reference" in path.parts:
            assert "raft_tpu_torch" not in tops, path
