"""The reading of the program's own spans and counters (``vsbench/spans.py``
and the ``search.staging_waits``, ``search.overflow_rows`` and
``select_k.calls`` readers): launches
attributed to spans through the correlation id, the harness's numbers
unchanged by program spans in the trace, each reader on a hand-made view,
and tiny cells on the CPU."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from raft_tpu_torch.obs.metrics import Registry
from vsbench import spans
from vsbench.readers import View
from vsbench.run import ROOT, load_module
from vsbench.trace import Trace

HARNESS = ("batch.call", "batch.readback")


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events(program: bool):
    """One batch: the call's search with its spans, four kernels it
    launched, the read-back's copy, and a kernel with no launch event."""
    evs = [_x("user_annotation", "vsbench.window", 0, 1000),
           _x("user_annotation", "batch.call", 10, 400),
           _x("user_annotation", "batch.readback", 410, 300),
           _x("cuda_runtime", "cudaLaunchKernel", 70, 2, 1),
           _x("cuda_runtime", "cudaLaunchKernel", 150, 2, 2),
           _x("cuda_runtime", "cudaLaunchKernel", 320, 2, 3),
           _x("cuda_runtime", "cudaLaunchKernel", 395, 2, 4),
           _x("cuda_runtime", "cudaMemcpyAsync", 420, 2, 5),
           _x("kernel", "void coarse_kernel<float>(Args)", 80, 50, 1),
           _x("kernel", "void grouped_topk_kernel<float>(Args)", 200, 300, 2),
           _x("kernel", "void gatherTopK<float>(Args)", 500, 100, 3),
           _x("kernel", "void sqrt_kernel(Args)", 600, 10, 4),
           _x("gpu_memcpy", "Memcpy DtoH", 610, 20, 5),
           _x("kernel", "void orphan_kernel(Args)", 700, 5, 99)]
    if program:
        evs += [_x("user_annotation", "ivf_flat.search", 20, 380),
                _x("user_annotation", "ivf_flat.search.plan", 20, 40),
                _x("user_annotation", "ivf_flat.search.coarse", 60, 40),
                _x("user_annotation", "ivf_flat.search.scan", 100, 200),
                _x("user_annotation", "ivf_flat.search.overflow", 300, 90)]
    return evs


def _close(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=1e-12), k


def test_launches_are_attributed_to_spans_through_the_correlation_id():
    tr = spans.SpanTrace(_events(True), HARNESS)
    _close(tr.device_by_span(), {
        "ivf_flat.search.coarse": 50e-6, "ivf_flat.search.scan": 300e-6,
        "ivf_flat.search.overflow": 100e-6, "ivf_flat.search": 10e-6,
        "batch.readback": 20e-6, spans.UNATTRIBUTED: 5e-6})
    _close(tr.idle_by_program_span(), {
        "ivf_flat.search.plan": 80e-6, "ivf_flat.search.scan": 70e-6,
        "batch.readback": 70e-6, "between": 295e-6})
    names = {n for n, _, _ in tr.program}
    assert tr.launched_in(names, "batch.call") == 1.0
    assert tr.launched_in({"ivf_flat.search.scan"}, "batch.call") == \
        pytest.approx(300 / 460)
    assert tr.innermost(310e-6) == "ivf_flat.search.overflow"
    assert tr.innermost(398e-6) == "ivf_flat.search"
    assert tr.innermost(405e-6) is None


@pytest.mark.parametrize("cls", [Trace, spans.SpanTrace])
def test_program_spans_change_no_number_the_harness_reads(cls):
    base = Trace(_events(False), HARNESS)
    tr = cls(_events(True), HARNESS)
    assert tr.busy_s == base.busy_s and tr.window_s == base.window_s
    assert tr.top_ops() == base.top_ops()
    assert tr.idle_by_span() == base.idle_by_span()
    assert tr.kernel_s() == base.kernel_s()
    assert tr.spans == base.spans


def _registry(dispatch=None, syncs=None, overflow=None, selects=None):
    reg = Registry()
    if dispatch is not None:
        reg.counter("raft_tpu_dispatch_total", "", (
            "family", "engine", "reason")).labels(*dispatch[0]).inc(
                dispatch[1])
    if syncs is not None:
        fam = reg.counter("raft_tpu_host_sync_total", "", ("site",))
        for site, n in syncs.items():
            fam.labels(site).inc(n)
    if overflow is not None:
        reg.counter("raft_tpu_overflow_rows_scanned_total", "",
                    ("family",)).labels(overflow[0]).inc(overflow[1])
    if selects is not None:
        fam = reg.counter("raft_tpu_select_k_total", "", ("algo",))
        for algo, n in selects.items():
            fam.labels(algo).inc(n)
    return reg


def _view(family="ivf_flat", batch=100):
    run = SimpleNamespace(cfg={"family": family},
                          batches=[torch.zeros((batch, 4))], n_steps=3)
    return View(None, run, {})


@pytest.mark.parametrize("syncs,want", [
    ({}, 0.0), ({"ivf_pq.queries": 40}, 0.0),
    ({"ivf_flat.queries": 30, "ivf_flat.filter": 10, "ivf_pq.queries": 40},
     2.0)])
def test_search_staging_waits_reads_the_family_s_waits_a_call(
        monkeypatch, syncs, want):
    reg = _registry((("ivf_flat", "pallas", "forced"), 20), syncs,
                    ("ivf_flat", 0))
    monkeypatch.setattr(spans, "_registry", lambda: reg)
    reader = load_module(ROOT, "metrics", "search.staging_waits")
    assert reader.read(_view()) == want


def test_select_k_calls_reads_selections_a_call(monkeypatch):
    reg = _registry((("ivf_flat", "pallas", "forced"), 20),
                    selects={"PALLAS": 20, "DIRECT": 20, "TWO_PHASE": 10})
    monkeypatch.setattr(spans, "_registry", lambda: reg)
    assert load_module(ROOT, "metrics", "select_k.calls").read(
        _view()) == 2.5


def test_search_overflow_rows_reads_rows_a_query(monkeypatch):
    reg = _registry((("ivf_pq", "pallas_lut", "forced"), 20), {},
                    ("ivf_pq", 20 * 100 * 2120))
    monkeypatch.setattr(spans, "_registry", lambda: reg)
    reader = load_module(ROOT, "metrics", "search.overflow_rows")
    assert reader.read(_view("ivf_pq")) == 2120.0


@pytest.mark.parametrize("metric", ["search.staging_waits",
                                    "search.overflow_rows", "select_k.calls"])
def test_readers_give_nothing_without_the_counters(monkeypatch, metric):
    """A program without the counters (the parent of this change) reads
    None, and the line leaves the metric out."""
    monkeypatch.setattr(spans, "_registry", lambda: _registry(
        (("ivf_flat", "pallas", "forced"), 20)))
    assert load_module(ROOT, "metrics", metric).read(_view()) is None


@pytest.fixture(scope="module")
def spill_root(tiny_root, tmp_path_factory):
    """The tiny benchmark and one more cell, ``tiny-spill.batch``: the tiny
    IVF-Flat with a pad of the mean list size, so that rows spill into the
    overflow block."""
    root = tmp_path_factory.mktemp("vsbench_spill")
    shutil.copytree(tiny_root / "vsbench", root / "vsbench")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    folder = root / "vsbench"
    cfg = json.loads((folder / "configs" / "tiny-ivf_flat.json").read_text())
    cfg["name"] = "tiny-spill"
    cfg["index"]["list_pad_expansion"] = 1.0
    (folder / "configs" / "tiny-spill.json").write_text(json.dumps(cfg))
    spec = json.loads(
        (folder / "workloads" / "tiny-ivf_flat.batch.json").read_text())
    spec["config"] = "tiny-spill"
    (folder / "workloads" / "tiny-spill.batch.json").write_text(
        json.dumps(spec))
    bench["workloads"].append({"name": "tiny-spill.batch", **{
        k: spec[k] for k in ("config", "traffic", "chips", "why")}})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-ivf_flat.batch" in m.get("workloads", []):
            m["workloads"].append("tiny-spill.batch")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("cell", ["tiny-ivf_flat.batch",
                                  "tiny-ivf_flat.filtered",
                                  "tiny-ivf_pq.batch", "tiny-spill.batch"])
def test_a_traced_tiny_run_reports_the_counters(spill_root, cell):
    """A traced run in a process of its own (the counters are the
    process's) reports the three readings: no host array staged onto the
    device, the overflow rows a query, and a whole number of selections a
    call (every call takes one path, and nothing else of the run selects). The metrics of the device's and the host's time
    in each span wait on an edit of the harness (PERF.md), and there is no
    device here."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from vsbench.run import execute, load_cell
root = Path({str(spill_root)!r})
bench = json.loads((root / "BENCHMARK.json").read_text())
r = execute(load_cell(root, {cell!r}), bench, 5, 0.2, True, "cpu",
            time.perf_counter())
print(json.dumps({{"correct": r["correct"], "metrics": r["metrics"]}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd="/")
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"]
    waits = r["metrics"]["search.staging_waits"]
    rows = r["metrics"]["search.overflow_rows"]
    selects = r["metrics"]["select_k.calls"]
    assert waits == {"value": 0.0, "unit": "count"}
    assert selects["unit"] == "count" and selects["value"] >= 1.0
    assert selects["value"] == int(selects["value"])
    assert rows["unit"] == "rows" and rows["value"] >= 0.0
    if cell == "tiny-spill.batch":
        assert rows["value"] > 0 and rows["value"] % 8 == 0
    for name in ("search.plan_ms", "coarse.device_ms", "overflow.device_ms"):
        assert name not in r["metrics"]


def test_span_measure_on_a_tiny_cell(spill_root):
    """``vsbench.spans.measure`` on the CPU: every span of the search timed
    once a call in the window, the host split within the outside clock, no
    staging wait, and the overflow rows a query the index's."""
    out = spans.measure("tiny-spill.batch", 5, 0.2, "cpu", root=spill_root)
    calls = out["calls"]
    for name in ("ivf_flat.search", "ivf_flat.search.plan",
                 "ivf_flat.search.coarse", "ivf_flat.search.scan",
                 "ivf_flat.search.overflow"):
        assert out["span_counts"][name] == calls, name
    assert out["staging_waits_per_call"] == 0.0
    assert out["select_k_per_call"] >= 1.0
    assert out["index_overflow_rows"] > 0
    assert out["overflow_rows_per_query"] == out["index_overflow_rows"]
    assert 0.5 * out["return_ms"] < out["host_ms"]["ivf_flat.search"] \
        <= out["return_ms"]
    assert out["host_ms"]["ivf_flat.search.plan"] > 0
