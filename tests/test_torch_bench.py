"""The port's bench layer against raft_tpu's.

- ``bench.timing``: the fences count the tensor leaves and wait for them,
  the timers return positive per-call seconds, ``chain_perturb`` keeps the
  values (exact) and ``prepare`` puts numpy inputs on the device;
- ``bench.export``: ``pareto_frontier`` and the CSV equal raft_tpu's on
  the same rows (the same rows, the same bytes);
- ``bench.runner``: a tiny raft-ann-bench config runs end to end on the CPU
  through ``python -m raft_tpu_torch.bench run``, with brute force's recall
  1.0 and IVF-Flat's rising with its probes; ``generate-groundtruth`` and
  ``split-groundtruth`` write what raft_tpu's write;
- ``bench/conf``: the copied run configs are raft_tpu's byte for byte;
- ``obs.costs``: ``apply_roofline`` equals raft_tpu's on the same numbers
  (exact), the H100 peaks are the data sheet's, and the formulas count what
  their docstrings say.
"""

import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.bench import export as jexport
from raft_tpu.obs import costs as jcosts
from raft_tpu_torch import native
from raft_tpu_torch.bench import datagen, export, runner, timing
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.obs import costs

REPO = Path(__file__).resolve().parents[1]


def test_fences_and_timers():
    a = torch.arange(6.0)
    nested = {"x": (a, [a * 2, np.zeros(3)]), "y": "label"}
    assert timing.fence(nested) == 2
    assert timing.fence(np.zeros(3)) == 0
    assert timing.fence_overhead() >= 0.0

    class _Idx:
        def __init__(self):
            self.data = torch.ones(3)
            self.n = 3

    timing.fence_index(_Idx())
    calls = []

    def dispatch():
        calls.append(1)
        return a * 3

    dt = timing.time_dispatches(dispatch, iters=4, warmup=2)
    assert dt > 0 and len(calls) == 6
    assert timing.last_info["samples_s"] == [pytest.approx(dt)]
    x0 = torch.ones(4)
    steps = []

    def step(prev):
        steps.append(1)
        return timing.chain_perturb(x0, prev) * 1.0

    lat = timing.time_latency_chained(step, x0, iters=3, rounds=2)
    assert lat > 0 and len(steps) == 1 + 3 * 2
    assert len(timing.last_info["samples_s"]) == 2
    inf_out = (torch.tensor([float("inf"), 1.0]),)
    assert torch.equal(timing.chain_perturb(x0, inf_out), x0)
    assert torch.equal(timing.chain_perturb(x0, None), x0)
    got = timing.prepare({"q": np.ones((2, 3), np.float32), "k": 5},
                         device="cpu")
    assert isinstance(got["q"], torch.Tensor) and got["k"] == 5


def _rows(seed, n=40):
    rng = np.random.default_rng(seed)
    return [{"name": f"algo{j % 3}", "algo": "raft_ivf_flat",
             "recall": float(np.round(rng.uniform(0.5, 1), 3)),
             "qps": float(np.round(rng.uniform(100, 9000), 1)),
             "latency_ms": float(rng.uniform(0.1, 9)), "k": 10,
             "batch_size": 64, "dataset": "d", "build_time": 1.5,
             "search_param": {"nprobe": int(rng.integers(1, 64))}}
            for j in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_export_matches_jax(seed, tmp_path):
    rows = _rows(seed)
    assert export.pareto_frontier(rows) == jexport.pareto_frontier(rows)
    for pareto in (False, True):
        export.export_csv(rows, str(tmp_path / "t.csv"), pareto=pareto)
        jexport.export_csv(rows, str(tmp_path / "j.csv"), pareto=pareto)
        assert (tmp_path / "t.csv").read_bytes() == \
            (tmp_path / "j.csv").read_bytes()
    (tmp_path / "r.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\n\n")
    assert export.load_results(str(tmp_path / "r.jsonl")) == rows


def test_conf_jsons_are_copied_byte_for_byte():
    src = REPO / "raft_tpu" / "bench" / "conf"
    dst = REPO / "raft_tpu_torch" / "bench" / "conf"
    names = sorted(p.name for p in src.glob("*.json"))
    assert names == sorted(p.name for p in dst.glob("*.json")) and names
    for name in names:
        assert filecmp.cmp(src / name, dst / name, shallow=False), name


def test_runner_end_to_end_on_the_cpu(tmp_path):
    rng = np.random.default_rng(0)
    db = datagen.low_rank_clusters(rng, 2060, 16)
    native.write_bin(str(tmp_path / "base.fbin"), db[:2000])
    native.write_bin(str(tmp_path / "q.fbin"), db[2000:])
    conf = {"dataset": {"name": "tiny", "base_file": str(tmp_path / "base.fbin"),
                        "query_file": str(tmp_path / "q.fbin"),
                        "distance": "euclidean"},
            "index": [
                {"name": "bf", "algo": "raft_brute_force",
                 "search_params": [{}]},
                {"name": "flat", "algo": "raft_ivf_flat",
                 "build_param": {"nlist": 16, "niter": 4},
                 "search_params": [{"nprobe": 1}, {"nprobe": 16}]},
                {"name": "sk", "algo": "sklearn_brute_force",
                 "search_params": [{}]}]}
    (tmp_path / "conf.json").write_text(json.dumps(conf))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.bench", "run", "--conf",
         str(tmp_path / "conf.json"), "--device", "cpu", "--out",
         str(tmp_path / "r.jsonl"), "--csv", str(tmp_path / "r.csv"),
         "--batch-size", "30", "--iters", "1", "--k", "5"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = export.load_results(str(tmp_path / "r.jsonl"))
    by = {(r["name"], json.dumps(r["search_param"])): r for r in rows}
    assert by[("bf", "{}")]["recall"] == 1.0
    assert by[("sk", "{}")]["recall"] == 1.0
    assert by[("flat", '{"nprobe": 16}')]["recall"] == 1.0
    assert by[("flat", '{"nprobe": 1}')]["recall"] < 1.0
    assert all(r["qps"] > 0 and r["latency_ms"] > 0 for r in rows)
    assert (tmp_path / "r.csv").read_text().startswith(
        "index_name,recall,throughput,latency")
    # groundtruth: exact ids, and the big-ann split both packages write
    gt = runner.generate_groundtruth(db[:2000], db[2000:], 5,
                                     res=Resources(device="cpu"))
    d2 = ((db[2000:, None, :] - db[None, :2000, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.sort(gt, 1),
                                  np.sort(np.argsort(d2, 1)[:, :5], 1))
    n, k = 4, 3
    with open(tmp_path / "gt.bin", "wb") as f:
        np.array([n, k], np.int32).tofile(f)
        np.arange(n * k, dtype=np.uint32).tofile(f)
        np.linspace(0, 1, n * k, dtype=np.float32).tofile(f)
    runner.split_groundtruth(str(tmp_path / "gt.bin"), str(tmp_path / "n.ibin"),
                             str(tmp_path / "d.fbin"))
    from raft_tpu.bench import runner as jrunner
    jrunner.split_groundtruth(str(tmp_path / "gt.bin"),
                              str(tmp_path / "jn.ibin"),
                              str(tmp_path / "jd.fbin"))
    for a, b in (("n.ibin", "jn.ibin"), ("d.fbin", "jd.fbin")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def _entry(mod, name, flops, hbm):
    return mod.EntryCost(name=name, family="f", flops=flops, hbm_bytes=hbm,
                         temp_bytes=None, argument_bytes=None,
                         output_bytes=None, compile_s=0.0)


@pytest.mark.parametrize("flops,hbm", [(2.56e12, 5.2e8), (1.2e7, 9.6e8),
                                       (None, 4e6), (3e9, None),
                                       (6.7e10, 3.35e9)])
def test_apply_roofline_matches_jax(flops, hbm):
    for tpu in ("v5e", "v6e", "v4"):
        jp = jcosts.peaks_for_device_kind(f"TPU {tpu}")
        tp = costs.peaks_for_device_kind(f"TPU {tpu}")
        assert (tp.flops_per_s, tp.hbm_bytes_per_s) == (jp.flops_per_s,
                                                        jp.hbm_bytes_per_s)
        for peaks_t, peaks_j in ((tp, jp), (None, None)):
            t, j = _entry(costs, "e", flops, hbm), _entry(jcosts, "e", flops,
                                                          hbm)
            costs.apply_roofline(t, peaks_t)
            jcosts.apply_roofline(j, peaks_j)
            for key in ("arithmetic_intensity", "bound", "peak_utilization",
                        "min_time_us"):
                assert getattr(t, key) == getattr(j, key), key
    h = costs.peaks_for_device_kind("NVIDIA H100 80GB HBM3")
    assert h is costs.H100_PEAKS
    assert (h.flops_per_s, h.tf32_flops_per_s, h.hbm_bytes_per_s) == (
        67e12, 495e12, 3.35e12)
    assert costs.peaks_for_device_kind("NVIDIA H100 PCIe") is None
    assert costs.peaks_for_device_kind("cpu") is None
    assert jcosts.peaks_for_device_kind("NVIDIA H100 80GB HBM3") is None


def test_formulas_and_report():
    b, o = costs.l2_topk_work(10, 100, 8, 3)
    assert b == 4 * (80 + 800 + 110) + 240 and o == 2 * 10 * 100 * 8
    assert costs.roofline_bound(3.35e9, 0) == {"bound_ms": 1.0,
                                               "bound_by": "bytes"}
    assert costs.roofline_bound(0, 67e9)["bound_by"] == "operations"
    tb = costs.tf32_bound(1.0, 495e9 / 3)
    assert tb["bound_3xtf32_ms"] == pytest.approx(1.0)
    assert costs.ivf_scan_work(2, 3, 4, 5, 4, 1)[1] == 2 * 4 * 2 * 3 * 5
    assert costs.ring_shift_work(4, 100) == (800, 0)
    rep = costs.build_report(device_kind="NVIDIA H100 80GB HBM3")
    assert rep.peaks is costs.H100_PEAKS
    names = [e.name for e in rep.entries]
    for kernel in ("fused_l2_topk", "fused_ivf_topk", "fused_pq_topk",
                   "select_k", "fused_cagra_topk", "fused_l2_argmin",
                   "ivf_scan", "ring_shift"):
        assert any(n.startswith(kernel) for n in names), kernel
    for e in rep.entries:
        if e.flops:
            assert e.min_time_us is not None
            assert e.bound in ("memory", "compute")
        else:  # a copy: the JAX package's rule needs operations to place it
            assert e.name.startswith("ring_shift") and e.bound is None
    # brute force at 10k x 1M x 128: compute-bound, 38.2 ms (PERF.md's bound)
    bf = rep.entries[0]
    assert bf.bound == "compute"
    assert bf.min_time_us / 1e3 == pytest.approx(38.2089552238806)
    doc = json.loads(rep.to_json())
    assert doc["schema"] == "raft_tpu.perf_report/v1" and doc["entries"]
    assert "fused_l2_topk@1m" in rep.format()
    from raft_tpu_torch.obs import metrics
    reg = metrics.Registry()
    costs.export_gauges(rep, reg)
    assert reg.get("raft_tpu_cost_min_time_us") is not None
    cpu = costs.build_report(device="cpu")
    assert cpu.peaks is None and cpu.entries[0].bound is None
