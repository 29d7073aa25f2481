"""Phase 6k of ``chip_smoke.py``: the analysis layer on the card.

``phase(...)`` runs, on the indexes of the earlier phases:

- ``analysis_smem``: the accountant sweep (``analysis.kernels``) at each of
  the eight kernels' three planner-domain shapes (the main path's, served
  bucket 8, the largest the planner admits): the Python accountant equal
  to the C++ one each kernel's library exports (``rtt_<accountant>``, from
  ``csrc/smem_budget.h``), static shared memory (ptxas's report beside the
  library) plus the plan's dynamic bytes within
  ``shared_memory_per_block_optin``, registers × block threads within
  65,536, the spills recorded, and the plan's alignment (K003);
- ``analysis_workspace``: every entry of ``memory_audit.default_entries``
  at its canonical shape (1,024 queries, 64 probes, k = 100; brute force's
  10,000 queries over the 1M rows) on the earlier phases' indexes, the
  caching allocator's peak held to the workspace budget (B001) and to the
  planner's prediction (C001, ``obs.costs.measure_entry``), beside the
  host's fake-tensor figure (the memory audit, run in a child process
  meanwhile);
- ``analysis_merges``: the allgather, tree and ring merges of 10,000
  queries at k = 10 over the communicator of phase 5e, each rank's
  received bytes equal to ``core.resources.solve_merge_bytes``;
- ``analysis_cli``: ``python -m raft_tpu_torch.analysis --threads --flow
  --kernels --artifacts`` in a child process, which must exit 0.

A finding outside ``raft_tpu_torch/analysis/baseline.json`` fails the
phase. Every line carries the card's name and power limit. Alone: ``python3
-m raft_tpu_torch.bench.audit`` builds its own indexes of phase 3's rows.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

#: the canonical entries' shape (memory_audit.Sift1MCrashShape): queries,
#: probes and k of the IVF and CAGRA entries, brute force's queries
AUDIT_QUERIES, AUDIT_PROBES, AUDIT_K, BF_QUERIES = 1024, 64, 100, 10_000
#: the merges: queries and k of phase 5e's sharded search
MERGE_QUERIES, MERGE_K = 10_000, 10
CLI_ARGS = ("--threads", "--flow", "--kernels", "--artifacts")
CHILD_TIMEOUT_S = 300

#: the host's memory audit on fake tensors (``AuditResult.format`` lines):
#: the entries of ``default_entries`` whose indices a child is given, a
#: child a group at once; the LUT entry (index 0), which takes about as
#: long as the rest together, runs in this process after the card's parts
FAKE_AUDIT = ("import sys\n"
              "from raft_tpu_torch.analysis import memory_audit\n"
              "entries = memory_audit.default_entries()\n"
              "for i in sys.argv[1:]:\n"
              "    print(entries[int(i)].run().format(), flush=True)\n")
FAKE_GROUPS = ((1, 2, 5), (3, 4, 6, 7, 8, 9, 10, 11))
_AUDIT_LINE = re.compile(r"(?:OK|FAIL)\s+(\S+): peak ([\d.]+) MiB")


def _spawn(repo: Path, *args) -> dict:
    """``python ARGS`` in a child process, its output to a temporary file
    (read by :func:`_finish_all`)."""
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, *args], cwd=str(repo),
                            stdout=out, stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "out": out, "t0": time.perf_counter()}


def _finish_all(children: list) -> list:
    """Wait for the children of :func:`_spawn` (killing any left at
    ``CHILD_TIMEOUT_S``) → [(exit code, output, wall seconds)]."""
    deadline = time.perf_counter() + CHILD_TIMEOUT_S
    ended = {}
    try:
        while len(ended) < len(children) and time.perf_counter() < deadline:
            for i, c in enumerate(children):
                if i not in ended and c["proc"].poll() is not None:
                    ended[i] = time.perf_counter() - c["t0"]
            time.sleep(0.05)
    finally:
        for c in children:
            if c["proc"].poll() is None:
                c["proc"].kill()
            c["proc"].wait()
    out = []
    for i, c in enumerate(children):
        c["out"].seek(0)
        text = c["out"].read()
        c["out"].close()
        out.append((c["proc"].returncode, text, ended.get(i)))
    return out


def phase(*, smi: str, dev: torch.device, seed: int, queries, dataset, bf,
          flat, pq_index, cg_index, ring_comms, emit: Callable,
          repo: Path, launch_counts: Callable) -> Dict[str, int]:
    """Phase 6k. Returns the kernels' launches of its measured calls."""
    from raft_tpu_torch.analysis import (BASELINE_PATH, kernels,
                                         load_baseline, memory_audit,
                                         split_by_baseline)
    from raft_tpu_torch.neighbors import cagra, ivf_pq
    from raft_tpu_torch.obs import costs
    from raft_tpu_torch.ops import gpu_kernels as gk

    t0 = time.perf_counter()
    baseline = load_baseline(BASELINE_PATH)
    failures = []
    # the host's parts run beside the card's
    cli = _spawn(repo, "-m", "raft_tpu_torch.analysis", *CLI_ARGS)
    fakes = [_spawn(repo, "-c", FAKE_AUDIT, *map(str, group))
             for group in FAKE_GROUPS]

    try:
        # ---- (a) the accountants, the limits and the alignment
        queries_by_kernel = {name: kernels.SmemQueries(gk._lib(name))
                             for name in gk.SOURCES if name != "ring_shift"}
        props = torch.cuda.get_device_properties(dev)
        results, findings = kernels.kernel_smem_audit(
            queries_by_kernel, n_sm=props.multi_processor_count)
        ptxas = {name: costs.ptxas_figures(gk.library_path(name))
                 for name in gk.SOURCES}
        rows, limit_findings = kernels.launch_limits(
            results, ptxas, props.shared_memory_per_block_optin)
        findings += limit_findings
        compared = sum(r.cxx_bytes is not None for r in results)
        emit({"phase": "analysis_smem", "card": smi,
              "smem_optin": props.shared_memory_per_block_optin,
              "accountants_compared": compared, "rows": rows,
              "findings": [f.format() for f in findings],
              "phase_seconds": round(time.perf_counter() - t0, 3)})

        # ---- (b) the workspace: allocator peaks against budget and plan
        budget = memory_audit.DEFAULT_BUDGET_BYTES
        ivf_pq.ensure_scan_cache(pq_index)
        q = queries[:AUDIT_QUERIES].contiguous()
        params = cagra.SearchParams(itopk_size=64, search_width=1)
        _, _, _, n_seeds = cagra.resolve_search_plan(params, 10,
                                                     cg_index.size)
        ctx = {"queries": q, "bf_queries": queries[:BF_QUERIES].contiguous(),
               "bf": bf, "flat": flat, "pq": pq_index, "cagra": cg_index,
               "n_probes": AUDIT_PROBES, "k": AUDIT_K,
               "n_sm": props.multi_processor_count,
               "labels": torch.zeros(dataset.shape[0], dtype=torch.int32,
                                     device=dev),
               "select_values": torch.rand(
                   (1024, 65536), device=dev,
                   generator=torch.Generator(dev).manual_seed(seed)),
               "nn_x": dataset[:100_000], "nn_y": dataset[:4096],
               "seeds": cagra.seed_table(params, q.shape[0], cg_index.size,
                                         n_seeds, dev)}
        launches: Dict[str, int] = {}
        measured = []
        for name, make in memory_audit.ENTRY_MAKERS:
            e = costs.measure_entry(name, make, ctx, budget)
            for kernel, n in e.launches.items():
                launches[kernel] = launches.get(kernel, 0) + n
            measured.append(e)

        # ---- (c) the merges' received bytes over phase 5e's ranks
        gk.reset_launch_counts()
        merges = costs.merge_entries(ring_comms, nq=MERGE_QUERIES,
                                     kk=MERGE_K, k=MERGE_K, seed=seed)
        for kernel, n in launch_counts().items():
            if isinstance(n, int) and n:
                launches[kernel] = launches.get(kernel, 0) + n
        report = costs.build_report(measured + merges, device=dev)
        report.budget_bytes = budget
        cost_findings = report.calibration_findings()
        budget_findings = memory_audit.budget_findings([
            memory_audit.AuditResult(e.name, e.temp_bytes, budget)
            for e in measured])
        card_s = time.perf_counter() - t0
        lut_host = memory_audit.default_entries(budget)[0].run()
    finally:
        # the host's figures, then the CLI; the children are reaped
        # whatever the card's parts did
        *done, (cli_rc, cli_out, cli_s) = _finish_all([*fakes, cli])
        fake_rc = max(rc for rc, _, _ in done)
        fake_out = "".join(out for _, out, _ in done)
    host = {m.group(1): float(m.group(2)) * 2**20
            for m in _AUDIT_LINE.finditer(fake_out)}
    host[lut_host.name] = lut_host.peak_bytes
    emit({"phase": "analysis_workspace", "card": smi, "budget": budget,
          "entries": [{"name": e.name, "planner": e.planner,
                       "allocator_peak": e.temp_bytes,
                       "predicted": e.predicted_bytes,
                       "drift": e.drift_ratio, "host_fake": host.get(e.name),
                       "ms": round(1e3 * e.compile_s, 3),
                       "launches": e.launches, "tiles": e.tiles}
                      for e in measured],
          "fake_exit": fake_rc, "card_seconds": round(card_s, 3),
          "fake_seconds": [None if t is None else round(t, 3)
                           for _, _, t in done],
          "findings": [f.format() for f in cost_findings + budget_findings],
          "phase_seconds": round(time.perf_counter() - t0, 3)})
    emit({"phase": "analysis_merges", "card": smi,
          "ranks": ring_comms.size,
          "merges": [{"name": e.name, "received": e.collective_bytes,
                      "predicted": e.predicted_collective_bytes,
                      "launches": e.launches} for e in merges],
          "phase_seconds": round(time.perf_counter() - t0, 3)})
    cli_tail = cli_out.strip().splitlines()[-1:] if cli_out else []
    emit({"phase": "analysis_cli", "card": smi,
          "command": "python -m raft_tpu_torch.analysis " + " ".join(
              CLI_ARGS), "exit": cli_rc, "summary": cli_tail,
          "seconds": None if cli_s is None else round(cli_s, 3),
          "phase_seconds": round(time.perf_counter() - t0, 3)})

    new, _ = split_by_baseline(findings + cost_findings + budget_findings,
                               baseline)
    if new:
        failures.append("findings outside the baseline: "
                        + "; ".join(f.format() for f in new))
    if compared < sum(bool(r.accountant) for r in results):
        failures.append("an accountant was not read from its library")
    for e in merges:
        if e.collective_bytes != e.predicted_collective_bytes:
            failures.append(f"{e.name}: received {e.collective_bytes} B, "
                            "solve_merge_bytes "
                            f"{e.predicted_collective_bytes}")
    if len(host) != len(measured) or fake_rc != 0:
        failures.append(f"the host's memory audit exited {fake_rc} "
                        f"with {len(host)} of {len(measured)} figures: "
                        f"{fake_out[-2000:]}")
    if cli_rc != 0:
        failures.append(f"the analysis CLI exited {cli_rc}: "
                        f"{cli_out[-2000:]}")
    seconds = time.perf_counter() - t0
    emit({"phase": "analysis_total", "card": smi, "seconds": seconds,
          "launches": launches, "failures": failures})
    if failures:
        raise AssertionError("phase 6k: " + " | ".join(failures))
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("audit: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.bench.datagen import low_rank_clusters
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.parallel.comms import init_comms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gk.build_all()
    rows = low_rank_clusters(np.random.default_rng(opts.seed),
                             1_000_000 + 10_000, 128)
    dataset = torch.from_numpy(rows[:1_000_000]).to(dev)
    queries = torch.from_numpy(rows[1_000_000:]).to(dev)
    bf = brute_force.build(dataset)
    flat = ivf_flat.build(dataset, ivf_flat.IndexParams(n_lists=1024))
    pq = ivf_pq.build(dataset, ivf_pq.IndexParams(n_lists=1024, pq_dim=64,
                                                  pq_bits=8))
    # raft_cagra.d32, as phase 5b builds it
    cg = cagra.build(dataset, cagra.IndexParams(graph_degree=32,
                                                intermediate_graph_degree=64))

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def launch_counts():
        return dict(gk.LAUNCHES)

    phase(smi=smi, dev=dev, seed=opts.seed, queries=queries, dataset=dataset,
          bf=bf, flat=flat, pq_index=pq, cg_index=cg,
          ring_comms=init_comms([dev] * 4), emit=emit,
          repo=Path(__file__).resolve().parents[2],
          launch_counts=launch_counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
