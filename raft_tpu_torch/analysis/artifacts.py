"""Artifact consistency gate (``--artifacts``, rule A001) for the port.

The port's counterpart of ``raft_tpu.analysis.artifacts``. The dispatch
layer reads ``raft_tpu_torch/artifacts/SELECT_K_TABLE_*``/``TOPK_PAD_*``/
``PALLAS_PROBE_*`` when it first routes, the adaptive planner reads
``PARETO_*`` frontiers, and this gate reads
``raft_tpu_torch/analysis/baseline.json``. Each runtime scanner skips a
malformed artifact rather than failing the import, which is right for
serving and wrong for a gate: a schema drift would demote a committed
artifact to silently ignored. This module runs every committed artifact
through the loader that consumes it:

- ``SELECT_K_TABLE_*`` → ``select_k``'s crossover extractor (a non-empty
  ``crossovers`` dict whose bands parse) and its ``platform`` key;
- ``TOPK_PAD_*`` → the pad rules, each row with its ``n``/``k``/``k_pad``;
- ``PALLAS_PROBE_*`` → ``gpu_kernels``' verdict extractor plus
  ``bench.probe.missing_verdicts`` over ``REQUIRED_VERDICT_FAMILIES``: a
  family without a measured verdict is a finding (the gate treats it as
  "the kernel loses" and routes around a kernel the card never measured);
- ``PARETO_*`` → ``planner.adaptive.load_frontier`` (schema-validating);
- the baseline → :func:`load_baseline`;
- anything else → ``json.load``.

The root-level ``*.json`` files are raft_tpu's and are not scanned here.
Findings carry rule ``A001`` and flow through the same baseline and
``--json`` machinery as every other tier.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, List, Tuple

from raft_tpu_torch.analysis.findings import Finding

__all__ = ["run_artifacts", "artifact_kind", "ARTIFACT_DIR_REL",
           "BASELINE_REL"]

_RULE = "A001"
#: the port's artifacts and its baseline, relative to the repo root
ARTIFACT_DIR_REL = os.path.join("raft_tpu_torch", "artifacts")
BASELINE_REL = os.path.join("raft_tpu_torch", "analysis", "baseline.json")


def artifact_kind(name: str) -> str:
    """The loader family an artifact belongs to."""
    if name == "baseline.json":
        return "baseline"
    for prefix, kind in (("PALLAS_PROBE_", "pallas_probe"),
                         ("SELECT_K_TABLE_", "select_k_table"),
                         ("TOPK_PAD_", "topk_pad"),
                         ("PARETO_", "pareto")):
        if name.startswith(prefix):
            return kind
    return "json"


def _check_select_k_table(art: dict, path: str) -> None:
    # mirrors select_k._load_auto_table's extractor and its band parse
    import importlib

    sk = importlib.import_module("raft_tpu_torch.ops.select_k")
    crossovers = art["crossovers"]
    if not isinstance(crossovers, dict) or not crossovers:
        raise ValueError("'crossovers' must be a non-empty dict")
    if "platform" not in art:
        raise ValueError("missing 'platform' key (the scanner keys by it)")
    sk._sorted_bands(crossovers)


def _check_topk_pad(art: dict, path: str) -> None:
    # mirrors select_k._load_pad_rules's extractor: every row is read by
    # (n, k) with its k_pad payload
    if "platform" not in art:
        raise ValueError("missing 'platform' key (the scanner keys by it)")
    for row in [dict(r) for r in art["pad_rules"]]:
        if not all(k in row for k in ("n", "k", "k_pad")):
            raise ValueError(f"pad rule {row} lacks an n/k/k_pad key")


def _check_pareto(art: dict, path: str) -> None:
    from raft_tpu_torch.planner.adaptive import load_frontier

    load_frontier(path)


def _check_baseline(art: dict, path: str) -> None:
    from raft_tpu_torch.analysis.findings import load_baseline

    for key, justification in load_baseline(path).items():
        if not isinstance(justification, str):
            raise ValueError(f"baseline entry {key} has a non-string "
                             "justification")


_CHECKERS: Dict[str, Callable[[dict, str], None]] = {
    "select_k_table": _check_select_k_table,
    "topk_pad": _check_topk_pad,
    "pareto": _check_pareto,
    "baseline": _check_baseline,
}


def _check_probe(art: dict, name: str, findings: List[Finding]) -> str:
    from raft_tpu_torch.bench.probe import (REQUIRED_VERDICT_FAMILIES,
                                            missing_verdicts)
    from raft_tpu_torch.ops.gpu_kernels import _extract_fused_table

    if not isinstance(art, dict) or "platform" not in art:
        findings.append(Finding(
            _RULE, name, "<artifact>", 0,
            "probe artifact has no 'platform' key — the runtime scanner "
            "would silently skip it"))
        return f"{name}: FINDING (unkeyed probe)"
    _extract_fused_table(art)
    missing = missing_verdicts(art, on_card=True)
    if missing:
        findings.append(Finding(
            _RULE, name, "<artifact>", 0,
            f"probe is missing measured verdicts for: {', '.join(missing)} "
            "— the dispatch layer treats an absent or failed row as 'the "
            "kernel loses'"))
        return f"{name}: FINDING (verdicts missing: {', '.join(missing)})"
    return (f"{name}: ok (probe, all {len(REQUIRED_VERDICT_FAMILIES)} "
            "verdict families covered)")


def run_artifacts(root: str) -> Tuple[List[Finding], List[str]]:
    """Validate every artifact of ``raft_tpu_torch/artifacts`` and the
    port's baseline under its consuming loader. → ``(findings,
    report_lines)``."""
    findings: List[Finding] = []
    report: List[str] = []
    paths = sorted(glob.glob(os.path.join(root, ARTIFACT_DIR_REL, "*.json")))
    baseline = os.path.join(root, BASELINE_REL)
    if os.path.isfile(baseline):
        paths.append(baseline)
    n_ok = 0
    for path in paths:
        name = os.path.basename(path)
        rel = os.path.relpath(path, root)
        kind = artifact_kind(name)
        try:
            with open(path) as fh:
                art = json.load(fh)
        except (OSError, ValueError) as e:
            findings.append(Finding(
                _RULE, rel, "<artifact>", 0,
                f"does not parse as JSON: {type(e).__name__}: {e}"))
            report.append(f"{rel}: FINDING (not JSON)")
            continue
        if kind == "pallas_probe":
            line = _check_probe(art, rel, findings)
            report.append(line)
            n_ok += "FINDING" not in line
            continue
        checker = _CHECKERS.get(kind)
        if checker is None:
            report.append(f"{rel}: ok (json)")
            n_ok += 1
            continue
        try:
            checker(art, path)
        except Exception as e:  # any loader rejection is the finding
            findings.append(Finding(
                _RULE, rel, "<artifact>", 0,
                f"rejected by its {kind} loader: {type(e).__name__}: {e} — "
                "the runtime scanner would silently skip this artifact"))
            report.append(f"{rel}: FINDING ({kind} loader rejected)")
            continue
        report.append(f"{rel}: ok ({kind})")
        n_ok += 1
    report.append(f"{n_ok}/{len(paths)} artifact(s) loadable under their "
                  "consuming loaders")
    return findings, report
