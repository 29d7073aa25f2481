"""Findings and the committed baseline (graftcheck's suppression model).

The port's own copy of ``raft_tpu.analysis.findings``. A finding is keyed
``(rule, file, qualname)`` — stable across line-number churn, so refactors
that merely move code do not invalidate the baseline.
``raft_tpu_torch/analysis/baseline.json`` grandfathers pre-existing
violations with a one-line ``justification`` each; the gate fails only on
NEW findings. ``python -m raft_tpu_torch.analysis --update-baseline``
regenerates the file, carrying existing justifications forward for entries
that survive.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

BASELINE_VERSION = 1

#: the justification ``save_baseline`` stamps on entries that never got
#: a human one. A baseline carrying it is a TODO that was never done —
#: ``graftcheck`` refuses to treat such entries as suppressions.
PLACEHOLDER_JUSTIFICATION = "TODO: justify or fix"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``file`` is repo-relative; ``qualname`` is the dotted in-module path of
    the enclosing function/class (``"<module>"`` for module level, the
    entrypoint name for Tier-B audit findings).
    """

    rule: str
    file: str
    qualname: str
    line: int
    message: str

    @property
    def key(self) -> tuple:
        return (self.rule, self.file, self.qualname)

    def format(self) -> str:
        return (f"{self.file}:{self.line}: {self.rule} "
                f"[{self.qualname}] {self.message}")


def load_baseline(path) -> dict:
    """Baseline file → {key: justification}. Missing file → empty."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return {}
    entries = {}
    for e in doc.get("entries", []):
        key = (e["rule"], e["file"], e["qualname"])
        entries[key] = e.get("justification", "")
    return entries


def save_baseline(path, findings: Iterable[Finding],
                  old: Optional[dict] = None) -> None:
    """Write the baseline for ``findings``, carrying forward justifications
    from ``old`` (a load_baseline dict) where keys survive."""
    old = old or {}
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: f.key):
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append({
            "rule": f.rule,
            "file": f.file,
            "qualname": f.qualname,
            "justification": old.get(f.key, PLACEHOLDER_JUSTIFICATION),
        })
    with open(path, "w") as fh:
        json.dump({"version": BASELINE_VERSION, "entries": entries}, fh,
                  indent=1)
        fh.write("\n")


def unjustified_keys(baseline: dict) -> list:
    """Keys of baseline entries whose justification is empty or still
    the :data:`PLACEHOLDER_JUSTIFICATION` stamp. A suppression without a
    reason is a silent rot channel — ``graftcheck`` fails the run until
    each one is written (or the entry removed)."""
    return sorted(
        key for key, just in baseline.items()
        if not just.strip() or just.strip() == PLACEHOLDER_JUSTIFICATION)


def split_by_baseline(findings: Iterable[Finding], baseline: dict
                      ) -> tuple[list, list]:
    """→ (new_findings, suppressed_findings)."""
    new, suppressed = [], []
    for f in findings:
        (suppressed if f.key in baseline else new).append(f)
    return new, suppressed
