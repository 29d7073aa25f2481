"""graftcheck for the port — static analysis of raft_tpu_torch.

The port's counterpart of ``raft_tpu.analysis`` (its own copies: nothing
here imports jax or raft_tpu). The analysers read the trees they scan as
text and never import them, so each runs over ``raft_tpu`` as well as over
``raft_tpu_torch`` where its rules are package-agnostic.

* **Tier A** (pure AST): R001–R007 over the package — host syncs, branches
  on tensor values, library loads or graph captures in loops and
  unbudgeted multi-axis intermediates on the request path; cross-package
  private imports; untraced entry points; unattributed dispatch. See
  :mod:`raft_tpu_torch.analysis.rules_ast` and :mod:`.layering`.
* **Threads** (``--threads``): T001–T004, raft_tpu's concurrency rules.
  See :mod:`raft_tpu_torch.analysis.concurrency`.
* **Tier F** (``--flow``): F001–F005, raft_tpu's typed-failure and
  resource-lifecycle rules over the request path. See :mod:`.flow`.
* **Tier K** (``--kernels``): K001–K005 over the CUDA sources of
  ``csrc/`` (async-copy and barrier pairing, shared-memory accounting,
  alignment, barrier divergence) and the CPU/card branches of the Python
  package, plus the accountant sweep (the Python accountants against the
  C++ ones, built with ``g++``). See :mod:`.kernels`.
* **Artifacts** (``--artifacts``): A001 over ``raft_tpu_torch/artifacts``
  and the baseline, each under the loader that consumes it. See
  :mod:`.artifacts`.
* **Memory** (``--memory-audit``): B001, the peak live bytes of each
  canonical entry's torch route under a dispatch mode against the
  workspace budget. See :mod:`.memory_audit`.
* **Costs** (``--costs``): C001, the planners' predicted workspace against
  the measured one (:mod:`raft_tpu_torch.obs.costs`).

Findings are keyed ``(rule, file, qualname)`` so the committed baseline
(``raft_tpu_torch/analysis/baseline.json``) survives line churn; see
:mod:`.findings`. ``python -m raft_tpu_torch.analysis`` is the gate.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Tuple

from raft_tpu_torch.analysis.artifacts import run_artifacts
from raft_tpu_torch.analysis.astutils import ModuleInfo
from raft_tpu_torch.analysis.concurrency import THREAD_SCAN_DIRS, run_threads
from raft_tpu_torch.analysis.findings import (PLACEHOLDER_JUSTIFICATION,
                                              Finding, load_baseline,
                                              save_baseline,
                                              split_by_baseline,
                                              unjustified_keys)
from raft_tpu_torch.analysis.flow import FLOW_RULES, flow_stats, run_flow
from raft_tpu_torch.analysis.kernels import (KERNEL_RULES, KERNEL_SCAN_DIRS,
                                             kernel_smem_audit, kernel_stats,
                                             run_kernels)
from raft_tpu_torch.analysis.layering import check_layering
from raft_tpu_torch.analysis.rules_ast import (AST_RULES, rule_host_sync,
                                               rule_tensor_branch,
                                               rule_unattributed_dispatch,
                                               rule_unguarded_broadcast,
                                               rule_untraced_entry_point)

__all__ = [
    "Finding", "ModuleInfo", "AST_RULES", "check_layering",
    "load_baseline", "save_baseline", "split_by_baseline",
    "unjustified_keys", "PLACEHOLDER_JUSTIFICATION",
    "collect_modules", "run_tier_a", "run_threads",
    "run_flow", "flow_stats", "FLOW_RULES",
    "run_kernels", "kernel_stats", "kernel_smem_audit", "KERNEL_RULES",
    "run_artifacts", "DEFAULT_SCAN_DIRS", "THREAD_SCAN_DIRS",
    "KERNEL_SCAN_DIRS", "BASELINE_PATH",
]

#: directories scanned by Tier A by default, relative to the repo root
DEFAULT_SCAN_DIRS = ("raft_tpu_torch",)
#: the port's committed baseline
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

_SKIP_PARTS = {"__pycache__", ".git", "data"}

#: Tier-A rules that take the root package as a parameter
_PACKAGE_RULES = (rule_host_sync, rule_tensor_branch,
                  rule_unguarded_broadcast, rule_untraced_entry_point,
                  rule_unattributed_dispatch)


#: parsed modules by (path, relfile, modname): (mtime_ns, size, ModuleInfo).
#: The tiers of one run scan the same files; each is parsed once while it
#: is unchanged.
_PARSED: dict = {}


def parse_module(path: str, relfile: str, modname: str) -> ModuleInfo:
    """The :class:`ModuleInfo` of a file, parsed once while its size and
    modification time stay the same."""
    st = os.stat(path)
    key = (path, relfile, modname)
    hit = _PARSED.get(key)
    if hit is not None and hit[:2] == (st.st_mtime_ns, st.st_size):
        return hit[2]
    mod = ModuleInfo(path, relfile, modname)
    _PARSED[key] = (st.st_mtime_ns, st.st_size, mod)
    return mod


def _modname_for(relfile: str) -> str:
    mod = relfile[:-3] if relfile.endswith(".py") else relfile
    mod = mod.replace(os.sep, ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def collect_modules(root: str,
                    dirs: Iterable[str] = DEFAULT_SCAN_DIRS,
                    ) -> Tuple[List[ModuleInfo], List[Finding]]:
    """Parse every ``.py`` file under ``dirs`` into :class:`ModuleInfo`.

    Returns ``(modules, parse_findings)``; files that fail to parse
    become rule ``E000`` findings instead of aborting the whole scan.
    """
    modules: List[ModuleInfo] = []
    errors: List[Finding] = []
    for d in dirs:
        base = os.path.join(root, d)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(x for x in dirnames
                                 if x not in _SKIP_PARTS)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                relfile = os.path.relpath(path, root)
                try:
                    modules.append(
                        parse_module(path, relfile, _modname_for(relfile)))
                except SyntaxError as e:
                    errors.append(Finding(
                        rule="E000", file=relfile, qualname="<module>",
                        line=e.lineno or 0,
                        message=f"syntax error: {e.msg}"))
    return modules, errors


def _dedupe(findings: Iterable[Finding]) -> List[Finding]:
    seen = set()
    unique = []
    for f in findings:
        ident = (f.key, f.line, f.message)
        if ident not in seen:
            seen.add(ident)
            unique.append(f)
    unique.sort(key=lambda f: (f.file, f.line, f.rule))
    return unique


def run_tier_a(root: str,
               dirs: Iterable[str] = DEFAULT_SCAN_DIRS,
               rules: Optional[Iterable] = None,
               package: str = "raft_tpu_torch") -> List[Finding]:
    """Every Tier-A rule (R001–R007) over the tree at ``root``; the
    package-scoped rules take ``package``."""
    modules, findings = collect_modules(root, dirs)
    for mod in modules:
        for rule in (rules if rules is not None else AST_RULES):
            if rule in _PACKAGE_RULES:
                findings.extend(rule(mod, package))
            else:
                findings.extend(rule(mod))
    findings.extend(check_layering(modules, package))
    return _dedupe(findings)

