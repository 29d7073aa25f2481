"""``python -m raft_tpu_torch.analysis`` — the port's static-analysis gate.

Tier A (default) is pure AST work and never imports the code it scans;
the other tiers are flags, as ``tools/graftcheck.py``'s are for raft_tpu.
Exit status: 0 when every finding is baselined, 1 when new findings exist
(or a baseline entry has no justification), 2 on usage errors.

Typical use::

    python -m raft_tpu_torch.analysis                  # Tier A
    python -m raft_tpu_torch.analysis --threads --flow --kernels --artifacts
    python -m raft_tpu_torch.analysis --threads --dot lock_order.dot
    python -m raft_tpu_torch.analysis --kernels --no-kernel-sweep
    python -m raft_tpu_torch.analysis --memory-audit --costs
    python -m raft_tpu_torch.analysis --json out.json
    python -m raft_tpu_torch.analysis --update-baseline
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from raft_tpu_torch.analysis import (BASELINE_PATH, load_baseline,
                                     run_tier_a, save_baseline,
                                     split_by_baseline, unjustified_keys)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _kernel_sweep(args, findings: list) -> None:
    """The accountant sweep: the Python accountants against ``g++``'s
    build of csrc/smem_budget.h at the planner-domain shapes."""
    import subprocess

    from raft_tpu_torch.analysis import Finding
    from raft_tpu_torch.analysis.kernels import (SmemQueries,
                                                 build_smem_budget,
                                                 kernel_smem_audit)
    queries = None
    try:
        queries = SmemQueries(build_smem_budget(args.root))
    except FileNotFoundError as e:  # no C++ compiler on this host
        print(f"  [kernels] {e}: the Python accountants are swept alone")
    except subprocess.CalledProcessError as e:
        findings.append(Finding(
            "K002", "raft_tpu_torch/csrc/smem_budget.h", "<module>", 0,
            f"the header does not build alone: {e.stderr.strip()[:300]}"))
    results, sweep_findings = kernel_smem_audit(queries)
    findings.extend(sweep_findings)
    if args.quiet:
        return
    for r in results:
        state = "OK  " if r.ok else "FAIL"
        cxx = "-" if r.cxx_bytes is None else str(r.cxx_bytes)
        print(f"  [kernels] {state} {r.kernel}@{r.point}: {r.route} "
              f"{r.accountant or '(no dynamic smem)'} {r.python_bytes} B "
              f"(C++ {cxx}) <= {r.limit}"
              + (f" — {'; '.join(r.alignment)}" if r.alignment else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=REPO_ROOT,
                    help="repo root to scan (default: this checkout)")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="baseline JSON of grandfathered findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(carries existing justifications forward)")
    ap.add_argument("--threads", action="store_true",
                    help="also run the concurrency rules T001-T004")
    ap.add_argument("--dot", metavar="PATH", default=None,
                    help="with --threads: write the lock-order graph as "
                         "Graphviz DOT ('-' = stdout)")
    ap.add_argument("--flow", action="store_true",
                    help="also run the flow rules F001-F005 over the "
                         "request path")
    ap.add_argument("--kernels", action="store_true",
                    help="also run the CUDA kernel rules K001-K005 over "
                         "csrc/ and the CPU/card branches, plus the "
                         "accountant sweep (g++ builds smem_budget.h)")
    ap.add_argument("--no-kernel-sweep", action="store_true",
                    help="with --kernels: the static rules only")
    ap.add_argument("--artifacts", action="store_true",
                    help="also validate raft_tpu_torch/artifacts and the "
                         "baseline under their loaders (rule A001)")
    ap.add_argument("--memory-audit", action="store_true",
                    help="also run the memory audit (B001): each canonical "
                         "entry's peak live bytes under a dispatch mode, on "
                         "fake tensors")
    ap.add_argument("--costs", action="store_true",
                    help="also run the workspace calibration (C001): each "
                         "planner's predicted workspace against the measured "
                         "one (the memory audit's on the CPU)")
    ap.add_argument("--budget-bytes", type=int, default=None,
                    help="workspace budget of --memory-audit/--costs "
                         "(default: 2 GiB, the CPU-fallback "
                         "workspace_limit_bytes)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write a machine-readable findings dump; '-' = "
                         "stdout")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to keep (e.g. R001,T001)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only the summary line")
    args = ap.parse_args(argv)

    if args.dot is not None and not args.threads:
        ap.error("--dot requires --threads")
    if args.no_kernel_sweep and not args.kernels:
        ap.error("--no-kernel-sweep requires --kernels")

    findings = run_tier_a(args.root)

    if args.threads:
        from raft_tpu_torch.analysis.concurrency import (lock_order_dot,
                                                         run_threads,
                                                         thread_model_summary)
        findings.extend(run_threads(args.root))
        if not args.quiet:
            for line in thread_model_summary(args.root):
                print(f"  [threads] {line}")
        if args.dot is not None:
            dot = lock_order_dot(args.root)
            if args.dot == "-":
                sys.stdout.write(dot)
            else:
                with open(args.dot, "w") as f:
                    f.write(dot)
                print(f"analysis: lock-order graph -> {args.dot}")

    if args.flow:
        from raft_tpu_torch.analysis.flow import flow_stats, run_flow
        findings.extend(run_flow(args.root))
        if not args.quiet:
            s = flow_stats(args.root)
            print(f"  [flow] {s['modules']} request-path modules: "
                  f"{s['raise_sites']} raise sites, "
                  f"{s['settle_owners']} settle owners, "
                  f"{s['resources']} reclaimable resources")

    if args.kernels:
        from raft_tpu_torch.analysis.kernels import kernel_stats, run_kernels
        findings.extend(run_kernels(args.root))
        if not args.quiet:
            s = kernel_stats(args.root)
            print(f"  [kernels] {s['sources']} CUDA sources: "
                  f"{s['kernels']} kernels, {s['async_sites']} async "
                  f"sites, {s['launches']} launches, "
                  f"{s['accounted_smem_sites']} accounted smem sites")
        if not args.no_kernel_sweep:
            _kernel_sweep(args, findings)

    if args.artifacts:
        from raft_tpu_torch.analysis.artifacts import run_artifacts
        artifact_findings, report = run_artifacts(args.root)
        findings.extend(artifact_findings)
        if not args.quiet:
            for line in report:
                print(f"  [artifacts] {line}")

    if args.memory_audit:
        from raft_tpu_torch.analysis import memory_audit
        budget = args.budget_bytes or memory_audit.DEFAULT_BUDGET_BYTES
        results, audit_findings = memory_audit.run_audit(budget_bytes=budget)
        findings.extend(audit_findings)
        if not args.quiet:
            for r in results:
                print(f"  [memory-audit]{r.format()}")

    if args.costs:
        from raft_tpu_torch.obs import costs
        report = costs.calibrate(budget_bytes=args.budget_bytes)
        cost_findings = report.calibration_findings()
        findings.extend(cost_findings)
        if not args.quiet:
            flagged = {f.qualname for f in cost_findings}
            for e in report.entries:
                r = e.drift_ratio
                if r is None:
                    continue
                state = "FAIL" if e.name in flagged else "OK  "
                print(f"  [costs] {state} {e.name}: planner {e.planner} "
                      f"predicted {e.predicted_bytes / 2**20:.0f} MiB, "
                      f"measured {e.temp_bytes / 2**20:.0f} MiB on "
                      f"{e.device} (drift {r:.2f}x)")

    if args.rules:
        keep = {r.strip() for r in args.rules.split(",") if r.strip()}
        findings = [f for f in findings if f.rule in keep]

    if args.update_baseline:
        old = load_baseline(args.baseline)
        save_baseline(args.baseline, findings, old)
        print(f"analysis: baseline rewritten with {len(findings)} "
              f"finding(s) -> {args.baseline}")
        return 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new, suppressed = split_by_baseline(findings, baseline)

    if args.json is not None:
        baselined = {f.key for f in suppressed}
        doc = {"version": 1, "findings": [
            {"rule": f.rule, "file": f.file, "line": f.line,
             "qualname": f.qualname, "message": f.message,
             "baselined": f.key in baselined}
            for f in findings]}
        payload = json.dumps(doc, indent=2, sort_keys=True) + "\n"
        if args.json == "-":
            sys.stdout.write(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload)
            print(f"analysis: findings dump -> {args.json}")

    placeholders = unjustified_keys(baseline)
    if placeholders:
        for rule, file, qualname in placeholders:
            print(f"analysis: baseline entry ({rule}, {file}, {qualname}) "
                  f"has no real justification — write one in "
                  f"{args.baseline} or fix and remove the entry")
        print(f"analysis: {len(placeholders)} baseline entr"
              f"{'y' if len(placeholders) == 1 else 'ies'} still carry "
              "the placeholder; a suppression without a reason is not a "
              "suppression")
        return 1

    if not args.quiet:
        for f in new:
            print(f.format())
    n_rules = len({f.rule for f in new})
    print(f"analysis: {len(new)} new finding(s) across {n_rules} rule(s); "
          f"{len(suppressed)} baselined")
    if new:
        print("fix the findings, suppress a line with '# graftcheck: RXXX', "
              "or re-record with --update-baseline (justify in the JSON)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
