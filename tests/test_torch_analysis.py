"""The port's analysis layer, tiers A, T, F and A001, its CLI and its
baseline (``raft_tpu_torch.analysis``).

- **Parity with raft_tpu.** On the same inputs the port's T001-T004,
  F001-F005, R004, R006 and R007 (with the package parameter set to
  ``raft_tpu``) give exactly ``raft_tpu.analysis``'s (rule, file,
  qualname, line) set, over ``raft_tpu/`` and over raft_tpu's fixture
  twins (``tests/data/graftcheck``).
- **Port-only rules.** R001, R002, R003 and R005 on their bad/clean twins
  (``tests/data/graftcheck_torch``): the bad one is flagged at the expected
  qualname, the clean one passes.
- **The port's own gate.** Clean on ``raft_tpu_torch/`` under
  ``baseline.json``, every entry justified; the findings named when the
  layer was ported stay repaired; inline suppression, baseline round trips
  and the CLI's exit codes.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import raft_tpu.analysis as J
from raft_tpu.analysis import astutils as j_astutils
from raft_tpu.analysis import concurrency as j_conc
from raft_tpu.analysis import flow as j_flow
from raft_tpu.analysis import layering as j_layering
from raft_tpu.analysis import rules_ast as j_rules

import raft_tpu_torch.analysis as P
from raft_tpu_torch.analysis import astutils as p_astutils
from raft_tpu_torch.analysis import concurrency as p_conc
from raft_tpu_torch.analysis import flow as p_flow
from raft_tpu_torch.analysis import layering as p_layering
from raft_tpu_torch.analysis import rules_ast as p_rules
from raft_tpu_torch.analysis.__main__ import main as cli_main
from raft_tpu_torch.analysis.artifacts import run_artifacts
from raft_tpu_torch.analysis.findings import (PLACEHOLDER_JUSTIFICATION,
                                              load_baseline, save_baseline,
                                              split_by_baseline,
                                              unjustified_keys)

REPO = str(Path(__file__).resolve().parents[1])
RAFT_FIX = os.path.join(REPO, "tests", "data", "graftcheck")
PORT_FIX = os.path.join(REPO, "tests", "data", "graftcheck_torch")


def _key(findings):
    return sorted((f.rule, f.file, f.qualname, f.line) for f in findings)


def _mods(fname, modname):
    """The fixture as each package's ModuleInfo."""
    path = os.path.join(RAFT_FIX, fname)
    rel = f"tests/data/graftcheck/{fname}"
    return (j_astutils.ModuleInfo(path, rel, modname),
            p_astutils.ModuleInfo(path, rel, modname))


def _port_mod(fname, modname=None):
    return p_astutils.ModuleInfo(
        os.path.join(PORT_FIX, fname), f"tests/data/graftcheck_torch/{fname}",
        modname or f"raft_tpu_torch.neighbors.{fname[:-3]}")


# ---------------------------------------------------- parity with raft_tpu

def test_threads_match_raft_tpu_over_its_tree():
    got = _key(p_conc.run_threads(REPO, dirs=("raft_tpu",)))
    assert got == _key(j_conc.run_threads(REPO))
    assert got  # raft_tpu's tree has baselined T001s: the sweep is not empty


def test_flow_matches_raft_tpu_over_its_tree():
    got = _key(p_flow.run_flow(REPO, package="raft_tpu"))
    assert got == _key(j_flow.run_flow(REPO))
    assert len(got) >= 10
    assert p_flow.flow_stats(REPO, "raft_tpu") == j_flow.flow_stats(REPO)


def test_layering_and_scoped_rules_match_raft_tpu_over_its_tree():
    dirs = ("raft_tpu",)
    jm, _ = J.collect_modules(REPO, dirs)
    pm, _ = P.collect_modules(REPO, dirs)
    assert [m.relfile for m in jm] == [m.relfile for m in pm]
    assert _key(p_layering.check_layering(pm, "raft_tpu")) == _key(
        j_layering.check_layering(jm))
    for j_rule, p_rule in ((j_rules.rule_untraced_entry_point,
                            p_rules.rule_untraced_entry_point),
                           (j_rules.rule_unattributed_dispatch,
                            p_rules.rule_unattributed_dispatch)):
        assert _key(f for m in pm for f in p_rule(m, "raft_tpu")) == _key(
            f for m in jm for f in j_rule(m))


_THREAD_RULES = list(zip(j_conc.THREAD_RULES, p_conc.THREAD_RULES))
_FLOW_RULES = list(zip(j_flow.FLOW_RULES, p_flow.FLOW_RULES))


@pytest.mark.parametrize("stem", ["t001", "t002", "t003", "t004"])
@pytest.mark.parametrize("twin", ["bad", "clean"])
def test_thread_rules_match_raft_tpu_on_its_twins(stem, twin):
    jm, pm = _mods(f"{stem}_{twin}.py", f"raft_tpu.fixture_pkg_b.{stem}")
    for j_rule, p_rule in _THREAD_RULES:
        assert _key(p_rule(pm)) == _key(j_rule(jm)), p_rule.__name__
    if twin == "bad":
        assert any(p_rule(pm) for _, p_rule in _THREAD_RULES)


@pytest.mark.parametrize("stem", ["f001", "f002", "f003", "f004", "f005"])
@pytest.mark.parametrize("twin", ["bad", "clean"])
def test_flow_rules_match_raft_tpu_on_its_twins(stem, twin):
    jm, pm = _mods(f"{stem}_{twin}.py", f"raft_tpu.fixture_pkg_b.{stem}")
    j_ctx, p_ctx = j_flow.FlowContext([jm]), p_flow.FlowContext([pm])
    for j_rule, p_rule in _FLOW_RULES:
        assert _key(p_rule(pm, p_ctx)) == _key(j_rule(jm, j_ctx)), \
            p_rule.__name__
    if twin == "bad":
        assert any(p_rule(pm, p_ctx) for _, p_rule in _FLOW_RULES)


def test_layering_matches_raft_tpu_on_its_twins():
    names = [("r004_provider.py", "raft_tpu.fixture_pkg_a.r004_provider"),
             ("r004_bad.py", "raft_tpu.fixture_pkg_b.r004_bad"),
             ("r004_clean.py", "raft_tpu.fixture_pkg_b.r004_clean")]
    jm, pm = zip(*(_mods(f, m) for f, m in names))
    got = p_layering.check_layering(list(pm), "raft_tpu")
    assert _key(got) == _key(j_layering.check_layering(list(jm)))
    assert [(f.rule, f.qualname) for f in got] == [("R004", "<module>")]
    # the same twins under the port's root: the port's own privates
    port = [p_astutils.ModuleInfo(m.path, m.relfile,
                                  m.modname.replace("raft_tpu.",
                                                    "raft_tpu_torch.", 1))
            for m in pm]
    assert p_layering.check_layering(port) == []  # imports raft_tpu only


@pytest.mark.parametrize("stem,modname", [
    ("r006", "raft_tpu.neighbors.{}"),
    ("r006", "raft_tpu.fixture_pkg_b.{}"),
    ("r007", "raft_tpu.neighbors.{}"),
    ("r007", "raft_tpu.ops.pallas_kernels"),
])
@pytest.mark.parametrize("twin", ["bad", "clean"])
def test_scoped_rules_match_raft_tpu_on_its_twins(stem, modname, twin):
    fname = f"{stem}_{twin}.py"
    jm, pm = _mods(fname, modname.format(fname[:-3]))
    pairs = {"r006": (j_rules.rule_untraced_entry_point,
                      p_rules.rule_untraced_entry_point),
             "r007": (j_rules.rule_unattributed_dispatch,
                      p_rules.rule_unattributed_dispatch)}
    j_rule, p_rule = pairs[stem]
    assert _key(p_rule(pm, "raft_tpu")) == _key(j_rule(jm))


def test_scoped_rules_flag_raft_tpus_bad_twins():
    jm, pm = _mods("r006_bad.py", "raft_tpu.neighbors.r006_bad")
    assert [f.qualname for f in p_rules.rule_untraced_entry_point(
        pm, "raft_tpu")] == ["build", "search"]
    jm, pm = _mods("r007_bad.py", "raft_tpu.neighbors.r007_bad")
    assert [f.qualname for f in p_rules.rule_unattributed_dispatch(
        pm, "raft_tpu")] == ["silently_falls_back"]


# ----------------------------------------------------- port-only rules

@pytest.mark.parametrize("rule,rule_id,stem,expect_qual", [
    (p_rules.rule_host_sync, "R001", "r001", "_pick"),
    (p_rules.rule_tensor_branch, "R002", "r002", "search"),
    (p_rules.rule_recompile_hazard, "R003", "r003", "run_batches"),
    (p_rules.rule_unguarded_broadcast, "R005", "r005", "search"),
], ids=["R001", "R002", "R003", "R005"])
def test_port_rule_flags_bad_and_passes_clean(rule, rule_id, stem,
                                              expect_qual):
    found = rule(_port_mod(f"{stem}_bad.py"))
    assert [(f.rule, f.qualname) for f in found] == [(rule_id, expect_qual)]
    assert rule(_port_mod(f"{stem}_clean.py")) == []


def test_request_path_is_the_entry_points_closure():
    mod = _port_mod("r001_bad.py")
    assert p_rules.request_path(mod) == {"search", "_scores", "_pick"}
    # outside the scoped packages nothing is on the request path
    assert p_rules.request_path(_port_mod(
        "r001_bad.py", "raft_tpu_torch.ops.r001_bad")) == set()
    assert p_rules.rule_host_sync(_port_mod(
        "r001_bad.py", "raft_tpu_torch.ops.r001_bad")) == []


def test_port_request_path_covers_the_search_entry_points():
    modules, _ = P.collect_modules(REPO)
    seen = {m.modname: p_rules.request_path(m) for m in modules}
    assert "search" in seen["raft_tpu_torch.neighbors.ivf_pq"]
    assert "_search_lut_core" in seen["raft_tpu_torch.neighbors.ivf_pq"]
    assert "search_ivf_flat" in seen["raft_tpu_torch.parallel.sharded"]
    assert "brute_force_searcher.search" in seen[
        "raft_tpu_torch.serving.searchers"]


def test_inline_suppression(tmp_path):
    src = open(os.path.join(PORT_FIX, "r001_bad.py")).read()
    anchor = "kth = torch.topk(d, k, dim=1).values[:, -1].max().item()"
    assert anchor in src
    p = tmp_path / "r001_supp.py"
    p.write_text(src.replace(anchor, anchor + "  # graftcheck: R001"))
    mod = p_astutils.ModuleInfo(str(p), "r001_supp.py",
                                "raft_tpu_torch.neighbors.r001_supp")
    assert p_rules.rule_host_sync(mod) == []


# ------------------------------------------------------ the port's gate

@pytest.fixture(scope="module")
def port_findings():
    """Tier A, T, F and the static Tier K over the port, once."""
    return (P.run_tier_a(REPO) + P.run_threads(REPO) + P.run_flow(REPO)
            + P.run_kernels(REPO))


def test_port_is_clean_under_its_baseline(port_findings):
    baseline = load_baseline(P.BASELINE_PATH)
    assert unjustified_keys(baseline) == []
    findings = port_findings
    new, suppressed = split_by_baseline(findings, baseline)
    assert new == [], "\n".join(f.format() for f in new)
    assert suppressed  # the sweep saw the baselined findings
    # every entry still matches a finding (or a C001 of the calibration)
    live = {f.key for f in findings}
    stale = [k for k in baseline if k not in live and k[0] != "C001"]
    assert stale == []


def test_named_findings_stay_repaired(port_findings):
    """The 13 findings raft_tpu's own T and F rules gave over the port when
    the layer was ported: neither found again nor baselined."""
    named = {
        ("T001", "raft_tpu_torch/neighbors/tiered.py", f"SlabArena.{a}")
        for a in ("_dec", "_norms", "_ids", "_sizes")} | {
        ("T001", "raft_tpu_torch/neighbors/mutable.py", q)
        for q in ("WriteAheadLog.last_sync_error", "Compactor._thread",
                  "Compactor.last_error", "Compactor._last_run_t")} | {
        ("T001", "raft_tpu_torch/neighbors/tiered.py",
         "TierPrefetcher._thread"),
        ("T001", "raft_tpu_torch/parallel/sharded.py", "ShardedCagra._seeds"),
        ("T001", "raft_tpu_torch/bench/fleet_load.py", "Child.ready_s"),
        ("T001", "raft_tpu_torch/serving/engine.py", "Engine._planner_failed"),
        ("F001", "raft_tpu_torch/serving/engine.py", "Engine.start")}
    assert len(named) == 13
    assert not named & {f.key for f in port_findings}
    assert not named & set(load_baseline(P.BASELINE_PATH))


def test_baseline_round_trip_carries_justifications(tmp_path):
    findings = p_rules.rule_host_sync(_port_mod("r001_bad.py"))
    path = tmp_path / "baseline.json"
    save_baseline(str(path), findings, {})
    assert unjustified_keys(load_baseline(str(path))) == [findings[0].key]
    doc = json.loads(path.read_text())
    doc["entries"][0]["justification"] = "a fixture's deliberate sync"
    path.write_text(json.dumps(doc))
    save_baseline(str(path), findings, load_baseline(str(path)))
    baseline = load_baseline(str(path))
    assert baseline[findings[0].key] == "a fixture's deliberate sync"
    moved = [type(f)(f.rule, f.file, f.qualname, f.line + 9, f.message)
             for f in findings]
    new, suppressed = split_by_baseline(moved, baseline)
    assert new == [] and len(suppressed) == 1


# ------------------------------------------------------------- artifacts

def test_artifacts_gate_is_clean_on_the_port():
    findings, report = run_artifacts(REPO)
    assert findings == [], [f.format() for f in findings]
    assert report[-1] == "5/5 artifact(s) loadable under their consuming " \
                         "loaders"
    assert any("PALLAS_PROBE_cuda.json: ok" in r for r in report)


def _artifact_tree(tmp_path, name, doc):
    d = tmp_path / "raft_tpu_torch" / "artifacts"
    d.mkdir(parents=True)
    (d / name).write_text(doc if isinstance(doc, str) else json.dumps(doc))
    return str(tmp_path)


@pytest.mark.parametrize("name,doc,needle", [
    ("SELECT_K_TABLE_x.json", {"platform": "x", "crossovers": []},
     "select_k_table loader"),
    ("TOPK_PAD_x.json", {"platform": "x", "pad_rules": [{"n": 1}]},
     "topk_pad loader"),
    ("PARETO_x.json", {"schema": "nope"}, "pareto loader"),
    ("PALLAS_PROBE_x.json", {"platform": "x", "fused": {
        "brute_force": {"fused_wins": True}}}, "missing measured verdicts"),
    ("PALLAS_PROBE_y.json", {"fused": {}}, "no 'platform' key"),
    ("SELECT_K_TABLE_y.json", "{not json", "does not parse"),
])
def test_artifacts_gate_flags_a_rejected_artifact(tmp_path, name, doc,
                                                  needle):
    findings, _ = run_artifacts(_artifact_tree(tmp_path, name, doc))
    assert [f.rule for f in findings] == ["A001"]
    assert needle in findings[0].message


# ------------------------------------------------------------------- CLI

def _cli(*args):
    """The CLI in this process → (exit code, standard output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = cli_main(list(args))
        except SystemExit as e:  # argparse's usage errors
            rc = e.code
    return rc, out.getvalue()


def _scratch_tree(tmp_path, fixture, dest):
    """A tree with one port fixture placed as a module of the package."""
    target = tmp_path / dest
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(open(os.path.join(PORT_FIX, fixture)).read())
    return str(tmp_path)


def test_cli_gates_the_repo_and_imports_no_jax():
    probe = (
        "import runpy, sys\n"
        "sys.argv = ['analysis', '--threads', '--flow', '--kernels', "
        "'--artifacts', '-q']\n"
        "try:\n"
        "    runpy.run_module('raft_tpu_torch.analysis', run_name='__main__')\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'raft_tpu'))\n"
        "print('RESULT', rc, bad)\n")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, cwd=REPO, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert "RESULT 0 []" in proc.stdout, proc.stdout + proc.stderr
    assert "0 new finding(s)" in proc.stdout


def test_cli_exit_codes(tmp_path):
    root = _scratch_tree(tmp_path, "r001_bad.py",
                         "raft_tpu_torch/neighbors/injected.py")
    rc, out = _cli("--root", root, "--no-baseline", "--rules", "R001")
    assert rc == 1, out
    assert "R001" in out and "_pick" in out
    clean = _scratch_tree(tmp_path / "clean", "r001_clean.py",
                          "raft_tpu_torch/neighbors/injected.py")
    assert _cli("--root", clean, "--no-baseline", "--rules", "R001")[0] == 0
    with contextlib.redirect_stderr(io.StringIO()):
        assert _cli("--dot", "-")[0] == 2
        assert _cli("--no-kernel-sweep")[0] == 2


def test_cli_threads_flow_and_rules_filter(tmp_path):
    root = tmp_path
    pkg = root / "raft_tpu_torch" / "serving"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text('__all__ = ["Typed"]\n')
    (pkg / "bad.py").write_text(open(os.path.join(
        RAFT_FIX, "f001_bad.py")).read())
    rc, out = _cli("--root", str(root), "--no-baseline", "--flow")
    assert rc == 1 and "F001" in out, out
    assert _cli("--root", str(root), "--no-baseline",
                "--rules", "R001")[0] == 0
    thr = root / "raft_tpu_torch" / "t.py"
    thr.write_text(open(os.path.join(RAFT_FIX, "t001_bad.py")).read())
    rc, out = _cli("--root", str(root), "--no-baseline", "--threads",
                   "--rules", "T001")
    assert rc == 1 and "T001" in out


def test_cli_placeholder_justification_fails_the_gate(tmp_path):
    root = _scratch_tree(tmp_path, "r001_bad.py",
                         "raft_tpu_torch/neighbors/injected.py")
    base = tmp_path / "baseline.json"
    assert _cli("--root", root, "--baseline", str(base),
                "--update-baseline")[0] == 0
    doc = json.loads(base.read_text())
    assert all(e["justification"] == PLACEHOLDER_JUSTIFICATION
               for e in doc["entries"])
    rc, out = _cli("--root", root, "--baseline", str(base))
    assert rc == 1 and "no real justification" in out
    for e in doc["entries"]:
        e["justification"] = "a fixture: exercises the placeholder gate"
    base.write_text(json.dumps(doc))
    assert _cli("--root", root, "--baseline", str(base))[0] == 0


def test_cli_json_dump(tmp_path):
    path = tmp_path / "findings.json"
    rc, out = _cli("--json", str(path))
    assert rc == 0, out
    doc = json.loads(path.read_text())
    assert doc["findings"] and all(f["baselined"] for f in doc["findings"])
