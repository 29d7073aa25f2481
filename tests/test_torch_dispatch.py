"""Measured dispatch: the port's crossover gate and select_k artifacts
against raft_tpu's.

- ``gpu_kernels.fused_dispatch_explained`` on a CUDA device gives raft_tpu's
  ``(use_fused, reason)`` on a TPU for every (family, verdict ∈ {True,
  False, none}, scan_mode); raft_tpu is made to believe it runs on a TPU by
  patching ``jax.default_backend`` (the package is not edited). The
  sharded merge's ``auto`` follows the ``merge_ring`` verdict the same way.
  On the CPU every family keeps its fused route through the plain
  versions, whatever verdict is installed;
- ``select_k._resolve_auto`` and ``_pad_k`` equal raft_tpu's over an
  (n, k) grid with one table and one set of pad rules installed in both
  under ``"cpu"``;
- artifacts load from ``raft_tpu_torch/artifacts`` and through the env
  override; a malformed artifact is skipped; the committed card artifacts
  hold a measured verdict for every routing family and name the card;
- a padded selection is bitwise the unpadded one, and raft_tpu's.
"""

import importlib
import json
import logging
import os

import numpy as np
import pytest
import torch

from raft_tpu.ops import pallas_kernels as pk
from raft_tpu.parallel import sharded as jsharded
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.ops import fused_l2_nn
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops import select_k as tsel
from raft_tpu_torch.parallel import sharded as tsharded

jsel = importlib.import_module("raft_tpu.ops.select_k")

FAMILIES = ("brute_force", "ivf_flat", "ivf_pq", "ivf_scan", "l2_argmin",
            "cagra")
CUDA = torch.device("cuda", 0)


@pytest.fixture
def on_tpu(monkeypatch):
    """raft_tpu believes it runs on a TPU; both packages' verdict tables
    are restored afterwards."""
    monkeypatch.setattr(pk.jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("RAFT_TPU_PALLAS_INTERPRET", raising=False)
    saved_t = gk._fused_table_cache
    saved_j = pk._fused_table_cache
    gk._fused_table_cache = None
    yield
    gk._fused_table_cache = saved_t
    pk._fused_table_cache = saved_j
    gk._reset_fused_warn()
    pk._reset_fused_warn()


def _install(family, verdict):
    rows = {} if verdict is None else {family: verdict}
    pk.set_fused_crossover("tpu", rows)
    gk.set_fused_crossover(tsel.platform_key(CUDA), rows)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("verdict", [True, False, None])
@pytest.mark.parametrize("scan_mode", ["auto", "pallas", "xla"])
def test_gate_matches_jax_on_the_card(on_tpu, family, verdict, scan_mode):
    _install(family, verdict)
    pk._reset_fused_warn()
    gk._reset_fused_warn()
    j_fused, _, j_reason = pk.fused_dispatch_explained(family, scan_mode)
    t_fused, t_reason = gk.fused_dispatch_explained(family, scan_mode, CUDA)
    assert (t_fused, t_reason) == (j_fused, j_reason)
    want = bool(verdict) if scan_mode == "auto" else scan_mode == "pallas"
    assert t_fused == want
    assert gk.fused_crossover(family, CUDA) == pk.fused_crossover(family)
    assert gk._fused_verdict(family, CUDA) == pk._fused_verdict(family)


def test_missing_verdict_warns_once(on_tpu, caplog):
    _install("ivf_flat", None)
    gk._reset_fused_warn()
    with caplog.at_level(logging.WARNING, logger=gk.__name__):
        for fam in FAMILIES:
            assert gk.fused_dispatch_explained(fam, "auto", CUDA) == (
                False, "no_fused_wins_verdict")
    warnings = [r for r in caplog.records if "PALLAS_PROBE" in r.message]
    assert len(warnings) == 1
    assert "raft_tpu_torch.bench.probe" in warnings[0].message


@pytest.mark.parametrize("verdict", [True, False, None])
@pytest.mark.parametrize("mode", ["auto", "tree", "ring", "allgather"])
def test_merge_dispatch_follows_the_ring_verdict(on_tpu, monkeypatch,
                                                 verdict, mode):
    _install("merge_ring", verdict)
    # the port's verdict lookup with no device: the card this host lacks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tsel, "_card_name", lambda i: "cuda")
    for size in (2, 4, 3):
        if mode == "tree" and size == 3:
            continue
        t = tsharded.merge_dispatch_explained(mode, size, all_cpu=False)
        j = jsharded.merge_dispatch_explained(mode, size)
        assert t[:2] == j[:2], (mode, size)
        assert t[2] == ("kernel" if j[2] == "pallas" else j[2])
    # every rank on the CPU: the port's documented tree, whatever the verdict
    assert tsharded.merge_dispatch_explained("auto", 4, all_cpu=True) == (
        "tree", "merge_tree", "")


def test_cpu_routing_ignores_verdicts(on_tpu):
    """On the CPU the fused routes run the plain versions whatever the
    card's verdicts say (reason ``auto_fused``), as before the gate."""
    cpu = torch.device("cpu")
    for fam in FAMILIES:
        gk.set_fused_crossover("cpu", {fam: False})
        assert gk.fused_dispatch_explained(fam, "auto", cpu) == (
            True, "auto_fused")
        assert gk.fused_dispatch_explained(fam, "pallas", cpu) == (
            True, "forced")
        assert gk.fused_crossover(fam, cpu)
    rng = np.random.default_rng(0)
    db = rng.standard_normal((600, 16)).astype(np.float32)
    q = db[:8] + 0.01
    res = Resources(device="cpu", seed=0)
    bf = brute_force.build(db, res=res)
    *_, rec = brute_force.search(bf, q, 5, explain=True)
    assert (rec.engine, rec.reason) == ("pallas", "auto_fused")
    fi = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=8), res=res)
    *_, rec = ivf_flat.search(fi, q, 5, explain=True)
    assert (rec.engine, rec.reason) == ("pallas", "auto_fused")
    *_, rec = ivf_flat.search(fi, q, 5, ivf_flat.SearchParams(
        scan_mode="xla"), explain=True)
    assert (rec.engine, rec.reason) == ("xla", "forced")
    pq = ivf_pq.build(db, ivf_pq.IndexParams(n_lists=8, pq_dim=8), res=res)
    plan = ivf_pq.plan_search(pq, 5, res=res)
    assert (plan.engine, plan.reason) == ("pallas_cache", "auto_fused")
    cg = cagra.build(db, cagra.IndexParams(graph_degree=16,
                                           intermediate_graph_degree=32),
                     res=res)
    sp = cagra.plan_search(cg, 5, cagra.SearchParams())
    assert (sp.engine, sp.reason) == ("pallas", None)
    *_, rec = cagra.search(cg, q, 5, explain=True)
    assert (rec.engine, rec.reason) == ("pallas", "auto_fused")
    *_, rec = cagra.search(cg, q, 5, cagra.SearchParams(scan_mode="pallas"),
                           explain=True)
    assert rec.reason == "forced"


def test_unfused_routes_match_forced_routes_on_the_cpu():
    """The routes a losing verdict sends ``auto`` to on the card, run here:
    the 1-NN's unfused route equals its kernel's plain version, and
    ``ivf_scan_routed`` names the scan kernel only where it may serve."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((300, 24)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((70, 24)).astype(np.float32))
    xn, yn = (x * x).sum(1), (y * y).sum(1)
    v_u, i_u = fused_l2_nn.l2_nn_unfused(x, y, xn, yn, 64)
    v_k, i_k = gk.fused_l2_argmin_plain(x, y, xn, yn)
    assert torch.equal(i_u, i_k)
    torch.testing.assert_close(v_u, v_k, rtol=1e-5, atol=1e-4)
    cpu = torch.device("cpu")
    assert ivf_flat.ivf_scan_routed("pallas", cpu)
    assert ivf_flat.ivf_scan_routed("auto", cpu)
    assert not ivf_flat.ivf_scan_routed("xla", cpu)
    assert not ivf_flat.ivf_scan_routed("cache", cpu)


# ------------------------------------------------------------ select_k

_TABLE = {"two_phase": {"32": 8192, "256": 20000, "inf": 65536},
          "screen": {"16": 2048}}
_RULES = [{"n": 4096, "k": 10, "k_pad": 32}, {"n": 2000, "k": 7, "k_pad": 7},
          {"n": 16384, "k": 8, "k_pad": 16}, {"n": 5000, "k": 8,
                                              "k_pad": 12}]


@pytest.fixture
def cpu_tables():
    jsel.set_auto_table("cpu", _TABLE)
    jsel.set_pad_rules("cpu", _RULES)
    tsel.set_auto_table("cpu", _TABLE)
    tsel.set_pad_rules("cpu", _RULES)
    yield
    tsel.set_auto_table("cpu", None)
    tsel.set_pad_rules("cpu", None)
    jsel._auto_table_cache = None
    jsel._pad_rules_cache = None


@pytest.mark.parametrize("n", [30, 1000, 2000, 2400, 3300, 4096, 5000,
                               8192, 16384, 20000, 70000, 200000])
def test_resolve_auto_and_pad_k_match_jax(cpu_tables, n):
    for k in (1, 7, 8, 10, 16, 17, 32, 33, 100, 256, 300):
        for floating in (True, False):
            assert tsel._resolve_auto(n, k, floating, "cpu").name == \
                jsel._resolve_auto(n, k, floating).name, (n, k, floating)
        assert tsel._pad_k(n, k, "cpu") == jsel._pad_k(n, k), (n, k)


def test_padded_selection_is_bitwise_unpadded(cpu_tables):
    rng = np.random.default_rng(5)
    v = rng.standard_normal((6, 4096)).astype(np.float32)
    v[:, ::97] = v[:, :1]  # ties across the k-th value
    assert tsel.select_k_plan(4096, 10, device="cpu") == {
        "algo": "SCREEN", "k_pad": 32}
    t = torch.from_numpy(v)
    padded = tsel.select_k(t, 10, algo=tsel.SelectAlgo.DIRECT)
    plain = tsel.select_k(t, 10, algo=tsel.SelectAlgo.DIRECT, pad_rules=False)
    assert torch.equal(padded[0].view(torch.int32), plain[0].view(torch.int32))
    assert torch.equal(padded[1], plain[1])
    want = jsel.select_k(v, 10, algo=jsel.SelectAlgo.DIRECT)
    np.testing.assert_array_equal(padded[1].numpy(), np.asarray(want[1]))


def _art(tmp, name, doc):
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(doc if isinstance(doc, str) else json.dumps(doc))
    return path


def test_artifacts_load_and_env_override_wins(tmp_path, monkeypatch):
    d = str(tmp_path)
    _art(d, "SELECT_K_TABLE_good.json",
         {"platform": "cpu", "crossovers": {"inf": 4096}})
    _art(d, "SELECT_K_TABLE_bad.json", "{not json")
    _art(d, "TOPK_PAD_good.json", {"platform": "cpu", "pad_rules": [
        {"n": 4096, "k": 10, "k_pad": 16}]})
    _art(d, "TOPK_PAD_bad.json", {"no_platform": 1})
    _art(d, "PALLAS_PROBE_good.json", {"platform": "cuda", "fused": {
        "brute_force": {"fused_wins": True}, "cagra": {"fused_wins": False},
        "note": "not a row"}})
    _art(d, "PALLAS_PROBE_bad.json", "[]")
    monkeypatch.setattr(tsel, "ARTIFACT_DIR", d)
    monkeypatch.setattr(tsel, "_AUTO_TABLES", None)
    monkeypatch.setattr(tsel, "_PAD_RULES", None)
    monkeypatch.setattr(gk, "_fused_table_cache", None)
    monkeypatch.delenv("RAFT_TPU_TORCH_SELECTK_TABLE", raising=False)
    monkeypatch.delenv("RAFT_TPU_TORCH_TOPK_PAD", raising=False)
    monkeypatch.delenv("RAFT_TPU_TORCH_PALLAS_PROBE", raising=False)
    assert tsel._load_auto_table()["cpu"] == {"inf": 4096}
    assert tsel._pad_k(4096, 10, "cpu") == 16
    assert tsel._INSTALLED  # the host's own platform has a table
    assert gk._load_fused_table() == {"cuda": {"brute_force": True,
                                               "cagra": False}}
    assert gk._fused_verdict("brute_force", CUDA) is True
    assert gk._fused_verdict("ivf_flat", CUDA) is None
    # the override is loaded last, and wins
    over = _art(str(tmp_path), "override.json",
                {"platform": "cpu", "crossovers": {"inf": 1 << 62}})
    monkeypatch.setenv("RAFT_TPU_TORCH_SELECTK_TABLE", over)
    monkeypatch.setattr(tsel, "_AUTO_TABLES", None)
    assert tsel._load_auto_table()["cpu"] == {"inf": 1 << 62}
    # a malformed override fails loudly
    monkeypatch.setenv("RAFT_TPU_TORCH_TOPK_PAD",
                       _art(str(tmp_path), "o2.json", "{"))
    monkeypatch.setattr(tsel, "_PAD_RULES", None)
    with pytest.raises(ValueError):
        tsel._load_pad_rules()


def test_platform_key_keeps_cpu():
    assert tsel.platform_key("cpu") == "cpu"
    assert tsel.platform_key(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_available():
        assert tsel.platform_key() == "cpu"
        assert tsel.platform_key(CUDA) == "cuda"
    assert gk.fused_platform_key("cpu") == "cpu"


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ARTS = os.path.join(_REPO, "raft_tpu_torch", "artifacts")


def test_committed_card_artifacts_are_measured():
    """The artifacts measured on the card: a verdict for every routing
    family, the card's name and power limit, a crossover table and pad
    rules in the forms the loaders take, the swept frontier; nothing at the
    repo root."""
    with open(os.path.join(_ARTS, "PALLAS_PROBE_cuda.json")) as f:
        probe = json.load(f)
    assert probe["schema"] == "raft_tpu.pallas_probe/v3"
    assert probe["platform"].startswith("NVIDIA")
    assert probe["card"].startswith(probe["platform"]) and " W" in \
        probe["card"]
    from raft_tpu_torch.bench import probe as bprobe
    assert bprobe.missing_verdicts(probe, on_card=True) == []
    for fam in FAMILIES:
        assert isinstance(probe["fused"][fam]["fused_wins"], bool)
    assert gk._extract_fused_table(probe).keys() >= set(FAMILIES)
    with open(os.path.join(_ARTS, "SELECT_K_TABLE_cuda.json")) as f:
        table = json.load(f)
    assert table["platform"] == probe["platform"]
    assert tsel._band(table["crossovers"], 10) is not None
    with open(os.path.join(_ARTS, "TOPK_PAD_cuda.json")) as f:
        pads = json.load(f)
    assert pads["platform"] == probe["platform"]
    for r in pads["pad_rules"]:
        assert r["k_pad"] > r["k"]
    # the frontier the card's sweep measured: every family of the sweep,
    # a valid monotone curve at each served bucket
    from raft_tpu_torch.planner import adaptive, sweep
    path = os.path.join(_ARTS, "PARETO_cuda.json")
    frontier = adaptive.load_frontier(path)
    assert frontier.platform == probe["platform"]
    assert frontier.doc["config"]["card"] == probe["card"]
    assert frontier.families == sorted(sweep.FAMILIES)
    for fam in frontier.families:
        for b in (8, 16, 32, 64):
            assert frontier.points(fam, 10, b)[0].bucket == b
    assert sweep.check_artifact(path) == 0
    for name in os.listdir(_REPO):
        assert not (name.endswith("_cuda.json")), name
