"""The port's adaptive planner against raft_tpu's.

- ``pareto_prune``, ``choose_operating_point``, ``hypervolume``,
  ``qps_at_recall``, ``frontier_metrics`` and ``Calibration`` give
  raft_tpu's answers on the same seeded points (the property checks of
  ``tests/test_adaptive.py``, run through both packages; exact equality:
  both are the same host arithmetic);
- a frontier written by either package loads in the other;
- ``planner.sweep``: brute force swept at ``mini=True`` has recall 1.0, and
  ``_roofline_min_ms`` equals raft_tpu's under the same peaks (exact);
- the engine with a planner serves, per request, rows bitwise equal to a
  solo ``search_with`` at the params its batch was served with; a raising
  planner degrades to the static params.
"""

import json

import numpy as np
import pytest
import torch

from raft_tpu.planner import adaptive as jad
from raft_tpu.planner import sweep as jsweep
from raft_tpu_torch import serving
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.obs import costs
from raft_tpu_torch.planner import adaptive as tad
from raft_tpu_torch.planner import sweep as tsweep

SEEDS = list(range(8))


def _points(mod, seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        out.append(mod.OperatingPoint(
            params={"n_probes": int(rng.integers(1, 128)), "j": j},
            bucket=int(rng.choice([8, 16, 64])),
            qps=float(np.round(rng.uniform(10, 5000), 1)),
            recall=float(np.round(rng.uniform(0.5, 1.0), 3)),
            predicted_ms=float(np.round(rng.uniform(0.1, 50.0), 3)),
            roofline_min_ms=float(rng.uniform(0.01, 0.1))))
    # a tie on (recall, qps) that the prune must collapse
    out.append(_with(out[0], mod, params={"tie": 1}))
    return out


def _with(p, mod, **kw):
    d = p.to_dict()
    d.update(kw)
    return mod.OperatingPoint.from_dict(d)


def _dicts(points):
    return [p.to_dict() for p in points]


@pytest.mark.parametrize("seed", SEEDS)
def test_pareto_prune_and_summaries_match_jax(seed):
    tp, jp = _points(tad, seed), _points(jad, seed)
    t_front, j_front = tad.pareto_prune(tp), jad.pareto_prune(jp)
    assert _dicts(t_front) == _dicts(j_front)
    # monotone: recall strictly down, qps strictly up
    for a, b in zip(t_front, t_front[1:]):
        assert a.recall > b.recall and a.qps < b.qps
    assert tad.hypervolume(tp) == jad.hypervolume(jp)
    for band in tad.RECALL_BANDS:
        assert tad.qps_at_recall(tp, band) == jad.qps_at_recall(jp, band)
    doc = {"schema": tad.PARETO_SCHEMA, "platform": "cpu", "families": {
        "ivf_flat": {"frontier": {"10": {"8": _dicts(t_front)}}}}}
    assert tad.frontier_metrics(doc) == jad.frontier_metrics(doc)


@pytest.mark.parametrize("seed", SEEDS)
def test_choose_operating_point_matches_jax(seed):
    tp, jp = _points(tad, seed), _points(jad, seed)
    rng = np.random.default_rng(100 + seed)
    budgets = [None, -1.0, 0.0] + list(np.round(rng.uniform(0, 60, 12), 3))
    floors = [None, 0.6, 0.8, 0.95, 1.01]
    for budget in budgets:
        for floor in floors:
            for scale in (0.25, 1.0, 2.5):
                tpt, treason = tad.choose_operating_point(tp, budget, floor,
                                                          scale)
                jpt, jreason = jad.choose_operating_point(jp, budget, floor,
                                                          scale)
                assert treason == jreason, (budget, floor, scale)
                assert treason in tad.ADAPTIVE_REASONS
                assert tpt.to_dict() == jpt.to_dict()
    assert tad.choose_operating_point([], 5.0) == (None, "no_frontier")


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_calibration_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tc, jc = tad.Calibration(alpha=0.3), jad.Calibration(alpha=0.3)
    for pred, act in rng.uniform(-1, 20, (40, 2)):
        tc.observe(float(pred), float(act))
        jc.observe(float(pred), float(act))
        assert tc.scale == jc.scale and tc.n_observed == jc.n_observed
    assert 0.25 <= tc.scale <= 4.0


def test_reasons_and_schema_are_shared():
    assert tad.ADAPTIVE_REASONS == jad.ADAPTIVE_REASONS
    assert tad.PARETO_SCHEMA == jad.PARETO_SCHEMA == "raft_tpu.pareto/v1"
    from raft_tpu_torch.obs import explain
    assert tad.ADAPTIVE_REASONS <= explain.REASONS


def test_frontier_crosses_both_ways(tmp_path):
    tp = tad.pareto_prune(_points(tad, 3))
    fams = {"ivf_flat": {"frontier": {"10": {"8": _dicts(tp),
                                             "64": _dicts(tp[:2])}}},
            "cagra": {"frontier": {"10": {"16": _dicts(tp[1:])}}}}
    t_doc = tsweep.build_artifact("NVIDIA H100 80GB HBM3", fams,
                                  config={"rows": 1})
    j_doc = jsweep.build_artifact("tpu", fams, config={"rows": 1})
    assert t_doc["metrics"] == j_doc["metrics"]
    for doc, name in ((t_doc, "t.json"), (j_doc, "j.json")):
        path = tmp_path / name
        path.write_text(json.dumps(doc))
        tf, jf = tad.load_frontier(str(path)), jad.load_frontier(str(path))
        assert tf.families == jf.families == ["cagra", "ivf_flat"]
        for fam in tf.families:
            for b in (None, 8, 12, 64, 100):
                assert _dicts(tf.points(fam, 10, b)) == \
                    _dicts(jf.points(fam, 10, b))
    assert tsweep.check_artifact(str(tmp_path / "j.json")) == 0
    bad = dict(t_doc, schema="other/v0")
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError):
        tad.load_frontier(str(tmp_path / "bad.json"))
    assert tsweep.check_artifact(str(tmp_path / "bad.json")) == 1


def test_sweep_mini_brute_force_and_roofline():
    rng = np.random.default_rng(0)
    from raft_tpu_torch.bench import datagen
    db = datagen.low_rank_clusters(rng, 2000 + 32, 16)
    db, q = db[:2000], db[2000:]
    res = Resources(device="cpu", seed=0)
    out = tsweep.sweep_family("brute_force", db, q, [5], [8], res=res,
                              reps=1, mini=True)
    pts = out["frontier"]["5"]["8"]
    assert pts and all(p["recall"] == 1.0 for p in pts)
    assert all(p.get("roofline_min_ms") is None for p in pts)  # no peaks
    assert out["shape"] == {"rows": 2000, "dim": 16}
    # the roofline floor: the reference's rule under the same peaks
    peaks = costs.H100_PEAKS
    shape = {"rows": 1_000_000, "dim": 128, "n_lists": 128, "pq_dim": 32}
    for fam in ("brute_force", "ivf_flat", "ivf_pq", "tiered_ivf_pq",
                "cagra"):
        for params in ({}, {"n_probes": 4}, {"n_probes": 64},
                       {"n_probes": 500}):
            for b in (8, 64):
                got = tsweep._roofline_min_ms(fam, params, shape, b, peaks)
                want = jsweep._roofline_min_ms(fam, params, shape, b, peaks)
                assert got == pytest.approx(want, rel=1e-12, abs=0), \
                    (fam, params, b)
    assert tsweep.default_grid("cagra") == jsweep.default_grid("cagra")
    for fam in tsweep.FAMILIES:
        assert tsweep.default_grid(fam, mini=True) == \
            jsweep.default_grid(fam, mini=True)
    oracle = tsweep.exact_oracle(db, q, 5)
    np.testing.assert_array_equal(oracle, jsweep.exact_oracle(db, q, 5))


# ------------------------------------------------------------ the engine

DIM, K = 16, 5


@pytest.fixture(scope="module")
def flat_searcher():
    rng = np.random.default_rng(7)
    from raft_tpu_torch.bench import datagen
    db = datagen.low_rank_clusters(rng, 3000, DIM)
    index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=32),
                           res=Resources(device="cpu", seed=1))
    return serving.ivf_flat_searcher(index), db


def _frontier(points_params, bucket=4):
    pts = [tad.OperatingPoint(params=p, bucket=bucket, qps=q, recall=r,
                              predicted_ms=ms)
           for p, q, r, ms in points_params]
    doc = {"schema": tad.PARETO_SCHEMA, "platform": "cpu", "families": {
        "ivf_flat": {"frontier": {str(K): {str(bucket): [
            p.to_dict() for p in pts]}}}}}
    return tad.Frontier(doc)


def _serve(eng, queries, deadlines):
    futs = [eng.submit(q, K, deadline_ms=d) for q, d in zip(queries,
                                                          deadlines)]
    return futs, [f.result(timeout=60) for f in futs]


def test_engine_with_planner_serves_search_with_bitwise(flat_searcher):
    s, db = flat_searcher
    # a generous point that cannot fit a tight deadline, a cheap one that
    # can: the tight riders' batches degrade
    frontier = _frontier([({"n_probes": 16}, 100.0, 0.99, 1e6),
                          ({"n_probes": 2}, 1000.0, 0.90, 1e-6)])
    planner = tad.AdaptivePlanner(frontier, recall_floor=0.85)
    before = tad.adaptive_choice_counts()
    cfg = serving.EngineConfig(max_batch=4, max_wait_us=500,
                               warm_ks=(K,), warm_buckets=(1, 2, 4),
                               hang_timeout_s=None, planner=planner)
    rng = np.random.default_rng(3)
    queries = (db[rng.integers(0, len(db), 24)]
               + 0.01 * rng.standard_normal((24, DIM))).astype(np.float32)
    deadlines = [None if j % 2 else 60_000.0 for j in range(24)]
    with serving.Engine(s, cfg) as eng:
        assert eng.warmup_info["compiles"] == 0
        futs, results = _serve(eng, queries, deadlines)
    params = [f.params for f in futs]
    assert all(p in ({"n_probes": 16}, {"n_probes": 2}) for p in params)
    assert {"n_probes": 2} in params  # batches with a deadline: degraded
    bad = serving.verify_bit_identity(
        s, queries, results, K, [f.placement for f in futs], params)
    assert bad == 0
    # and against the solo search at the static params where they differ
    after = tad.adaptive_choice_counts()
    served = sum(after.get(("ivf_flat", r), 0)
                 - before.get(("ivf_flat", r), 0)
                 for r in tad.ADAPTIVE_REASONS)
    assert served >= 1
    # every frontier point was warmed: the engine's warm-up searched it
    for f, q in zip(futs, queries):
        row, bucket = f.placement
        d, i = serving.solo_reference(s, q, K, row, bucket, f.params)
        qq = np.zeros((bucket, DIM), np.float32)
        qq[row] = q
        dw, iw = s.search_with(torch.from_numpy(qq), K, f.params)
        assert np.array_equal(i, iw[row].numpy())
        assert np.array_equal(d.view(np.int32),
                              dw[row].numpy().view(np.int32))


class _Raising:
    def warm_points(self, family, k, bucket):
        return []

    def choose(self, *a, **kw):
        raise RuntimeError("planner down")

    def observe(self, *a):
        raise AssertionError("no choice, nothing to observe")


def test_raising_planner_degrades_to_static_params(flat_searcher):
    s, db = flat_searcher
    cfg = serving.EngineConfig(max_batch=4, max_wait_us=500,
                               warm_ks=(K,), warm_buckets=(1, 2, 4),
                               hang_timeout_s=None, planner=_Raising())
    queries = db[:6].astype(np.float32)
    with serving.Engine(s, cfg) as eng:
        futs, results = _serve(eng, queries, [5_000.0] * 6)
    assert all(f.params is None for f in futs)
    assert serving.verify_bit_identity(
        s, queries, results, K, [f.placement for f in futs]) == 0


def test_search_with_overrides_and_typed_errors(flat_searcher):
    s, db = flat_searcher
    q = torch.from_numpy(db[:4].astype(np.float32))
    a = s.search_with(q, K, {"n_probes": 8})
    b = ivf_flat.search(s.index, q, K, ivf_flat.SearchParams(n_probes=8))
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    assert torch.equal(s.search(q, K)[1], s.search_with(q, K, {})[1])
    with pytest.raises(TypeError):
        s.search_with(q, K, {"nprobe": 8})
    from raft_tpu_torch.neighbors import brute_force
    bs = serving.brute_force_searcher(
        brute_force.build(db[:500], res=Resources(device="cpu")))
    with pytest.raises(TypeError, match="no knob"):
        bs.search_with(q, K, {"n_probes": 2})
    got = bs.search_with(q, K, {"scan_mode": "xla"})
    want = brute_force.search(bs.index, q, K, scan_mode="xla")
    assert torch.equal(got[1], want[1])
