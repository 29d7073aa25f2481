"""``chip_smoke.py`` phase 6f: measured dispatch and the adaptive planner.

On the card, over the main path's data (1,000,000 x 128 rows):

- **probe**: the committed ``raft_tpu_torch/artifacts/PALLAS_PROBE_cuda.json``
  loaded, each routing family's verdict printed beside its fused and
  unfused ms;
- **routing**: each family's ``scan_mode="auto"`` resolves to the route its
  verdict implies (reason ``auto_fused_wins``, ``fused_loses`` or
  ``no_fused_wins_verdict``; ``ivf_scan`` inside the filtered IVF-Flat
  route), and the ``auto`` result is bitwise the forced route's on the same
  call;
- **padding**: with a pad rule armed for the card, a padded ``select_k`` is
  bitwise the unpadded one (the measured ``TOPK_PAD_cuda.json`` has no rule
  to arm: no pad won the 2x bar);
- **sweep**: ``planner.sweep`` over the five families at ks (10,) and
  buckets (8, 16, 32, 64), written as ``PARETO_cuda.json`` under ``root``;
  every point's ``roofline_min_ms`` at most its ``predicted_ms``;
- **planner**: the swept IVF-Flat and IVF-PQ indexes served behind
  ``Engine(EngineConfig(planner=AdaptivePlanner.from_artifact(...)))`` to 8
  submitters, half the requests with a tight ``deadline_ms``: 0 builds
  after ``start()``, 0 of 256 sampled requests differing from
  ``solo_reference`` at the params their batch was served with, no choice
  below the planner's recall floor, the choices counted by reason.

Rehearse it on the CPU by calling :func:`phase` with a small dataset, the
module's size constants patched down and ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["phase", "routing", "padding", "sweep", "planner"]

SWEEP_KS, SWEEP_BUCKETS, SWEEP_QUERIES, SWEEP_REPS = (10,), (8, 16, 32, 64), \
    256, 3
#: served requests per family, submitter threads, sampled requests held
#: against solo_reference
PLAN_REQUESTS, PLAN_THREADS, PLAN_SAMPLE = 4096, 8, 256
ROUTE_QUERIES, K = 1024, 10


def _bitwise(a, b) -> bool:
    return (torch.equal(a[0].contiguous().view(torch.int32),
                        b[0].contiguous().view(torch.int32))
            and torch.equal(a[1], b[1]))


def _expected_reason(verdict) -> str:
    if verdict is None:
        return "no_fused_wins_verdict"
    return "auto_fused_wins" if verdict else "fused_loses"


def routing(*, dev, queries, dataset, bf, flat, flat_probes, pq_index,
            pq_probes, card_res, cg_index, cg_itopk, filt,
            emit: Callable) -> Dict[str, dict]:
    """The committed verdicts, and each family's ``auto`` route held
    bitwise to the forced route it implies. Returns the probe rows."""
    from raft_tpu_torch.bench.probe import REQUIRED_VERDICT_FAMILIES
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import fused_l2_nn as fl
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops import select_k as sk
    from raft_tpu_torch.ops.distance import row_norms_sq

    path = os.path.join(sk.ARTIFACT_DIR, "PALLAS_PROBE_cuda.json")
    with open(path) as f:
        art = json.load(f)
    key = sk.platform_key(dev)
    verdicts = {fam: gk._fused_verdict(fam, dev)
                for fam in REQUIRED_VERDICT_FAMILIES}
    rows = {fam: {k: v for k, v in art["fused"].get(fam, {}).items()
                  if k in ("pallas_ms", "xla_ms", "agreement", "fused_wins")}
            for fam in REQUIRED_VERDICT_FAMILIES}
    emit({"phase": "dispatch_probe", "artifact_card": art.get("card"),
          "artifact_when": art.get("when"), "platform_key": key,
          "verdicts": verdicts, "rows": rows})
    if art.get("platform") != key:
        raise AssertionError(f"the probe artifact is {art.get('platform')}'s,"
                             f" this card is {key}")
    missing = [f for f, v in verdicts.items() if v is None]
    if missing:
        raise AssertionError(f"no measured verdict for {missing}")

    q = queries[:ROUTE_QUERIES]
    out = {}

    def check(fam, run, forced_mode, reason, expect):
        a, b = run("auto"), run(forced_mode)
        same = _bitwise(a[:2], b[:2])
        out[fam] = {"verdict": verdicts[fam], "auto_reason": reason,
                    "forced": forced_mode, "bitwise": same}
        if reason != expect:
            raise AssertionError(f"{fam}: auto's reason {reason}, its "
                                 f"verdict implies {expect}")
        if not same:
            raise AssertionError(f"{fam}: auto's result differs from the "
                                 f"{forced_mode} route's")

    def fam_reason(fam, run):
        return run("auto", True)[2].reason

    # brute force
    def run_bf(mode, explain=False):
        return brute_force.search(bf, q, K, scan_mode=mode, explain=explain)
    v = verdicts["brute_force"]
    check("brute_force", run_bf, "pallas" if v else "xla",
          fam_reason("brute_force", run_bf), _expected_reason(v))

    # IVF-Flat
    def run_flat(mode, explain=False):
        return ivf_flat.search(flat, q, K, ivf_flat.SearchParams(
            n_probes=flat_probes, scan_mode=mode), explain=explain)
    v = verdicts["ivf_flat"]
    check("ivf_flat", run_flat, "pallas" if v else "xla",
          fam_reason("ivf_flat", run_flat), _expected_reason(v))

    # ivf_scan: the filtered IVF-Flat route (never fused), the scan kernel
    # under auto only on a winning verdict
    def run_filt(mode, explain=False):
        return ivf_flat.search(flat, q, K, ivf_flat.SearchParams(
            n_probes=flat_probes, scan_mode=mode), filter=filt,
            explain=explain)
    v = verdicts["ivf_scan"]
    rec = run_filt("auto", True)[2]
    check("ivf_scan", run_filt, "pallas" if v else "xla",
          "auto_fused_wins" if rec.plan["unfused_ivf_scan"] else
          "fused_loses", _expected_reason(v))

    # IVF-PQ, cache regime (the card's memory picks it)
    def run_pq(mode, explain=False):
        if mode == "xla":
            mode = "cache"
        return ivf_pq.search(pq_index, q, K, ivf_pq.SearchParams(
            n_probes=pq_probes, scan_mode=mode), res=card_res,
            explain=explain)
    v = verdicts["ivf_pq"]
    check("ivf_pq", run_pq, "pallas" if v else "xla",
          fam_reason("ivf_pq", run_pq), _expected_reason(v))

    # CAGRA, with one seed table for both routes
    sp = cagra.SearchParams(itopk_size=cg_itopk, search_width=1)
    n_seeds = cagra.resolve_search_plan(sp, K, cg_index.size)[3]
    seeds = cagra.seed_table(sp, q.shape[0], cg_index.size, n_seeds, dev)

    def run_cg(mode, explain=False):
        return cagra.search(cg_index, q, K, cagra.SearchParams(
            itopk_size=cg_itopk, search_width=1, scan_mode=mode),
            seeds=seeds, explain=explain)
    v = verdicts["cagra"]
    check("cagra", run_cg, "pallas" if v else "xla",
          fam_reason("cagra", run_cg), _expected_reason(v))

    # the 1-NN: fused_l2_nn_argmin against the route its verdict implies
    x = dataset[:100_000]
    y = dataset[::1000][:1024].contiguous()
    a = fl.fused_l2_nn_argmin(x, y, res=card_res)
    tile = fl.choose_tile_rows(x.shape[0], y.shape[0],
                               card_res.workspace_limit_bytes)
    xn, yn = row_norms_sq(x), row_norms_sq(y)
    v = verdicts["l2_argmin"]
    b = gk.fused_l2_argmin(x, y, xn, yn, clamp=False, tile=tile) if v \
        else fl.l2_nn_unfused(x, y, xn, yn, tile)
    same = _bitwise(a, b)
    out["l2_argmin"] = {"verdict": v, "forced": "kernel" if v else
                        "unfused", "bitwise": same}
    if not same:
        raise AssertionError("l2_argmin: auto's result differs from the "
                             "route its verdict implies")
    emit({"phase": "dispatch_routing", "queries": ROUTE_QUERIES,
          "families": out})
    return rows


def padding(*, dev, flat, queries, emit: Callable) -> None:
    """A padded selection bitwise the unpadded one, on the coarse scores
    of the IVF-Flat probes; the measured rules are restored after."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import select_k as sk

    key = sk.platform_key(dev)
    measured = [dict(r) for r in sk._load_pad_rules().get(key, [])]
    table = sk._load_auto_table().get(key)
    scores, _ = ivf_flat._coarse_scores(queries.to(torch.float32),
                                        flat.centers, flat.metric)
    n = scores.shape[1]
    sk.set_pad_rules(key, [{"n": n, "k": K, "k_pad": 32}])
    try:
        plan = sk.select_k_plan(n, K, device=dev)
        padded = sk.select_k(scores, K)
        plain = sk.select_k(scores, K, pad_rules=False)
    finally:
        sk.set_pad_rules(key, measured or None)
    same = _bitwise(padded, plain)
    emit({"phase": "dispatch_padding", "rows": list(scores.shape), "k": K,
          "plan": plan, "bitwise": same, "measured_pad_rules": measured,
          "select_k_table": table})
    if plan["k_pad"] != 32 or not same:
        raise AssertionError("a padded select_k differs from the unpadded "
                             "one (or the armed rule did not apply)")


def sweep(*, dev, dataset, queries, root: Path, emit: Callable,
          seed: int = 0, card: str = ""):
    """The five families swept at the main path's rows; returns the
    frontier artifact's path and the IVF-Flat and IVF-PQ searchers it
    measured."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.ops import select_k as sk
    from raft_tpu_torch.planner import sweep as psweep

    res = Resources(device=dev, seed=seed)
    db = dataset.cpu().numpy()
    evq = queries[:SWEEP_QUERIES].cpu().numpy()
    families, searchers, shapes = {}, {}, {}
    t0 = time.perf_counter()
    for fam in psweep.FAMILIES:
        tb = time.perf_counter()
        built = psweep.build_searcher(fam, db, res)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - tb
        ts = time.perf_counter()
        families[fam] = psweep.sweep_family(
            fam, db, evq, SWEEP_KS, SWEEP_BUCKETS, res=res, reps=SWEEP_REPS,
            built=built)
        families[fam]["build_s"] = round(build_s, 3)
        searchers[fam], shapes[fam] = built
        emit({"phase": "sweep", "family": fam, "build_s": build_s,
              "sweep_s": time.perf_counter() - ts,
              "shape": families[fam]["shape"],
              "n_swept": families[fam]["n_swept"],
              "frontier": families[fam]["frontier"]})
        for fam_k in families[fam]["frontier"].values():
            for b, pts in fam_k.items():
                for p in pts:
                    rl = p.get("roofline_min_ms")
                    if rl is not None and not rl <= p["predicted_ms"]:
                        raise AssertionError(
                            f"sweep {fam} b={b} {p['params']}: roofline "
                            f"{rl} ms > predicted {p['predicted_ms']} ms")
    doc = psweep.build_artifact(
        sk.platform_key(dev), families,
        config={"rows": int(db.shape[0]), "dim": int(db.shape[1]),
                "nq": SWEEP_QUERIES, "ks": list(SWEEP_KS),
                "buckets": list(SWEEP_BUCKETS), "reps": SWEEP_REPS,
                "seed": seed, "mini": False, "card": card,
                "script": "chip_smoke.py phase 6f"})
    root.mkdir(parents=True, exist_ok=True)
    path = root / "PARETO_cuda.json"
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    if psweep.check_artifact(str(path)) != 0:
        raise AssertionError("the swept frontier does not check")
    emit({"phase": "sweep_total", "seconds": time.perf_counter() - t0,
          "path": str(path), "metrics": doc["metrics"]})
    return path, searchers, db


def planner(*, dev, path: Path, searchers, db, queries, gt_i, emit: Callable,
            seed: int = 0) -> Dict[str, int]:
    """IVF-Flat and IVF-PQ served behind a planner to PLAN_THREADS
    submitters, half the requests with a tight deadline. Returns the
    kernels' launches of the loads."""
    from raft_tpu_torch import serving
    from raft_tpu_torch.bench.serve_load import BatchSink, closed_loop, \
        summarize
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.planner import adaptive
    from raft_tpu_torch.stats import neighborhood_recall

    frontier = adaptive.load_frontier(str(path))
    q_host = queries[:PLAN_REQUESTS].cpu().numpy()
    gt = gt_i[:PLAN_REQUESTS]
    rng = np.random.default_rng(seed)
    launches: Dict[str, int] = {name: 0 for name in gk.LAUNCHES}
    for fam in ("ivf_flat", "ivf_pq"):
        searcher = searchers[fam]
        recalls = sorted({p.recall for b in (8, 16, 32, 64)
                          for p in frontier.points(fam, K, b)})
        floor = recalls[len(recalls) // 2]
        fast = min(p.predicted_ms for p in frontier.points(fam, K, 64))
        # tight: the flush wait plus twice the fastest point's batch time
        tight = 2.0 + 2.0 * fast
        deadlines = [tight if j % 2 else None for j in range(PLAN_REQUESTS)]
        plan = adaptive.AdaptivePlanner.from_artifact(str(path),
                                                      recall_floor=floor)
        sink = BatchSink()
        before = adaptive.adaptive_choice_counts()
        t0 = time.perf_counter()
        eng = serving.Engine(searcher, serving.EngineConfig(
            max_batch=64, max_wait_us=2000, max_inflight=2, warm_ks=(K,),
            span_sink=sink, planner=plan))
        eng.start()
        start_s = time.perf_counter() - t0
        try:
            builds0 = serving.compile_count()
            gk.reset_launch_counts()
            run = closed_loop(eng, q_host, K, PLAN_THREADS,
                              deadlines_ms=deadlines)
            for name, n in gk.LAUNCHES.items():
                launches[name] += n
            batches = sink.take()
            builds = serving.compile_count() - builds0
        finally:
            eng.stop()
        after = adaptive.adaptive_choice_counts()
        choices = {r: after.get((fam, r), 0) - before.get((fam, r), 0)
                   for r in sorted(adaptive.ADAPTIVE_REASONS)}
        by_bucket: Dict[str, Dict[str, int]] = {}
        for rec in batches:
            ad = rec.get("adaptive") or {}
            key = json.dumps(ad.get("params"), sort_keys=True)
            cell = by_bucket.setdefault(str(rec["bucket"]), {})
            cell[key] = cell.get(key, 0) + 1
        served = np.flatnonzero(~run["shed"])
        sample = rng.choice(served, min(PLAN_SAMPLE, len(served)),
                            replace=False)
        mismatches = serving.verify_bit_identity(
            searcher, [q_host[j] for j in sample],
            [(run["distances"][j], run["ids"][j]) for j in sample], K,
            [run["placements"][j] for j in sample],
            [run["params"][j] for j in sample])
        point_recall = {json.dumps(p.params, sort_keys=True): p.recall
                        for b in (8, 16, 32, 64)
                        for p in frontier.points(fam, K, b)}
        below = sum(1 for j in served
                    if point_recall.get(json.dumps(run["params"][j],
                                                   sort_keys=True),
                                        1.0) < floor)
        recall = float(neighborhood_recall(
            torch.from_numpy(run["ids"][served]).to(gt.device),
            gt[torch.from_numpy(served).to(gt.device)]))
        line = summarize(run, batches)
        emit({"phase": "planner_serving", "family": fam,
              "submitters": PLAN_THREADS, **line,
              "start_s": start_s, "warmup": eng.warmup_info,
              "builds_after_start": builds, "recall_floor": floor,
              "tight_deadline_ms": tight, "shed": int(run["shed"].sum()),
              "choices_by_reason": choices, "params_by_bucket": by_bucket,
              "below_floor": below, "solo_mismatches": mismatches,
              "solo_sampled": len(sample), "recall_at_10": recall,
              "calibration_scale": plan.calibration.scale,
              "calibration_observed": plan.calibration.n_observed})
        if builds:
            raise AssertionError(f"planner {fam}: {builds} kernel builds "
                                 "after start()")
        if mismatches:
            raise AssertionError(f"planner {fam}: {mismatches} rows differ "
                                 "from solo_reference at their params")
        if below:
            raise AssertionError(f"planner {fam}: {below} requests served "
                                 f"below the recall floor {floor}")
        if sum(choices.values()) < 1 or choices.get("no_frontier"):
            raise AssertionError(f"planner {fam}: choices {choices}")
    return launches


def phase(*, smi, dev, seed, dataset, queries, gt_i, bf, flat, flat_probes,
          pq_index, pq_probes, card_res, cg_index, cg_itopk, filt,
          emit: Callable, root: Path) -> Dict[str, int]:
    """Phase 6f. Returns the launches of its served loads."""
    t0 = time.perf_counter()
    routing(dev=dev, queries=queries, dataset=dataset, bf=bf, flat=flat,
            flat_probes=flat_probes, pq_index=pq_index, pq_probes=pq_probes,
            card_res=card_res, cg_index=cg_index, cg_itopk=cg_itopk,
            filt=filt, emit=emit)
    padding(dev=dev, flat=flat, queries=queries, emit=emit)
    path, searchers, db = sweep(dev=dev, dataset=dataset, queries=queries,
                                root=root, emit=emit, seed=seed, card=smi)
    launches = planner(dev=dev, path=path, searchers=searchers, db=db,
                       queries=queries, gt_i=gt_i, emit=emit, seed=seed)
    emit({"phase": "planning_total", "card": smi,
          "seconds": time.perf_counter() - t0, "launches": launches})
    return launches

