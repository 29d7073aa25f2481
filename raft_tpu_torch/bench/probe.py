"""Measure the card's routing artifacts: fused A/B, select_k crossovers, k-pads.

Counterpart of the JAX package's ``tools/pallas_probe.py``,
``tools/select_k_bench.py`` and ``tools/topk_k_probe.py``, in one process.
It writes three artifacts into ``raft_tpu_torch/artifacts/`` (the port's
scanners read them there and never the repo root), each keyed by the
card's name (``ops.select_k.platform_key``) and carrying the card's name
and power limit as ``nvidia-smi`` prints them:

- ``PALLAS_PROBE_cuda.json`` (schema ``raft_tpu.pallas_probe/v3``): per
  routing family, the fused route (``scan_mode="pallas"``: the family's
  hand-written kernel) against its unfused route (the port's torch route,
  ``torch.matmul`` where the JAX package used XLA, then a selection; never
  a kernel's plain version), through the public search entry points at
  1,000,000 x 128 rows (``bench.datagen.low_rank_clusters``), 1,024
  queries (10,000 for brute force), k = 100. ``pallas_ms`` is the fused
  route, ``xla_ms`` the unfused one (the reference's field names), and
  ``fused_wins = agreement >= 0.99 and pallas_ms < xla_ms``, where
  ``agreement`` is the mean share of ids the two routes' rows have in
  common. ``ops.gpu_kernels.fused_dispatch_explained`` reads the verdicts:
  this file decides ``scan_mode="auto"`` on the card. ``ivf_scan`` is the
  scan kernel inside IVF-Flat's unfused route against the gather it
  replaces; ``l2_argmin`` must win at every cluster count of the
  ``fused_l2_argmin`` section. One card writes no ``merge_ring`` row.
- ``SELECT_K_TABLE_cuda.json``: DIRECT against TWO_PHASE over a (width, k)
  grid at batch 2,048, and the per-k-band crossover widths
  ``select_k.set_auto_table`` takes.
- ``TOPK_PAD_cuda.json``: DIRECT's time at each (width, k) of a fine grid,
  and the rules padding a k to a larger k' that takes less than half its
  time.

Usage (on the card; about 5 minutes, most of it the builds):

    python -m raft_tpu_torch.bench.probe [--require-verdicts]
        [--only brute_force,cagra] [--n 1000000] [--out-dir DIR]

``--require-verdicts`` exits 2 unless every routing family has a measured
verdict. Off the card (``--device cpu``, small ``--n``) it runs the plain
versions and writes no verdict: a rehearsal, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from raft_tpu_torch.bench import datagen
from raft_tpu_torch.bench.timing import fence, prepare, time_dispatches
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops import select_k as sk

#: families whose verdicts are the ``scan_mode="auto"`` routing table
REQUIRED_VERDICT_FAMILIES = gk.VERDICT_FAMILIES
PROBE_SCHEMA = "raft_tpu.pallas_probe/v3"


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "" off it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def missing_verdicts(art: dict, on_card: bool) -> list:
    """Routing families whose row is not a measured verdict: absent,
    failed, or taken off the card."""
    if not on_card:
        return list(REQUIRED_VERDICT_FAMILIES)
    fused = art.get("fused", {})
    return [f for f in REQUIRED_VERDICT_FAMILIES
            if not isinstance(fused.get(f), dict)
            or "fused_wins" not in fused[f] or "pallas_error" in fused[f]]


def _overlap(i_a, i_b, rows: int = 2048) -> float:
    """Mean per-row share of ids two results have in common."""
    a = torch.as_tensor(i_a)[:rows].cpu().numpy()
    b = torch.as_tensor(i_b)[:rows].cpu().numpy()
    return float(np.mean([len(np.intersect1d(r, s)) / max(r.shape[0], 1)
                          for r, s in zip(a, b)]))


def _header(platform: str, card: str) -> dict:
    return {"platform": platform, "card": card,
            "when": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "script": "python -m raft_tpu_torch.bench.probe"}


def _write(path: str, art: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def _ms(fn, iters: int) -> float:
    return time_dispatches(fn, iters=iters) * 1e3


def probe_fused(art: dict, dev, n: int, nq: int, k: int, iters: int,
                only, on_card: bool, log=print) -> None:
    """The fused A/B rows (module docstring) into ``art``."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import fused_l2_nn as fl
    from raft_tpu_torch.ops.distance import row_norms_sq

    def want(fam):
        return only is None or fam in only

    rng = np.random.default_rng(0)
    res = Resources(device=dev, seed=0)
    art.setdefault("fused", {})
    art.setdefault("fused_l2_argmin", {})

    if want("l2_argmin"):
        x = prepare(rng.standard_normal((min(n, 100_000), 96)).astype(
            np.float32), dev)
        xn = row_norms_sq(x)
        for n_c in (1024, 8192):
            y = prepare(rng.standard_normal((n_c, 96)).astype(np.float32),
                        dev)
            yn = row_norms_sq(y)
            tile = fl.choose_tile_rows(x.shape[0], n_c,
                                       res.workspace_limit_bytes)

            def run_fused():
                return gk.fused_l2_argmin(x, y, xn, yn, clamp=False,
                                          tile=tile)

            def run_unfused():
                return fl.l2_nn_unfused(x, y, xn, yn, tile)

            row = {}
            try:
                agree = float((run_fused()[1] == run_unfused()[1]).float()
                              .mean())
                row["pallas_ms"] = round(_ms(run_fused, iters), 4)
                row["agreement"] = round(agree, 5)
            except Exception as e:  # a failed kernel is a finding
                row["pallas_error"] = f"{type(e).__name__}: {e}"[:300]
            row["xla_ms"] = round(_ms(run_unfused, iters), 4)
            art["fused_l2_argmin"][f"n_clusters_{n_c}"] = row
            log(f"fused_l2_argmin n_c={n_c}: {row}")
        rows = list(art["fused_l2_argmin"].values())
        art["fused"]["l2_argmin"] = {
            "derived_from": "fused_l2_argmin",
            "fused_wins": bool(on_card and rows and all(
                "pallas_ms" in r and r["pallas_ms"] < r["xla_ms"]
                for r in rows))}
        log(f"fused l2_argmin: {art['fused']['l2_argmin']}")

    if only is None:
        art["select_k"] = {}
        v = prepare(rng.standard_normal((2048, 16384)).astype(np.float32),
                    dev)
        for kk in (10, 32):
            row = {}
            try:
                pv, _ = gk.streaming_select_k(v, kk)
                ev, _ = sk.select_k(v, kk, algo=sk.SelectAlgo.DIRECT)
                row["max_val_err"] = float((pv - ev).abs().max())
                row["pallas_ms"] = round(
                    _ms(lambda: gk.streaming_select_k(v, kk), iters), 4)
            except Exception as e:
                row["pallas_error"] = f"{type(e).__name__}: {e}"[:300]
            row["direct_ms"] = round(_ms(lambda: sk.select_k(
                v, kk, algo=sk.SelectAlgo.DIRECT), iters), 4)
            art["select_k"][f"k_{kk}"] = row
            log(f"select_k k={kk}: {row}")
        del v

    need_db = any(want(f) for f in ("brute_force", "ivf_flat", "ivf_scan",
                                    "ivf_pq", "cagra"))
    if not need_db:
        return
    db = datagen.low_rank_clusters(rng, n, 128, n_centers=1024)
    q_np = db[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal(
        (nq, 128)).astype(np.float32)
    q = prepare(q_np, dev)

    def fused_ab(fam, run_fused, run_unfused, extra=None):
        row = dict(extra or {})
        try:
            fi = run_fused()[1]
            ui = run_unfused()[1]
            row["agreement"] = round(_overlap(fi, ui), 5)
            del fi, ui
            row["pallas_ms"] = round(_ms(run_fused, iters), 4)
            row["xla_ms"] = round(_ms(run_unfused, iters), 4)
            row["fused_wins"] = bool(on_card and row["agreement"] >= 0.99
                                     and row["pallas_ms"] < row["xla_ms"])
            if not on_card:
                row["note"] = "plain versions (no card): not a verdict"
        except Exception as e:
            row["pallas_error"] = f"{type(e).__name__}: {e}"[:300]
            row["fused_wins"] = False
        art["fused"][fam] = row
        log(f"fused {fam}: {row}")

    if want("brute_force"):
        nqb = 10 * nq
        qb = prepare(db[rng.integers(0, n, nqb)] + 0.05 * rng.standard_normal(
            (nqb, 128)).astype(np.float32), dev)
        bf = brute_force.build(db, metric="sqeuclidean", res=res)
        fused_ab("brute_force",
                 lambda: brute_force.search(bf, qb, k, res=res,
                                            scan_mode="pallas"),
                 lambda: brute_force.search(bf, qb, k, res=res,
                                            scan_mode="xla"),
                 extra={"queries": nqb})
        del bf, qb

    if want("ivf_flat") or want("ivf_scan"):
        t0 = time.perf_counter()
        fi = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=1024,
                                                     kmeans_n_iters=10),
                            res=res)
        fence_build = time.perf_counter() - t0
        sp_p = ivf_flat.SearchParams(n_probes=64, scan_mode="pallas")
        sp_x = ivf_flat.SearchParams(n_probes=64, scan_mode="xla")
        sp_a = ivf_flat.SearchParams(n_probes=64, scan_mode="auto")
        if want("ivf_flat"):
            fused_ab("ivf_flat",
                     lambda: ivf_flat.search(fi, q, k, sp_p, res=res),
                     lambda: ivf_flat.search(fi, q, k, sp_x, res=res),
                     extra={"n_probes": 64, "build_s": round(fence_build, 3)})
        if want("ivf_scan"):
            # the scan kernel inside the unfused route against the gather
            # it replaces: auto with the fused verdict off, the scan's on
            # and then off
            key = gk.fused_platform_key(dev)
            saved = dict(gk._load_fused_table().get(key, {}))
            try:
                gk.set_fused_crossover(key, {"ivf_flat": False,
                                             "ivf_scan": True})
                s_i = ivf_flat.search(fi, q, k, sp_a, res=res)[1]
                scan_ms = round(_ms(lambda: ivf_flat.search(
                    fi, q, k, sp_a, res=res), iters), 4)
                gk.set_fused_crossover(key, {"ivf_flat": False,
                                             "ivf_scan": False})
                g_i = ivf_flat.search(fi, q, k, sp_a, res=res)[1]
                gather_ms = round(_ms(lambda: ivf_flat.search(
                    fi, q, k, sp_a, res=res), iters), 4)
                agree = round(_overlap(s_i, g_i), 5)
                row = {"pallas_ms": scan_ms, "xla_ms": gather_ms,
                       "agreement": agree, "n_probes": 64,
                       "fused_wins": bool(on_card and agree >= 0.99
                                          and scan_ms < gather_ms)}
            except Exception as e:
                row = {"pallas_error": f"{type(e).__name__}: {e}"[:300],
                       "fused_wins": False}
            finally:
                gk.set_fused_crossover(key, saved or None)
            art["fused"]["ivf_scan"] = row
            log(f"fused ivf_scan: {row}")
        del fi

    if want("ivf_pq"):
        pq = ivf_pq.build(db, ivf_pq.IndexParams(
            n_lists=1024, pq_dim=64, pq_bits=8, kmeans_n_iters=10), res=res)
        sp_pp = ivf_pq.SearchParams(n_probes=64, scan_mode="pallas")
        sp_pc = ivf_pq.SearchParams(n_probes=64, scan_mode="cache")
        sp_pl = ivf_pq.SearchParams(n_probes=64, scan_mode="lut")
        cache_ms = round(_ms(lambda: ivf_pq.search(pq, q, k, sp_pc, res=res),
                             iters), 4)
        lut_ms = round(_ms(lambda: ivf_pq.search(pq, q, k, sp_pl, res=res),
                           iters), 4)
        sp_u = sp_pc if cache_ms <= lut_ms else sp_pl
        fused_ab("ivf_pq",
                 lambda: ivf_pq.search(pq, q, k, sp_pp, res=res),
                 lambda: ivf_pq.search(pq, q, k, sp_u, res=res),
                 extra={"cache_ms": cache_ms, "lut_ms": lut_ms,
                        "n_probes": 64,
                        "fused_engine": ivf_pq.plan_search(
                            pq, k, sp_pp, res=res).engine})
        del pq

    if want("cagra"):
        t0 = time.perf_counter()
        cg = cagra.build(db, cagra.IndexParams(), res=res)
        fence(cg.graph)
        build_s = time.perf_counter() - t0
        cg_p = cagra.SearchParams(scan_mode="pallas")
        cg_x = cagra.SearchParams(scan_mode="xla")
        itopk, width, max_iter, n_seeds = cagra.resolve_search_plan(
            cg_p, k, cg.size)
        seeds = cagra.seed_table(cg_p, nq, cg.size, n_seeds, cg.device)
        fused_ab("cagra",
                 lambda: cagra.search(cg, q, k, cg_p, res=res, seeds=seeds),
                 lambda: cagra.search(cg, q, k, cg_x, res=res, seeds=seeds),
                 extra={"itopk": itopk, "search_width": width,
                        "max_iter": max_iter, "n_seeds": n_seeds,
                        "graph_degree": cg.graph_degree,
                        "build_s": round(build_s, 3)})
        del cg


def probe_select_k(dev, batch: int, widths, ks, iters: int, log=print):
    """DIRECT and TWO_PHASE at each (width, k); the crossovers in
    ``set_auto_table``'s form (``tools/select_k_bench.py``'s banding)."""
    rng = np.random.default_rng(0)
    grid = []
    for n in widths:
        x = prepare(rng.standard_normal((batch, n)).astype(np.float32), dev)
        for k in ks:
            if k * 4 > n:
                continue
            row = {"n": n, "k": k}
            for algo in (sk.SelectAlgo.DIRECT, sk.SelectAlgo.TWO_PHASE):
                row[algo.value + "_ms"] = round(_ms(
                    lambda: sk.select_k(x, k, algo=algo, pad_rules=False),
                    iters), 4)
            grid.append(row)
            log(f"select_k grid {row}")
        del x

    by_k = {}
    for k in ks:
        cross = None
        for r in sorted((r for r in grid if r["k"] == k),
                        key=lambda r: r["n"]):
            wins = r["two_phase_ms"] < r["direct_ms"]
            if wins and cross is None:
                cross = r["n"]
            if not wins:
                cross = None  # must win from here up
        by_k[k] = cross
    bands = {}
    small = [c for kk, c in by_k.items() if kk <= 32]
    mid = [c for kk, c in by_k.items() if 32 < kk <= 256]
    if small and all(small):
        bands["32"] = max(small)
    if mid and all(mid):
        bands["256"] = max(mid)
    if by_k.get(max(by_k)):
        bands["inf"] = by_k[max(by_k)]
    return grid, {str(k): v for k, v in by_k.items()}, \
        bands or {"inf": 1 << 62}


def probe_pad(dev, batch: int, widths, ks, iters: int, log=print):
    """DIRECT's time at each (width, k); the rules padding k to a larger
    measured k' that takes less than half the time (``topk_k_probe``)."""
    rng = np.random.default_rng(0)
    grid = []
    for n in widths:
        x = prepare(rng.standard_normal((batch, n)).astype(np.float32), dev)
        row = {"n": n, "ms": {}}
        for k in ks:
            if k * 4 > n:
                continue
            row["ms"][str(k)] = round(_ms(lambda: sk.select_k(
                x, k, algo=sk.SelectAlgo.DIRECT, pad_rules=False), iters), 4)
        grid.append(row)
        log(f"topk pad grid {row}")
        del x
    rules = []
    for row in grid:
        ms = {int(k): v for k, v in row["ms"].items()}
        for k in sorted(ms):
            better = [(ms[kp], kp) for kp in ms if kp > k
                      and ms[kp] < ms[k] / 2]
            if better:
                best = min(better)
                rules.append({"n": row["n"], "k": k, "k_pad": best[1],
                              "ms": ms[k], "ms_pad": best[0]})
    return grid, rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.bench.probe", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out-dir", default=sk.ARTIFACT_DIR)
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' rehearses")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database rows of the fused A/B")
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2048,
                    help="rows of the select_k and k-pad grids")
    ap.add_argument("--widths", type=int, nargs="*",
                    default=[4096, 16384, 32768, 65536, 131072, 262144])
    ap.add_argument("--ks", type=int, nargs="*",
                    default=[10, 32, 64, 128, 256])
    ap.add_argument("--pad-widths", type=int, nargs="*",
                    default=[1024, 2048, 4096, 6144, 8192, 16384, 32768])
    ap.add_argument("--pad-ks", type=int, nargs="*",
                    default=[4, 8, 10, 12, 16, 24, 32, 40, 48, 64])
    ap.add_argument("--only", default=None,
                    help="comma-separated fused families to (re)measure; "
                         "the other rows carry over from the existing "
                         "artifact, and the select_k and pad grids are "
                         "left as they are")
    ap.add_argument("--require-verdicts", action="store_true",
                    help="exit 2 unless every routing family has a measured "
                         "verdict")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("probe: no CUDA device (pass --device cpu to rehearse)",
              file=sys.stderr)
        return 1
    only = (set(s.strip() for s in args.only.split(",") if s.strip())
            if args.only else None)
    platform = sk.platform_key(dev)
    card = card_line()
    suffix = "cuda" if on_card else "cpu"
    os.makedirs(args.out_dir, exist_ok=True)
    log = lambda m: print(m, flush=True)  # noqa: E731
    if on_card:
        gk.build_all()

    path = os.path.join(args.out_dir, f"PALLAS_PROBE_{suffix}.json")
    art = {"schema": PROBE_SCHEMA, **_header(platform, card),
           "shapes": {"rows": args.n, "dim": 128, "queries": args.nq,
                      "k": args.k}}
    if only is not None and os.path.exists(path):
        with open(path) as f:
            base = json.load(f)
        for sec in ("fused_l2_argmin", "select_k", "fused"):
            if isinstance(base.get(sec), dict):
                art[sec] = base[sec]
    probe_fused(art, dev, args.n, args.nq, args.k, args.iters, only,
                on_card, log)
    flat = {}

    def _flatten(prefix, d):
        for key, val in d.items():
            if isinstance(val, dict):
                _flatten(f"{prefix}{key}.", val)
            elif isinstance(val, (int, float)) and not isinstance(val, bool):
                flat[f"{prefix}{key}"] = val

    for section in ("fused_l2_argmin", "select_k", "fused"):
        _flatten(f"{section}.", art.get(section, {}))
    art["metrics"] = flat
    _write(path, art)
    log(f"-> {path}")

    if only is None:
        grid, by_k, bands = probe_select_k(dev, args.batch, args.widths,
                                           args.ks, args.iters, log)
        sel_path = os.path.join(args.out_dir, f"SELECT_K_TABLE_{suffix}.json")
        _write(sel_path, {**_header(platform, card), "batch": args.batch,
                          "grid": grid, "crossover_by_k": by_k,
                          "crossovers": bands})
        log(f"-> {sel_path} crossovers: {bands}")
        grid, rules = probe_pad(dev, args.batch, args.pad_widths,
                                args.pad_ks, args.iters, log)
        pad_path = os.path.join(args.out_dir, f"TOPK_PAD_{suffix}.json")
        _write(pad_path, {**_header(platform, card), "batch": args.batch,
                          "grid": grid, "pad_rules": rules})
        log(f"-> {pad_path} rules: {rules}")

    if args.require_verdicts:
        missing = missing_verdicts(art, on_card)
        if missing:
            print(f"probe: REQUIRED VERDICTS MISSING: {missing}",
                  file=sys.stderr)
            return 2
        log(f"probe: all required verdicts present "
            f"({len(REQUIRED_VERDICT_FAMILIES)} families)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
