"""Phase 6e of ``chip_smoke.py``: the write path and the tiers on the card.

``phase(...)`` drives, at the first configuration's full width (1,000,000 ×
128 rows, 10,000 queries, k=10):

- ``mutable``: phase 4's IVF-Flat as the base of a ``MutableIvf`` under
  ``build/``; 20,000 adds (ids from 1,000,000), 10,000 upserts of base ids
  and 10,000 deletes in calls of 64 rows; acknowledged rows/s and ack
  p50/p99; recall@10 against the exact search of the live set, and every
  returned distance the distance to its id's live row (no deleted or
  superseded copy); one manual compaction (timed; the live ids equal);
  checkpoint, close and reopen searching bitwise; a child writer (this
  module run as ``python -m raft_tpu_torch.bench.write_tiers child ...``)
  killed with SIGKILL mid-stream and mid-compaction, its recovery bitwise
  a never-crashed writer fed the acknowledged prefix;
- ``mutable_variants``: an inner-product IVF-Flat base (``ivf_scan``) and
  an IVF-PQ base in the LUT regime (``fused_pq_topk``), each with writes,
  held to the exact search of its live set;
- ``mutable_serving``: the writer served to 8 submitters (the first 3,000
  queries) while a writer thread streams and a background ``Compactor``
  publishes; then 256
  sampled requests against ``solo_reference`` and the builds after
  ``start()``;
- ``tiered``: phase 5's IVF-PQ demoted to pinned host memory behind a
  512-slot arena (``solve_host_tier``'s prediction of its bytes asserted),
  the first 3,000 queries searched in chunks of 16, each bitwise the
  resident cache search; 2,000 served at ``max_batch=16`` with and without
  the prefetcher; a
  ``save_tiered``/``load_tiered`` round trip searching bitwise;
- ``ooc``: the rows written as an fbin under ``build/``, IVF-Flat and
  IVF-PQ built from it (timed), every id once, recall at 32 probes.

It returns the kernels line's new rows: ``fused_ivf_topk`` over the arena
slabs at bucket 16 (against its plain version, and bitwise the resident
kernel's call) and ``select_k`` at the mutable merge's shape. Every file
goes under ``root`` and is deleted at the end.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.obs import costs as obs_costs

K = 10
WRITE_BATCH = 64
N_ADDS, N_UPSERTS, N_DELETES = 20_000, 10_000, 10_000
ADD_ID0 = 1_000_000
KILL_OPS, KILL_ID0 = 240, 3_000_000
#: the writes while the writer is served, and those of each variant base
#: (adds, upserts, deletes). The variants take 192 upserts and 192 deletes,
#: not the main line's mix: ``MutableIvf.search`` over-fetches the base by
#: the masked rows rounded up to a power of two, so past 512 masked rows
#: ``k_fetch`` exceeds ``gk.MAX_K`` (1024) and a mutable IVF-PQ base leaves
#: ``fused_pq_topk`` for the unfused LUT engine in plain PyTorch (as the JAX
#: package leaves its Pallas kernel). 384 masked rows keep the variant on
#: the kernel; the cutoff itself stands in ROADMAP Queue B.
SERVE_WRITES, VARIANT_WRITES = (8192, 2048, 2048), (1280, 192, 192)
#: the served writer's compactor: the Compactor's default trigger
SERVE_DELTA_THRESHOLD = 4096
TIER_SLOTS, TIER_CHUNK, TIER_SERVE_QUERIES = 512, 16, 2000
#: queries of the served writer's load and of the tiered chunks held
#: bitwise to the resident search (the first ones of the phase's queries)
SERVE_QUERIES, TIER_QUERIES = 3000, 3000
SERVE_SUBMITTERS, SERVE_SAMPLE, OOC_PROBES = 8, 256, 32


def _kill_ops(seed: int, n_base: int, dim: int, n_ops: int = KILL_OPS):
    """The child's seeded stream of 64-row writes: adds of new ids, upserts
    and deletes of base ids (each base id touched at most once)."""
    rng = np.random.default_rng(seed)
    touched = rng.choice(n_base, n_ops * WRITE_BATCH, replace=False)
    ops, next_id = [], KILL_ID0
    for i in range(n_ops):
        kind = ("add", "upsert", "delete")[i % 3]
        if kind == "add":
            ids = np.arange(next_id, next_id + WRITE_BATCH, dtype=np.int32)
            next_id += WRITE_BATCH
        else:
            ids = touched[i * WRITE_BATCH:(i + 1) * WRITE_BATCH].astype(
                np.int32)
        vecs = None if kind == "delete" else rng.standard_normal(
            (WRITE_BATCH, dim)).astype(np.float32)
        ops.append((kind, ids, vecs))
    return ops


def _k_fetch(c) -> int:
    """The base candidates ``MutableIvf.search`` fetches for k = K: K plus
    a power-of-two slack for the masked base rows (at most 1024)."""
    slack = min(1 << (c.masked_base - 1).bit_length(), 1024) \
        if c.masked_base else 0
    return min(K + slack, c.base_rows)


def _apply(writer, op):
    kind, ids, vecs = op
    if kind == "add":
        return writer.add(vecs, ids=ids)
    if kind == "upsert":
        return writer.upsert(vecs, ids)
    return writer.delete(ids)


def _child(directory: str, seed: int, mode: str, device: str,
           n_ops: int) -> None:
    """The victim: restore the writer on ``device``, stream the seeded ops,
    print ``ACK <lsn>`` after each durable write (``COMPACTING`` when a
    compaction starts in mode ``compact``), then park until killed."""
    from raft_tpu_torch.neighbors import mutable

    torch.backends.cuda.matmul.allow_tf32 = False
    w = mutable.MutableIvf(directory, device=device)
    n_base = int(w.stats()["base_rows"])
    comp = mutable.Compactor(w) if mode == "compact" else None
    print(f"OPEN {w.applied_lsn}", flush=True)
    for i, op in enumerate(_kill_ops(seed, n_base, w.dim, n_ops)):
        _apply(w, op)
        print(f"ACK {w.applied_lsn}", flush=True)
        if comp is not None and i == 20:
            threading.Thread(target=comp.run_once, args=("manual",),
                             daemon=True).start()
            print("COMPACTING", flush=True)
    print("DONE", flush=True)
    while True:
        time.sleep(1)


def _run_victim(directory: str, seed: int, mode: str, after: int,
                repo: Path, device) -> dict:
    """Run the child on ``directory`` and SIGKILL it ``after`` acks (after
    the compaction started, in mode ``compact``). Returns the acks seen."""
    env = dict(os.environ, PYTHONPATH=str(repo))
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch.bench.write_tiers", "child",
         directory, str(seed), mode, str(device), str(KILL_OPS)],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(repo))
    acked, opened, compacting, seen = 0, None, False, 0
    t0 = time.perf_counter()
    try:
        for line in proc.stdout:
            if line.startswith("OPEN"):
                opened = int(line.split()[1])
            elif line.startswith("ACK"):
                acked = int(line.split()[1])
                seen += 1
                if (mode == "plain" and seen >= after) or (
                        compacting and seen >= after):
                    break
            elif line.startswith("COMPACTING"):
                compacting, seen = True, 0
            elif line.startswith("DONE"):
                break
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=120)
    if opened is None or acked == 0:
        raise AssertionError(f"the {mode} child wrote nothing: "
                             f"{proc.stderr.read()[-3000:]}")
    return {"opened_lsn": opened, "acked_lsn": acked,
            "child_seconds": time.perf_counter() - t0,
            "compaction_started": compacting}


def phase(*, smi, dev, seed, dataset, queries, gt_i, flat, flat_probes,
          pq_index, pq_probes, lut_res, lut_probes, ip_index, ip_data,
          ip_queries, ip_probes, launch_counts, emit, timed, cuda_ms,
          graph_ms, bound, replaces, root: Path, repo: Path,
          fbin: Optional[Path] = None):
    """Phase 6e (module docstring). Returns (kernel rows, launches of the
    whole phase by kernel). ``fbin``: where the streamed builds' file of
    the rows goes, kept for a later phase (by default under ``root``,
    deleted with it)."""
    from raft_tpu_torch import native, serving
    from raft_tpu_torch.bench.serve_load import (BatchSink, closed_loop,
                                                 summarize)
    from raft_tpu_torch.core.resources import Resources, solve_host_tier
    from raft_tpu_torch.neighbors import (brute_force, ivf_flat, ivf_pq,
                                          mutable, ooc, tiered)
    from raft_tpu_torch.obs import metrics as om
    from raft_tpu_torch.obs import spans as ospans
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops.select_k import select_k_filtered
    from raft_tpu_torch.serving.stats import percentiles
    from raft_tpu_torch.stats import neighborhood_recall
    from raft_tpu_torch.testing import assert_topk_close

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n_rows, dim = dataset.shape
    nq = queries.shape[0]
    total = {name: 0 for name in gk.LAUNCHES}
    rows_out = []
    rng = np.random.default_rng(seed + 13)

    def step(name):
        """Launch counts of one main-path step (``name``): set to 0 just
        before it, read by ``read(name)`` just after it. References and
        kernel checks run outside every such window, so ``total`` holds the
        main path's launches alone."""
        gk.reset_launch_counts()

    def read(name):
        counts = launch_counts()
        for key in total:
            total[key] += counts[key]
        return counts

    def add_counts(acc, counts):
        """Sum one window's counts into ``acc`` (select_k's by shape too)."""
        for key, n in counts.items():
            if isinstance(n, dict):
                add_counts(acc.setdefault(key, {}), n)
            else:
                acc[key] = acc.get(key, 0) + n
        return acc

    def bitwise(a, b) -> bool:
        return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
                and torch.equal(a[1], b[1]))

    def live_truth(base_rows, edits, metric, qs):
        """Exact top-k of the live set: the base rows minus the deleted and
        superseded ids, plus the delta rows. Returns (ids [nq, K] in row
        ids, the live ids, the live rows)."""
        alive = torch.ones(base_rows.shape[0], dtype=torch.bool, device=dev)
        gone = [int(i) for i in edits["dead_base"]]
        alive[torch.tensor(gone, dtype=torch.int64, device=dev)] = False
        keep = torch.nonzero(alive).flatten()
        delta_ids = np.fromiter(edits["delta"].keys(), np.int64)
        delta_rows = torch.from_numpy(np.stack(
            [edits["delta"][int(i)] for i in delta_ids])).to(dev)
        live_rows = torch.cat([base_rows[keep], delta_rows])
        live_ids = torch.cat([keep, torch.from_numpy(delta_ids).to(dev)])
        bf = brute_force.build(live_rows, metric=metric, device=dev)
        _, pos = brute_force.search(bf, qs, K)
        return live_ids[pos.long()], live_ids, live_rows

    def stream(writer, n_add, n_up, n_del, base_n, id0, make_rows, edits,
               lat=None):
        """Interleaved adds, upserts and deletes in calls of 64 rows;
        upserted and deleted ids are distinct base ids. Returns the rows
        written."""
        touched = rng.choice(base_n, n_up + n_del, replace=False)
        by_kind = {"add": np.arange(id0, id0 + n_add, dtype=np.int64),
                   "upsert": touched[:n_up], "delete": touched[n_up:]}
        n_calls = -(-max(n_add, n_up, n_del) // WRITE_BATCH)
        rows = 0
        for c in range(n_calls):
            for kind in ("add", "upsert", "delete"):
                ids = by_kind[kind][c * WRITE_BATCH:(c + 1) * WRITE_BATCH]
                if not len(ids):
                    continue
                ids = ids.astype(np.int32)
                vecs = None if kind == "delete" else make_rows(len(ids))
                t0 = time.perf_counter()
                _apply(writer, (kind, ids, vecs))
                if lat is not None:
                    lat.append(time.perf_counter() - t0)
                rows += len(ids)
                if edits is None:
                    continue
                for j, id_ in enumerate(ids.tolist()):
                    if kind == "delete":
                        edits["delta"].pop(id_, None)
                        edits["dead_base"].add(id_)
                    else:
                        edits["delta"][id_] = vecs[j]
                        if kind == "upsert":
                            edits["dead_base"].add(id_)
        return rows

    def near_rows(base_rows, scale_noise, unit=False):
        def make(n):
            pick = torch.from_numpy(rng.integers(0, base_rows.shape[0], n))
            r = base_rows[pick.to(dev)].float().cpu().numpy()
            r = r + scale_noise * rng.standard_normal(r.shape).astype(
                np.float32)
            if unit:
                r /= np.linalg.norm(r, axis=1, keepdims=True)
            return r.astype(np.float32)
        return make

    # ------------------------------------------------------------ mutable
    sink = ospans.ListSink()
    mdir = root / "mutable"
    w = mutable.MutableIvf(str(mdir), base=flat, device=dev,
                           index_params=ivf_flat.IndexParams(
                               n_lists=flat.n_lists),
                           search_params=ivf_flat.SearchParams(
                               n_probes=flat_probes),
                           registry=om.Registry(), span_sink=sink,
                           name="smoke")
    edits = {"delta": {}, "dead_base": set()}
    lat: list = []
    noise = float(dataset[:1000].std())
    step("mutable_writes")
    t0 = time.perf_counter()
    rows = stream(w, N_ADDS, N_UPSERTS, N_DELETES, n_rows, ADD_ID0,
                  near_rows(dataset, 0.1 * noise), edits, lat)
    write_s = time.perf_counter() - t0
    wlaunch = read("mutable_writes")
    truth, live_ids, live_rows = live_truth(dataset, edits, "sqeuclidean",
                                            queries)
    dead = edits["dead_base"] - set(edits["delta"])
    step("mutable")
    (v, i), search_s = timed(lambda: w.search(queries, K))
    mlaunch = read("mutable")
    recall = float(neighborhood_recall(i, truth))
    # every returned distance is its id's live row's: no superseded copy
    order = torch.argsort(live_ids)
    pos = torch.searchsorted(live_ids[order], i.long().clamp_min(0))
    got_rows = live_rows[order[pos.clamp_max(len(order) - 1)]]
    exact = ((queries[:, None, :] - got_rows) ** 2).sum(-1)
    scale = float((live_rows * live_rows).sum(1).max())
    stale = int(((v - exact).abs() > 1e-4 * scale + 1e-5 * exact).sum())
    bad_dead = bool(torch.isin(i.long(), torch.tensor(
        sorted(dead), dtype=torch.int64, device=dev)).any())
    stats = w.stats()
    lat_ms = percentiles([x * 1e3 for x in lat], (50.0, 99.0))
    c = w._snapshot()
    k_fetch = _k_fetch(c)
    delta_s = timed(lambda: mutable._delta_distances(
        queries, c.rows, w.metric, w.res.workspace_limit_bytes))[1]
    base_s = timed(lambda: ivf_flat.search(
        flat, queries, k_fetch, w.search_params))[1]
    # select_k at the mutable merge's shape: the base candidates after the
    # tombstone filter, then the delta's distances, as MutableIvf.search
    bv, bi = ivf_flat.search(c.base, queries, k_fetch, w.search_params)
    bv, bi, _ = select_k_filtered(bv, K, bi, c.words, pad_rules=False)
    dv = mutable._delta_distances(queries, c.rows, w.metric)
    dv = torch.where((c.ids >= 0)[None, :], dv, torch.inf)
    merge = torch.cat([bv, dv], dim=1).contiguous()
    got = gk.streaming_select_k(merge, K)
    want = gk._stable_topk(merge, K)
    if not bitwise(got, want):
        raise AssertionError("select_k at the mutable merge's shape is not "
                             "its plain version")
    n = merge.shape[1]
    # the main path's launches at this shape, from its search alone
    merge_launches = mlaunch["select_k_shapes"].get(f"select_k:{n}:{K}", 0)
    rows_out.append(dict(
        name="select_k", route="cuda", source="raft_tpu_torch/csrc/select_k.cu",
        replaces=replaces["select_k"],
        shape=f"mutable merge [{nq} x {n}] ({K} filtered base candidates "
              f"of {k_fetch} + the delta's cap {c.cap}), k={K}",
        launches=merge_launches, agrees_with_plain=True,
        max_abs_err=0.0, bitwise=True,
        ms=graph_ms(lambda: gk.streaming_select_k(merge, K), 5),
        ms_eager=cuda_ms(lambda: gk.streaming_select_k(merge, K), 5),
        plain_ms=cuda_ms(lambda: gk._stable_topk(merge, K), 1),
        library_ms=graph_ms(lambda: torch.topk(merge, K, largest=False), 5),
        parent_ms=None, ab_ms=None,
        **bound(*obs_costs.select_k_work(nq, n, K, False))))
    emit({"phase": "kernel_check", **rows_out[-1]})
    del merge, dv

    line = {"phase": "mutable", "card": smi, "rows_written": rows,
            "write_calls": len(lat), "write_seconds": write_s,
            "acked_rows_per_s": rows / sum(lat),
            "ack_p50_ms": lat_ms["p50"],
            "ack_p99_ms": lat_ms["p99"], **stats, "delta_cap": c.cap,
            "search_seconds": search_s, "qps": nq / search_s,
            "k_fetch": k_fetch, "base_search_k_fetch_seconds": base_s,
            "delta_scan_seconds": delta_s, "recall_at_10": recall,
            "stale_distances": stale, "deleted_returned": bad_dead,
            "write_launches": wlaunch, "launches": mlaunch}
    # one manual compaction of the ~1.01M live rows
    step("compaction")
    live_before = w.live_ids()
    comp = mutable.Compactor(w)
    outcome, comp_s = timed(lambda: comp.run_once("manual"))
    claunch = read("compaction")
    live_after = w.live_ids()
    (v2, i2), search2_s = timed(lambda: w.search(queries, K))
    recall2 = float(neighborhood_recall(i2, truth))
    line.update(compaction_outcome=outcome, compaction_seconds=comp_s,
                compaction_span_s=sink.by_kind("compaction")[-1][
                    "duration_s"],
                live_ids_equal=bool(np.array_equal(live_before, live_after)),
                compacted_recall_at_10=recall2,
                compacted_search_seconds=search2_s,
                compaction_launches=claunch)
    # checkpoint → close → reopen: the search bitwise
    _, ckpt_s = timed(w.checkpoint)
    before = w.search(queries, K)
    w.close()
    (w,), reopen_s = timed(lambda: (mutable.MutableIvf(
        str(mdir), search_params=ivf_flat.SearchParams(n_probes=flat_probes),
        registry=om.Registry(), device=dev),))
    after = w.search(queries, K)
    line.update(checkpoint_seconds=ckpt_s, reopen_seconds=reopen_s,
                checkpoint_bytes=os.path.getsize(w.checkpoint_path),
                reopen_bitwise=bitwise(before, after))
    emit(line)
    if recall < 0.90 or recall2 < 0.90:
        raise AssertionError(f"mutable recall {recall} / {recall2} < 0.90")
    if bad_dead or stale:
        raise AssertionError(f"mutable: a deleted id ({bad_dead}) or "
                             f"{stale} superseded distances returned")
    if outcome != "ok" or not line["live_ids_equal"]:
        raise AssertionError(f"compaction {outcome}, live ids equal "
                             f"{line['live_ids_equal']}")
    if not line["reopen_bitwise"]:
        raise AssertionError("the reopened writer searches differently")
    # the base search takes the fused kernel up to k_fetch 1024, and
    # ivf_scan above it (as raft_tpu's takes its XLA path)
    if merge_launches < 1 or mlaunch[
            "fused_ivf_topk" if k_fetch <= gk.MAX_K else "ivf_scan"] < 1:
        raise AssertionError(f"the mutable search's launches: {mlaunch}")

    # kill -9: mid-stream, then mid-compaction
    w.close()
    kill_line = {"phase": "mutable_kill9", "card": smi}
    q_kill = queries[:1000]
    for mode, after_acks in (("plain", 60), ("compact", 3)):
        victim, pristine = root / f"victim_{mode}", root / f"oracle_{mode}"
        shutil.copytree(mdir, victim)
        shutil.copytree(mdir, pristine)
        info = _run_victim(str(victim), seed + 7, mode, after_acks, repo,
                           dev)
        rec = mutable.MutableIvf(str(victim), device=dev,
                                 registry=om.Registry())
        oracle = mutable.MutableIvf(str(pristine), device=dev,
                                    registry=om.Registry())
        n_base = int(oracle.stats()["base_rows"])
        applied = rec.applied_lsn
        for op in _kill_ops(seed + 7, n_base, dim, KILL_OPS)[
                :applied - info["opened_lsn"]]:
            _apply(oracle, op)
        # the compaction of mode "compact" takes seconds and the kill comes
        # a few acks after it starts: a landed one means the kill missed
        landed = not torch.equal(rec.base.centers, oracle.base.centers)
        same_live = bool(np.array_equal(rec.live_ids(), oracle.live_ids()))
        sp = ivf_flat.SearchParams(n_probes=flat_probes)
        rec.search_params = oracle.search_params = sp
        searches_bitwise = bitwise(rec.search(q_kill, K),
                                   oracle.search(q_kill, K))
        kill_line[mode] = {**info, "recovered_applied_lsn": applied,
                           "recovery": rec.recovery["status"],
                           "compaction_landed": landed,
                           "live_ids_equal": same_live,
                           "searches_bitwise": searches_bitwise}
        rec.close()
        oracle.close()
        shutil.rmtree(victim)
        shutil.rmtree(pristine)
        if applied < info["acked_lsn"] or not same_live \
                or not searches_bitwise or landed:
            emit(kill_line)
            raise AssertionError(f"kill -9 ({mode}) recovery differs: "
                                 f"{kill_line[mode]}")
    emit(kill_line)

    # ---------------------------------------------------- mutable variants
    variants = {"phase": "mutable_variants", "card": smi}
    for name, base, family, res, probes, qs, base_rows, metric, floor, \
            unit, id0, kernel in (
                ("inner_product", ip_index, "ivf_flat", None, ip_probes,
                 ip_queries, ip_data, "inner_product", 0.90, True, 2_000_000,
                 "ivf_scan"),
                ("ivf_pq_lut", pq_index, "ivf_pq", lut_res, lut_probes,
                 queries, dataset, "sqeuclidean", 0.80, False, 2_000_000,
                 "fused_pq_topk")):
        params = (ivf_flat.SearchParams(n_probes=probes) if family ==
                  "ivf_flat" else ivf_pq.SearchParams(n_probes=probes))
        vw = mutable.MutableIvf(str(root / f"v_{name}"), base=base,
                                family=family, res=res, search_params=params,
                                registry=om.Registry(),
                                device=None if res is not None else dev)
        ed = {"delta": {}, "dead_base": set()}
        stream(vw, *VARIANT_WRITES, base_rows.shape[0], id0,
               near_rows(base_rows, 0.1 * float(base_rows[:1000].std()),
                         unit), ed)
        vtruth, _, _ = live_truth(base_rows, ed, metric, qs)
        vdead = ed["dead_base"] - set(ed["delta"])
        step(name)
        (vv, vi), vs = timed(lambda: vw.search(qs, K))
        vl = read(name)
        vrec = float(neighborhood_recall(vi, vtruth))
        vbad = bool(torch.isin(vi.long(), torch.tensor(
            sorted(vdead), dtype=torch.int64, device=dev)).any())
        variants[name] = {"family": family, "n_probes": probes,
                          "k_fetch": _k_fetch(vw._snapshot()),
                          "search_seconds": vs, "recall_at_10": vrec,
                          "deleted_returned": vbad, **vw.stats(),
                          "launches": vl}
        vw.close()
        if vrec < floor or vbad or vl[kernel] < 1:
            emit(variants)
            raise AssertionError(f"mutable {name}: recall {vrec}, deleted "
                                 f"{vbad}, {kernel} launches {vl[kernel]}")
    emit(variants)

    # ---------------------------------------------------- served mutable
    w = mutable.MutableIvf(str(mdir), index_params=ivf_flat.IndexParams(
        n_lists=flat.n_lists), search_params=ivf_flat.SearchParams(
            n_probes=flat_probes), registry=om.Registry(), span_sink=sink,
        device=dev)
    q_host = queries.cpu().numpy()
    bsink = BatchSink()
    eng = serving.Engine(serving.mutable_ivf_searcher(w),
                         serving.EngineConfig(max_batch=64, max_wait_us=2000,
                                              max_inflight=2, warm_ks=(K,),
                                              span_sink=bsink))
    eng.start()
    n_comp0 = len(sink.by_kind("compaction"))
    try:
        builds0 = serving.compile_count()
        gen0 = eng.searcher_generation
        comp = mutable.Compactor(
            w, publish=eng, delta_threshold=SERVE_DELTA_THRESHOLD).start()
        step("mutable_serving")
        written = {}

        def writer():
            written["rows"] = stream(
                eng.writer(), *SERVE_WRITES, n_rows, 4_000_000,
                near_rows(dataset, 0.1 * noise), None)

        wt = threading.Thread(target=writer)
        wt.start()
        run = closed_loop(eng, q_host[:SERVE_QUERIES], K, SERVE_SUBMITTERS)
        wt.join()
        # the compactor stops after the run in progress, if any
        comp.stop(timeout_s=600)
        slaunch = read("mutable_serving")
        spans = sink.by_kind("compaction")[n_comp0:]
        ok_runs = sum(1 for s in spans if s["outcome"] == "ok")
        gen_rise = eng.searcher_generation - gen0
        line = summarize(run, bsink.take())
        # with writes stopped: the sampled rows against solo_reference
        n2 = min(2000, nq)
        run2 = closed_loop(eng, q_host[:n2], K, SERVE_SUBMITTERS)
        sample = rng.choice(n2, SERVE_SAMPLE, replace=False)
        mism = serving.verify_bit_identity(
            eng.searcher, [q_host[j] for j in sample],
            [(run2["distances"][j], run2["ids"][j]) for j in sample], K,
            [run2["placements"][j] for j in sample])
        builds = serving.compile_count() - builds0
    finally:
        eng.stop()
    w.close()
    emit({"phase": "mutable_serving", "card": smi,
          "submitters": SERVE_SUBMITTERS, **line,
          "rows_written_while_serving": written.get("rows"),
          "compactions": [{k: s[k] for k in ("reason", "outcome",
                                             "duration_s")} for s in spans],
          "generation_rise": gen_rise, "ok_compactions": ok_runs,
          "solo_mismatches": mism, "solo_sampled": SERVE_SAMPLE,
          "builds_after_start": builds, "launches": slaunch})
    if gen_rise != ok_runs or ok_runs < 1:
        raise AssertionError(f"served mutable: generation rose {gen_rise} "
                             f"for {ok_runs} compactions")
    if mism or builds:
        raise AssertionError(f"served mutable: {mism} mismatches, {builds} "
                             "builds after start()")

    # ------------------------------------------------------------- tiered
    pad = pq_index.list_codes.shape[1]
    plan = solve_host_tier(pq_index.n_lists, pad, pq_index.rot_dim,
                           pq_index.list_codes.shape[2], 0)
    ws = 2 * TIER_SLOTS * plan["slab_bytes"]
    plan = solve_host_tier(pq_index.n_lists, pad, pq_index.rot_dim,
                           pq_index.list_codes.shape[2], ws)
    tres = Resources(device=dev, workspace_limit_bytes=ws)
    treg = om.Registry()
    (t,), demote_s = timed(lambda: (tiered.TieredIvfPq.from_index(
        pq_index, res=tres, registry=treg),))
    params = ivf_pq.SearchParams(n_probes=pq_probes)
    ivf_pq.ensure_scan_cache(pq_index)
    outs, mism_chunks, tlaunch = [], 0, {}
    tier_s = res_s = 0.0
    n_tier = min(nq, TIER_QUERIES)
    for s in range(0, n_tier, TIER_CHUNK):
        qc = queries[s:min(s + TIER_CHUNK, n_tier)]
        step("tiered")
        got, dt = timed(lambda: t.search(qc, K, params, res=tres))
        add_counts(tlaunch, read("tiered"))
        want, dr = timed(lambda: ivf_pq.search(pq_index, qc, K, params,
                                               res=tres, memory_mode="cache"))
        tier_s += dt
        res_s += dr
        mism_chunks += 0 if bitwise(got, want) else 1
        outs.append(got[1])
    counts = t.arena.snapshot_counts()
    recall_t = float(neighborhood_recall(torch.cat(outs), gt_i[:n_tier]))
    hist = dict(treg.get("raft_tpu_tier_fetch_stall_seconds").collect())
    demand = hist[(t.arena.label, "demand")]
    fetched_bytes = counts["misses"] * plan["fetch_bytes_per_slab"]
    tline = {"phase": "tiered", "card": smi, "n_probes": pq_probes,
             "arena_slots": t.arena.slots, "arena_bytes": t.arena.nbytes,
             "predicted_arena_bytes": plan["arena_bytes"],
             "host_bytes": t.tier.nbytes,
             "predicted_host_bytes": plan["host_bytes"],
             "host_pinned": t.tier.codes.is_pinned(),
             "demote_seconds": demote_s, "chunk": TIER_CHUNK,
             "chunks_not_bitwise": mism_chunks, "recall_at_10": recall_t,
             "tiered_seconds": tier_s, "resident_seconds": res_s,
             **counts, "hit_rate": counts["hits"] / max(counts["resolved"],
                                                        1),
             "fetched_bytes": fetched_bytes,
             "stall_seconds": demand.sum, "stalls": demand.count,
             "fetch_gb_per_s": fetched_bytes / max(demand.sum, 1e-12) / 1e9,
             "stall_hist": {"bounds": list(demand.snapshot().bounds),
                            "counts": list(demand.snapshot().counts)},
             "launches": tlaunch}
    if t.arena.nbytes != plan["arena_bytes"] or t.arena.slots != TIER_SLOTS:
        emit(tline)
        raise AssertionError(f"arena {t.arena.nbytes} bytes, {t.arena.slots}"
                             f" slots; predicted {plan['arena_bytes']}")
    if mism_chunks or recall_t < 0.80:
        emit(tline)
        raise AssertionError(f"tiered: {mism_chunks} chunks differ from the "
                             f"resident search, recall {recall_t}")
    # served, with and without the prefetcher
    served = {}
    for prefetch in (False, True):
        searcher = serving.tiered_ivf_pq_searcher(t, params, res=tres)
        bsink = BatchSink()
        eng = serving.Engine(searcher, serving.EngineConfig(
            max_batch=16, max_wait_us=2000, max_inflight=2, warm_ks=(K,),
            span_sink=bsink))
        eng.start()
        pf = None
        try:
            builds0 = serving.compile_count()
            c0 = t.arena.snapshot_counts()
            if prefetch:
                pf = tiered.attach_prefetcher(eng, t, params=params)
            step("tiered_serving")
            qs_host = q_host[:TIER_SERVE_QUERIES]
            run = closed_loop(eng, qs_host, K, SERVE_SUBMITTERS)
            sl = read("tiered_serving")
            if pf is not None:
                pf.close()
            c1 = t.arena.snapshot_counts()
            sample = rng.choice(len(qs_host), SERVE_SAMPLE, replace=False)
            mism = serving.verify_bit_identity(
                searcher, [qs_host[j] for j in sample],
                [(run["distances"][j], run["ids"][j]) for j in sample], K,
                [run["placements"][j] for j in sample])
            builds = serving.compile_count() - builds0
            summ = summarize(run, bsink.take())
        finally:
            if pf is not None:
                pf.close()
            eng.stop()
        served["prefetch" if prefetch else "no_prefetch"] = {
            **summ, "arena_delta": {k: c1[k] - c0[k] for k in c1},
            "prefetch_passes": pf.n_passes if pf else 0,
            "prefetch_errors": pf.n_errors if pf else 0,
            "solo_mismatches": mism, "builds_after_start": builds,
            "launches": sl}
        if mism or builds:
            emit({**tline, "served": served})
            raise AssertionError(f"served tiered (prefetch {prefetch}): "
                                 f"{mism} mismatches, {builds} builds")
    # the manifest round trip
    mp, save_s = timed(lambda: tiered.save_tiered(t, str(root / "tiered"),
                                                  name="smoke"))
    (t2,), load_s = timed(lambda: (tiered.load_tiered(
        mp, res=tres, arena_slots=TIER_SLOTS),))
    rt = bitwise(t2.search(queries[:TIER_CHUNK], K, params, res=tres),
                 t.search(queries[:TIER_CHUNK], K, params, res=tres))
    tline.update(served=served, save_seconds=save_s, load_seconds=load_s,
                 manifest_roundtrip_bitwise=rt)
    emit(tline)
    if not rt:
        raise AssertionError("load_tiered's search differs from the saved")
    del t2

    # kernel rows: fused_ivf_topk over the arena slabs at bucket 16
    q16 = queries[:TIER_CHUNK].contiguous()
    q_rot, centers_rot, probes = ivf_pq._coarse_probes_rot(q16, t, pq_probes)
    slot_np, pinned = t.arena.resolve_probes(t, probes.cpu().numpy())
    try:
        slots = torch.from_numpy(slot_np).to(dev)
        qr_res = (q_rot[:, None, :] - centers_rot[probes.long()]).contiguous()
        qn = (qr_res * qr_res).sum(-1).contiguous()
        dec, norms, ids, _ = t.arena.tensors()
        args = (slots, qr_res, qn, dec, norms, ids, K, False)
        got = gk.fused_ivf_topk(*args)
        plain = gk.fused_ivf_topk_plain(*args)
        resident = gk.fused_ivf_topk(probes, qr_res, qn,
                                     pq_index.list_decoded,
                                     pq_index.decoded_norms,
                                     pq_index.safe_ids(), K, False)
        adc = float(plain[0][torch.isfinite(plain[0])].abs().max())
        res_ok = assert_topk_close(got, plain, 1e-4 * adc, 1e-5,
                                   "fused_ivf_topk over the arena")
        if not bitwise(got, resident):
            raise AssertionError("fused_ivf_topk over the arena slabs is "
                                 "not bitwise its call over the lists")
        rot = pq_index.rot_dim
        n_probed = torch.unique(slots.long()).numel()
        rows_b = int(t.arena.tensors()[3][slots.long()].sum())
        rows_out.append(dict(
            name="fused_ivf_topk", route="cuda",
            source="raft_tpu_torch/csrc/fused_ivf_topk.cu",
            replaces=replaces["fused_ivf_topk"],
            shape=f"tiered arena slabs, bucket {TIER_CHUNK}: "
                  f"{TIER_CHUNK} queries x {pq_probes} probes over "
                  f"{t.arena.slots} slots, pad {pad}, rot {rot}, bf16",
            launches=tlaunch["fused_ivf_topk"], agrees_with_plain=True,
            bitwise_resident=True, **res_ok,
            ms=graph_ms(lambda: gk.fused_ivf_topk(*args), 20),
            ms_eager=cuda_ms(lambda: gk.fused_ivf_topk(*args), 20),
            plain_ms=cuda_ms(lambda: gk.fused_ivf_topk_plain(*args), 3),
            library_ms=None, parent_ms=None, ab_ms=None,
            **bound(*obs_costs.ivf_topk_work(
                TIER_CHUNK, slots.shape[1], rot, pad, 2, K, n_probed,
                rows_b))))
        emit({"phase": "kernel_check", **rows_out[-1]})
    finally:
        t.arena.release(pinned)

    # ---------------------------------------------------------- from file
    if fbin is None:
        fbin = root / "base.fbin"
    fbin.parent.mkdir(parents=True, exist_ok=True)
    _, write_s = timed(lambda: native.write_bin(str(fbin),
                                                dataset.cpu().numpy()))
    oline = {"phase": "ooc", "card": smi, "file_bytes": fbin.stat().st_size,
             "fbin_write_seconds": write_s, "batch_rows": 1 << 18,
             "n_probes": OOC_PROBES}
    for name, build, sp, floor in (
            ("ivf_flat", lambda: ooc.build_ivf_flat_from_file(
                str(fbin), ivf_flat.IndexParams(n_lists=flat.n_lists),
                res=Resources(device=dev, seed=seed), batch_rows=1 << 18),
             ivf_flat.SearchParams(n_probes=OOC_PROBES), 0.90),
            ("ivf_pq", lambda: ooc.build_ivf_pq_from_file(
                str(fbin), ivf_pq.IndexParams(n_lists=pq_index.n_lists,
                                              pq_dim=pq_index.pq_dim,
                                              pq_bits=pq_index.pq_bits),
                res=Resources(device=dev, seed=seed), batch_rows=1 << 18),
             ivf_pq.SearchParams(n_probes=OOC_PROBES), 0.80)):
        step(f"ooc_{name}")
        (idx,), build_s = timed(lambda: (build(),))
        mod = ivf_flat if name == "ivf_flat" else ivf_pq
        (_, oi), osearch_s = timed(lambda: mod.search(idx, queries, K, sp))
        ol = read(f"ooc_{name}")
        sizes = idx.list_sizes.long()
        pad_o = idx.list_indices.shape[1]
        valid = torch.arange(pad_o, device=dev)[None, :] < sizes[:, None]
        stored = torch.cat([idx.list_indices[valid],
                            idx.overflow_indices[idx.overflow_indices >= 0]])
        once = bool(torch.equal(torch.sort(stored.long()).values,
                                torch.arange(n_rows, device=dev)))
        orec = float(neighborhood_recall(oi, gt_i))
        oline[name] = {"build_seconds": build_s, "search_seconds": osearch_s,
                       "recall_at_10": orec, "ids_once": once,
                       "list_pad": pad_o,
                       "overflow_rows": int((idx.overflow_indices >= 0)
                                            .sum()), "launches": ol}
        del idx
        if not once or orec < floor:
            emit(oline)
            raise AssertionError(f"ooc {name}: ids once {once}, recall "
                                 f"{orec} < {floor}")
    emit(oline)
    shutil.rmtree(root, ignore_errors=True)
    for name in ("fused_ivf_topk", "ivf_scan", "select_k", "fused_pq_topk"):
        if total[name] < 1:
            raise AssertionError(f"phase 6e launched no {name}")
    return rows_out, total


if __name__ == "__main__":
    if len(sys.argv) == 7 and sys.argv[1] == "child":
        _child(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5],
               int(sys.argv[6]))
    sys.exit(2)
