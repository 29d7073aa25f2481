"""Where the time of the redesigned kernels goes: other plans, and parts
taken out.

    python3 -m raft_tpu_torch.bench.ablate [--seed N]

On the card, at ``fused_l2_topk``'s main shape (SIFT-1M's from the seed:
1,000,000 × 128 rows, 10,000 queries, k=10), on an ``ivf_scan`` tile of
440 queries × 32 random probes over 1024 lists of 1456 slots (rot 128,
f32), ``fused_ivf_topk`` on 10,000 queries × 32 random probes of the same
lists (each list filled to a random size in [500, 1456), k=10),
``fused_l2_argmin`` at the k-means E-step's shape (the 1M rows against
1024 of them, clamped), ``fused_pq_topk`` on 10,000 queries × 32 random
probes of 1024 lists of 1456 random codes (pq_dim 64, pq_len 2, filled as
above, k=10; and 64 probes at k=20, refine's shape) and
``fused_cagra_topk`` over the 1M rows with a random graph of degree 32
(10,000 queries, 64 random seeds, itopk 64, width 1), ``select_k`` on the
coarse scores of those queries against 1024 of the rows ([10,000 × 1024],
k=32) and on rows shaped as the LUT search's per-query merge reads them
(64 sorted runs of 10 with ids, [10,000 × 640], k=10), it times, as mean
milliseconds a call:

- each kernel as it is, ``fused_ivf_topk`` also at k = 1, 16, 17 and 32
  (carries in registers up to 16, in shared memory above),
  ``fused_pq_topk`` at k = 1, 20, 32 and 33 (the per-query route above
  32), and the grouping pass alone at both IVF kernels' sizes;
- ``fused_l2_topk`` under other plans than the planner's (database
  ranges, ring stages, consumer warpgroups), ``fused_ivf_topk`` with
  other runs, ``fused_l2_argmin`` with other ring stages,
  ``fused_pq_topk`` with fewer warps (shorter runs), ``fused_cagra_topk``
  with other warps a block and on its block route, ``select_k`` at other
  chunk widths than the planner's (V = 1, 2, 4 values a lane a chunk), in
  one pass and in two (the bounding pass first) and on its shared-memory
  route, each result held bitwise to the planner's (select_k's calls timed
  from CUDA graphs: they are shorter than a launch on the host);
- copies of the sources with one part taken out (built into
  ``build/raft_tpu_torch/ablate/`` and loaded in place of the kernel's
  library): ``fused_l2_topk`` without its epilogue (the product alone) and
  without the survivors' merges (the epilogue's first pass and vote
  alone); ``ivf_scan`` without the staging of the slab rows and without
  the product; ``fused_pq_topk`` without the per-query merge, with its
  LUT taken as built (no LUT build) and without the staging of the codes;
  ``fused_cagra_topk`` without the dedup and without the candidates'
  sort; ``select_k``'s register route with other cut-offs between
  inserting a step's survivors and sorting and merging them (0: always
  merge, 4, and 32: always insert; the header is inlined into the copy).
  An ablated kernel computes a wrong result (and an ablated beam
  walk takes another path); only its time is read. (A part whose result
  nothing reads is dropped by the compiler with the work that feeds it,
  so ``fused_ivf_topk``'s selection, which alone reads its products, is
  measured by its time at other k instead.)

``--only select_k`` times select_k's calls, variants and ablated copies
alone. Prints one JSON line. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys

import numpy as np
import torch

#: name → (kernel, [(text to replace, replacement), ...])
ABLATIONS = {
    "fused_l2_topk/no_epilogue": ("fused_l2_topk", [(
        "    // epilogue: 16 column pairs",
        "    continue;\n    // epilogue: 16 column pairs")]),
    "fused_l2_topk/no_survivor_merges": ("fused_l2_topk", [(
        "    for (; cmask; cmask &= cmask - 1) {",
        "    for (cmask = 0; cmask; cmask &= cmask - 1) {")]),
    "ivf_scan/no_slab_staging": ("ivf_scan", [(
        "    ivfg::copy_slab<T, V, kThreads>(",
        "    if (false) ivfg::copy_slab<T, V, kThreads>(")]),
    "ivf_scan/no_product": ("ivf_scan", [(
        "    if (busy) ivfg::tile_product(acc, xs, qs, tx, ty, rc);",
        "    if (false) ivfg::tile_product(acc, xs, qs, tx, ty, rc);")]),
    "fused_pq_topk/no_merge": ("fused_pq_topk", [(
        "  return rtt::launch_select_rows(\n      a.part_v,",
        "  if (nq > 0) return cudaSuccess;\n"
        "  return rtt::launch_select_rows(\n      a.part_v,")]),
    "fused_pq_topk/prebuilt_lut": ("fused_pq_topk", [(
        "const CbEntry<PL>& cb2) {\n",
        "const CbEntry<PL>& cb2) {\n  if (u >= 0) return;\n")]),
    "fused_pq_topk/no_code_staging": ("fused_pq_topk", [(
        "    for (int e = tid; e < n_run * words; e += nt) {",
        "    for (int e = tid; e < 0; e += nt) {")]),
    "fused_cagra_topk/no_dedup": ("fused_cagra_topk", [
        ("  int i = 0;\n  for (; i + 4 <= c.itopk; i += 4) {",
         "  int i = c.itopk;\n  for (; i + 4 <= c.itopk; i += 4) {"),
        ("    drop[u] = drop[u] || (same & below) != 0u;",
         "    drop[u] = drop[u] || (same & below & 0u) != 0u;")]),
    "fused_cagra_topk/no_sort": ("fused_cagra_topk", [(
        "  sort_keys<CPL>(key);",
        "  if (false) sort_keys<CPL>(key);")]),
    **{f"select_k/insert_max={m}": ("select_k", [(
        "constexpr int kRegInsertMax = 16;",
        f"constexpr int kRegInsertMax = {m};")]) for m in (0, 4, 32)},
}
#: further calls timed with a kernel's ablated copies
ABLATION_CALLS = {"select_k": ["select_k_merge"]}


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(label: str, fn, reps: int) -> float:
    """``_ms``, or for select_k's calls (shorter on the card than a launch
    on the host) the mean of ``reps`` calls from a CUDA graph."""
    if label.startswith("select_k"):
        from raft_tpu_torch.bench.kernel_ab import graph_ms
        return graph_ms(fn, reps)
    return _ms(fn, reps)


def _build(gk, name: str, kernel: str, edits):
    """The kernel's library built from its source with each ``(old, new)``
    of ``edits`` replaced."""
    src = (gk.CSRC / gk.SOURCES[kernel]).read_text()
    for old, new in edits:
        if src.count(old) == 0:  # an edit of a header: inline the headers
            src = re.sub(r'#include "(\w+\.cuh)"',
                         lambda m: (gk.CSRC / m.group(1)).read_text(), src)
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    out = gk.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / (name.replace("/", "-") + ".cu")
    cu.write_text(src)
    lib = cu.with_suffix(".so")
    subprocess.run([gk._nvcc(), *gk.NVCC_FLAGS, "-I", str(gk.CSRC), "-o",
                    str(lib), str(cu)], check=True, capture_output=True)
    return lib


def _load(gk, kernel: str, path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name in gk._FUNCTIONS.get(kernel, [kernel]):
        getattr(lib, fn_name).argtypes = gk._ARGTYPES[fn_name]
        getattr(lib, fn_name).restype = ctypes.c_int
    lib.rtt_error_string.argtypes = [ctypes.c_int]
    lib.rtt_error_string.restype = ctypes.c_char_p
    return lib


def _time_variants(gk, plan_fn: str, kernel: str, variants, want, calls,
                   times) -> None:
    """Time ``kernel`` under each plan of ``variants`` (``plan_fn`` of
    gpu_kernels replaced), its result held bitwise to ``want``."""
    planned = getattr(gk, plan_fn)
    try:
        for name, plan in variants.items():
            setattr(gk, plan_fn, lambda *a, _p=plan: _p)
            got = calls[kernel][0]()
            if not (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{kernel} under {name} differs")
            times[f"{kernel}/{name}"] = _ms(calls[kernel][0],
                                           calls[kernel][1])
    finally:
        setattr(gk, plan_fn, planned)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("all", "select_k"), default="all",
                        help="select_k: its timings, variants and ablated "
                        "copies alone")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.bench.datagen import low_rank_clusters
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops.distance import row_norms_sq

    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = low_rank_clusters(np.random.default_rng(opts.seed), 1_010_000, 128)
    y = torch.from_numpy(rows[:1_000_000]).to(dev)
    x = torch.from_numpy(rows[1_000_000:]).to(dev)
    xn, yn = row_norms_sq(x), row_norms_sq(y)
    g = torch.Generator(device=dev).manual_seed(opts.seed)
    probes = torch.randint(0, 1024, (440, 32), generator=g, device=dev,
                           dtype=torch.int32)
    data = torch.randn(1024, 1456, 128, generator=g, device=dev)
    norms = row_norms_sq(data)
    qres = torch.randn(440, 32, 128, generator=g, device=dev)
    # fused_ivf_topk: 10,000 queries × 32 probes of the same lists, each
    # filled to a random size
    ivf_probes = torch.randint(0, 1024, (10000, 32), generator=g, device=dev,
                               dtype=torch.int32)
    sizes = torch.randint(500, 1456, (1024, 1), generator=g, device=dev)
    ids = torch.arange(1024 * 1456, device=dev, dtype=torch.int32).reshape(
        1024, 1456)
    ids = torch.where(torch.arange(1456, device=dev) < sizes, ids, -1)
    ivf_q = torch.randn(10000, 1, 128, generator=g, device=dev).expand(
        10000, 32, 128).contiguous()
    ivf_args = (ivf_probes, ivf_q, (ivf_q * ivf_q).sum(-1), data, norms, ids,
                10)
    centres = y[torch.randperm(y.shape[0], generator=g, device=dev)[:1024]]
    argmin_args = (y, centres, yn, row_norms_sq(centres), True)
    # fused_pq_topk: random codes of the same lists' sizes
    codes = torch.randint(0, 256, (1024, 1456, 64), generator=g, device=dev,
                          dtype=torch.uint8)
    cb = torch.randn(64, 256, 2, generator=g, device=dev)
    pq_base = (ivf_probes, torch.randn(10000, 128, generator=g, device=dev),
               torch.randn(1024, 128, generator=g, device=dev), cb,
               (cb * cb).sum(-1), codes, ids)
    pq_refine = (torch.randint(0, 1024, (10000, 64), generator=g, device=dev,
                               dtype=torch.int32), *pq_base[1:])
    # fused_cagra_topk: a random graph of degree 32 over the 1M rows
    graph = torch.randint(0, y.shape[0], (y.shape[0], 32), generator=g,
                          device=dev, dtype=torch.int32)
    seeds = torch.randint(0, y.shape[0], (10000, 64), generator=g, device=dev,
                          dtype=torch.int32)
    cagra_args = (x, y, graph, seeds, gk.beam_norms(x), 10, 64, 1, 0)
    # select_k: coarse scores, and merge rows (64 sorted runs of 10 a query,
    # each run above its own pair's offset, with ids)
    from raft_tpu_torch.bench.kernel_ab import select_k_rows
    scores = (xn[:, None] + row_norms_sq(centres)[None, :]
              - 2.0 * (x @ centres.T)).contiguous()
    runs = torch.randn(10000, 64, 1, generator=g, device=dev) + torch.sort(
        torch.randn(10000, 64, 10, generator=g, device=dev).abs(), 2).values
    merge_v = runs.reshape(10000, 640).contiguous()
    merge_i = torch.arange(10000 * 640, device=dev,
                           dtype=torch.int32).reshape(10000, 640)
    calls = {"fused_l2_topk": (lambda: gk.fused_l2_topk(x, y, 10, xn, yn), 3),
             "ivf_scan": (lambda: gk.ivf_scan(probes, qres, data, norms), 20),
             "fused_ivf_topk": (lambda: gk.fused_ivf_topk(*ivf_args), 5),
             "fused_l2_argmin": (lambda: gk.fused_l2_argmin(*argmin_args), 5),
             "fused_pq_topk": (lambda: gk.fused_pq_topk(*pq_base, 10), 3),
             "fused_cagra_topk": (lambda: gk.fused_cagra_topk(*cagra_args),
                                  3),
             "select_k": (lambda: gk.streaming_select_k(scores, 32), 20),
             "select_k_merge": (lambda: select_k_rows(merge_v, merge_i, 10),
                                20)}
    if opts.only == "select_k":
        calls = {k: c for k, c in calls.items() if k.startswith("select_k")}
    times = {kernel: _timed(kernel, fn, reps)
             for kernel, (fn, reps) in calls.items()}
    planner = {"select_k": dataclasses.asdict(gk.plan_select_k(1024, 32)),
               "select_k_merge": dataclasses.asdict(gk.plan_select_k(640,
                                                                     10))}
    if opts.only == "all":
        times["ivf_scan_groups"] = _ms(lambda: gk.ivf_scan_groups(probes, 1024),
                                       20)
        ivf_plan = gk.plan_fused_ivf(10000, 32, 1024, 1456, 128, 10, 4, n_sm)
        times["fused_ivf_topk_groups"] = _ms(
            lambda: gk.ivf_scan_groups(ivf_probes, 1024), 5)
        for k in (1, 16, 17, 32):  # how the selection's cost grows with k
            times[f"fused_ivf_topk/k={k}"] = _ms(
                lambda: gk.fused_ivf_topk(*ivf_args[:6], k), 5)
        for k in (1, 20, 32, 33):  # 33: the per-query route
            times[f"fused_pq_topk/k={k}"] = _ms(
                lambda: gk.fused_pq_topk(*pq_base, k), 3)
        times["fused_pq_topk/refine_shape"] = _ms(
            lambda: gk.fused_pq_topk(*pq_refine, 20), 3)
        want = gk.fused_l2_topk(x, y, 10, xn, yn)
        base = gk.plan_fused_topk(x.shape[0], y.shape[0], 128, 10, n_sm)
        variants = {}
        for s in (1, 3, 10):
            split_len = -(-(-(-y.shape[0] // s)) // 128) * 128
            splits = -(-y.shape[0] // split_len)
            variants[f"splits={s}"] = dataclasses.replace(
                base, split_len=split_len, splits=splits, chunk_splits=splits)
        variants["stages=2"] = dataclasses.replace(
            base, stages=2, smem=gk.l2_topk_tc_smem_bytes(10, 2, base.wgs))
        variants["wgs=1"] = dataclasses.replace(
            base, wgs=1, smem=gk.l2_topk_tc_smem_bytes(10, base.stages, 1))
        _time_variants(gk, "plan_fused_topk", "fused_l2_topk", variants, want,
                       calls, times)
        variants = {"chunks_per_run=8": dataclasses.replace(
            ivf_plan, chunks_per_run=8, runs=3)}
        _time_variants(gk, "plan_fused_ivf", "fused_ivf_topk", variants,
                       gk.fused_ivf_topk(*ivf_args), calls, times)
        am_plan = gk.plan_fused_argmin(y.shape[0], 1024, 128)
        variants = {"stages=2": dataclasses.replace(
            am_plan, stages=2, smem=gk.l2_argmin_smem_bytes("resident", 128, 2))}
        _time_variants(gk, "plan_fused_argmin", "fused_l2_argmin", variants,
                       gk.fused_l2_argmin(*argmin_args), calls, times)
        pq_plan = gk.plan_fused_pq(10000, 32, 1024, 1456, 64, 2, 10)
        variants = {f"warps={w}": dataclasses.replace(
            pq_plan, warps=w, runs=-(-1456 // (gk.PQ_ROWS_PER_WARP * w)),
            smem=gk.pq_grouped_smem_bytes(64, 2, w)) for w in (8, 12)}
        _time_variants(gk, "plan_fused_pq", "fused_pq_topk", variants,
                       gk.fused_pq_topk(*pq_base, 10), calls, times)
        cg_plan = gk.plan_fused_cagra(64, 128, 1, 32)
        slice_ = gk.cagra_warp_smem_bytes(64, 128, 1, 32)
        variants = {f"warps={w}": gk.CagraTopkPlan("warp", w, w * slice_)
                    for w in (1, 2)}
        variants["block_route"] = gk.CagraTopkPlan(
            "block", 0, gk.cagra_topk_smem_bytes(64, 128, 1, 32))
        _time_variants(gk, "plan_fused_cagra", "fused_cagra_topk", variants,
                       gk.fused_cagra_topk(*cagra_args), calls, times)
        planner.update(
            fused_l2_topk=dataclasses.asdict(base),
            fused_ivf_topk=dataclasses.asdict(ivf_plan),
            fused_l2_argmin=dataclasses.asdict(am_plan),
            fused_pq_topk=dataclasses.asdict(pq_plan),
            fused_cagra_topk=dataclasses.asdict(cg_plan))
    sk_variants = {
        "select_k": lambda v, p: select_k_rows(scores, None, 32, v=v,
                                               passes=p),
        "select_k_merge": lambda v, p: select_k_rows(merge_v, merge_i, 10,
                                                     v=v, passes=p)}
    for label, fn in sk_variants.items():
        want = calls[label][0]()
        for v, p in ((1, 0), (2, 0), (4, 0), (8, 1), (8, 2), (-1, 0)):
            got = fn(v, p)
            if not (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{label} at v={v} differs")
            name = (f"v={v}" if p == 0 else f"passes={p}") if v > 0 \
                else "shared_route"
            times[f"{label}/{name}"] = _timed(label, lambda: fn(v, p), 20)
    built = {name: _build(gk, name, *spec) for name, spec in ABLATIONS.items()
             if opts.only == "all" or spec[0] == opts.only}
    for name, path in built.items():
        kernel = ABLATIONS[name][0]
        kept = gk._lib(kernel)
        gk._libs[kernel] = _load(gk, kernel, path)
        try:
            times[name] = _timed(kernel, *calls[kernel])
            for extra in ABLATION_CALLS.get(kernel, []):
                times[f"{name}@{extra}"] = _timed(extra, *calls[extra])
        finally:
            gk._libs[kernel] = kept
        print(f"ablate: {name} {times[name]:.4f} ms", file=sys.stderr,
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "planner": planner,
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
