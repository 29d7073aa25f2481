"""Where the time of ``fused_l2_topk`` and ``ivf_scan`` goes: other plans,
and parts taken out.

    python3 -m raft_tpu_torch.bench.ablate [--seed N]

On the card, at ``fused_l2_topk``'s main shape (SIFT-1M's from the seed:
1,000,000 × 128 rows, 10,000 queries, k=10) and on an ``ivf_scan`` tile of
440 queries × 32 random probes over 1024 lists of 1456 slots (rot 128,
f32), it times, as mean milliseconds a call:

- each kernel as it is, and ``ivf_scan``'s grouping pass alone;
- ``fused_l2_topk`` under other plans than the planner's (database
  ranges, ring stages, consumer warpgroups), each result held bitwise to
  the planner's;
- copies of the two sources with one part taken out (built into
  ``build/raft_tpu_torch/ablate/`` and loaded in place of the kernel's
  library): ``fused_l2_topk`` without its epilogue (the product alone) and
  without the survivors' merges (the epilogue's first pass and vote
  alone); ``ivf_scan`` without the staging of the slab rows and without
  the product. An ablated kernel computes a wrong result; only its time is
  read.

Prints one JSON line. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

#: name → (kernel, text to replace, replacement)
ABLATIONS = {
    "fused_l2_topk/no_epilogue": (
        "fused_l2_topk", "    // epilogue: 16 column pairs",
        "    continue;\n    // epilogue: 16 column pairs"),
    "fused_l2_topk/no_survivor_merges": (
        "fused_l2_topk", "    for (; cmask; cmask &= cmask - 1) {",
        "    for (cmask = 0; cmask; cmask &= cmask - 1) {"),
    "ivf_scan/no_slab_staging": (
        "ivf_scan", "    copy_slab<T, V>(bufs + (st & 1) * kS * kRS,",
        "    if (false) copy_slab<T, V>(bufs + (st & 1) * kS * kRS,"),
    "ivf_scan/no_product": (
        "ivf_scan", "    for (; busy && j + 4 <= rc; j += 4) {",
        "    for (; false && busy && j + 4 <= rc; j += 4) {"),
}


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


def _build(gk, name: str, kernel: str, old: str, new: str):
    """The kernel's library built from its source with ``old`` replaced."""
    src = (gk.CSRC / gk.SOURCES[kernel]).read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the source no longer has {old!r}")
    out = gk.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / (name.replace("/", "-") + ".cu")
    cu.write_text(src.replace(old, new))
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.bench.datagen import low_rank_clusters
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops.distance import row_norms_sq

    dev = torch.device("cuda", 0)
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
    calls = {"fused_l2_topk": (lambda: gk.fused_l2_topk(x, y, 10, xn, yn), 3),
             "ivf_scan": (lambda: gk.ivf_scan(probes, qres, data, norms), 20)}
    times = {kernel: _ms(fn, reps) for kernel, (fn, reps) in calls.items()}
    times["ivf_scan_groups"] = _ms(lambda: gk.ivf_scan_groups(probes, 1024),
                                   20)
    want = gk.fused_l2_topk(x, y, 10, xn, yn)
    base = gk.plan_fused_topk(x.shape[0], y.shape[0], 128, 10, torch.cuda
                              .get_device_properties(dev).multi_processor_count)
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
    plan_of = gk.plan_fused_topk
    try:
        for name, plan in variants.items():
            gk.plan_fused_topk = lambda *a, _p=plan: _p
            got = gk.fused_l2_topk(x, y, 10, xn, yn)
            if not (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"fused_l2_topk under {name} differs")
            times[f"fused_l2_topk/{name}"] = _ms(calls["fused_l2_topk"][0], 3)
    finally:
        gk.plan_fused_topk = plan_of
    built = {name: _build(gk, name, *spec) for name, spec in ABLATIONS.items()}
    for name, path in built.items():
        kernel = ABLATIONS[name][0]
        kept = gk._lib(kernel)
        gk._libs[kernel] = _load(gk, kernel, path)
        try:
            times[name] = _ms(*calls[kernel])
        finally:
            gk._libs[kernel] = kept
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "planner": dataclasses.asdict(base), "ms": times}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
