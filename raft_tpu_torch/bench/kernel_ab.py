"""Device times of saved kernel calls, to time two trees' kernels alike.

    PYTHONPATH=TREE python3 raft_tpu_torch/bench/kernel_ab.py INPUTS

INPUTS is a file written by ``save_inputs`` (``chip_smoke.py --parent``
writes one): for each case, the name of a ``gpu_kernels`` function (or
``select_k_rows``, below), its arguments (tensors saved from the card), a
repetition count and whether to time it from a CUDA graph. Run as a file,
the script imports the ``raft_tpu_torch`` that ``PYTHONPATH`` names, builds
that tree's kernels, calls each case once to warm up and then ``reps``
times between two CUDA events (from a graph of ``reps`` calls, replayed ten
times, for work shorter than a launch). Prints one JSON line: the package's
path and each case's mean milliseconds a call. Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from typing import Optional

import torch


def save_inputs(path, cases) -> None:
    """``cases``: name → (function name, argument tuple, reps[, graph])."""
    torch.save({name: {"kernel": c[0], "args": list(c[1]), "reps": int(c[2]),
                       "graph": bool(c[3]) if len(c) > 3 else False}
                for name, c in cases.items()}, path)


def select_k_rows(vals, ids, k: int, select_min: bool = True,
                  v: Optional[int] = None, passes: Optional[int] = None):
    """select_k's kernel over the rows of vals [b, n] with their ids [b, n]
    (or the columns when ids is None), launched through its C entry
    ``select_k_rows`` as the per-query merges of the fused kernels launch
    it: ``(values [b, k], ids [b, k])``. ``v`` is the entry's chunk width
    and ``passes`` its passes over a row (None: the launcher's own choice;
    v = -1 the shared-memory route); a tree whose entry predates them takes
    neither. For timing and the card tests, not counted in the launch
    counts."""
    from raft_tpu_torch.ops import gpu_kernels as gk

    b, n = vals.shape
    out_v = torch.empty((b, k), dtype=torch.float32, device=vals.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=vals.device)
    args = [vals.data_ptr(), None if ids is None else ids.data_ptr(), b, n, k,
            int(not select_min)]
    if len(gk._ARGTYPES["select_k_rows"]) > 9:
        args += [v or 0, passes or 0]
    with torch.cuda.device(vals.device):
        rc = gk._lib("select_k").select_k_rows(
            *args, out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(vals.device).cuda_stream)
    gk._check_rc("select_k", rc)
    return out_v, out_i


def graph_ms(fn, calls: int, reps: int = 10) -> float:
    """Mean device time of one ``fn()`` from a CUDA graph of ``calls``
    calls replayed ``reps`` times, so that no host launch cost sits between
    the kernels (for work shorter than a launch)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def main(argv) -> int:
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import raft_tpu_torch
    from raft_tpu_torch.ops import gpu_kernels as gk

    cases = torch.load(argv[1], map_location="cuda:0")
    gk.build_all(sorted({c["kernel"] for c in cases.values()
                         if c["kernel"] in gk.SOURCES}))
    times = {}
    for name, case in cases.items():
        fn = (select_k_rows if case["kernel"] == "select_k_rows"
              else getattr(gk, case["kernel"]))
        args = case["args"]
        if case.get("graph"):
            times[name] = graph_ms(lambda: fn(*args), case["reps"])
            continue
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(case["reps"]):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / case["reps"]
    print(json.dumps({"package": raft_tpu_torch.__file__, "ms": times}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
