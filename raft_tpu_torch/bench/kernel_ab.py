"""Device times of saved kernel calls, to time two trees' kernels alike.

    PYTHONPATH=TREE python3 raft_tpu_torch/bench/kernel_ab.py INPUTS

INPUTS is a file written by ``save_inputs`` (``chip_smoke.py --parent``
writes one): for each case, the name of a ``gpu_kernels`` function, its
arguments (tensors saved from the card) and a repetition count. Run as a
file, the script imports the ``raft_tpu_torch`` that ``PYTHONPATH`` names,
builds that tree's kernels, calls each case once to warm up and then
``reps`` times between two CUDA events. Prints one JSON line: the
package's path and each case's mean milliseconds a call. Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import torch


def save_inputs(path, cases) -> None:
    """``cases``: name → (gpu_kernels function name, argument tuple, reps)."""
    torch.save({name: {"kernel": fn, "args": list(args), "reps": int(reps)}
                for name, (fn, args, reps) in cases.items()}, path)


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
        fn, args = getattr(gk, case["kernel"]), case["args"]
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
