"""The readings that a cell's limits are set from.

    python3 -m vsbench.control --workload <cell> --seeds <n> [<n> ...] \
        [--seconds <s>] [--fault <name>]

For each seed, in one process on the card: the cell's set-up and a short
window at the cell's own load, then the numbers compared for the program
(its lower readings) and for the control (its upper readings): the
reference's search with TF32 products, or the program's own
lower-precision search where the configuration names one
(``control_search``), and the assignment and encoding with TF32 products,
each put in the program's place. With ``--fault``, the program's numbers
with that fault of ``vsbench/faults.py`` planted in its build instead (the
upper readings of the build's quality). One JSON line a seed. The
benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from vsbench.run import ROOT, execute, load_cell, pin_caches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m vsbench.control",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("vsbench.control: no CUDA card", file=sys.stderr)
        return 3
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(ROOT, args.workload)
    if args.fault:
        from vsbench.faults import planted
    for seed in args.seeds:
        with (planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            result = execute(cell, benchmark, seed, args.seconds, False,
                             torch.device("cuda", 0), time.perf_counter(),
                             control=not args.fault)
        line = {"workload": cell.name, "seed": seed, "fault": args.fault,
                "program": {k: c["value"]
                            for k, c in result["checks"].items()},
                "correct": result["correct"]}
        if not args.fault:
            line["control"] = {k: c["value"]
                               for k, c in result["control"].items()}
            line["control_correct"] = all(
                c["ok"] for c in result["control"].values())
        print(json.dumps(line), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
