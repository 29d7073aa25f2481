"""One run of one cell of the port's benchmark.

    python3 -m vsbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Everything a cell is made of is found by
name, so that a cell, a configuration, a traffic mix or a metric is added
as new files and a new entry of ``BENCHMARK.json``:

- ``vsbench/workloads/<cell>.json``: the configuration, the traffic mix,
  the chips, why the cell exists, and the limit of each number compared
  (``recall`` a floor, every other number a ceiling);
- ``vsbench/configs/<config>.json``: the deployment's sizes, index and
  search parameters, its family, what was assumed and reduced;
- ``vsbench/families/<family>.py``: build, search and the index's state
  through the port's entry points;
- ``vsbench/traffic/<mix>.json``: the mix's parameters and its ``kind``;
  ``vsbench/traffic/<kind>.py`` the generator that runs it;
- ``vsbench/metrics/<metric>.py``: the reader of one per-layer metric.

A run makes the cell's inputs from the seed on the card, builds and warms
(set-up), measures for ``--seconds``, and with ``--trace 1`` reads the
per-layer metrics instead of the end-to-end ones: the host's times from a
first window without the profiler, the device's from a second, profiled
window. It then
frees the index, judges the answers against the plain reference in
``vsbench/reference``, and prints one JSON line. It refuses to run, and
prints nothing on standard output, without a CUDA card for each chip the
cell asks for.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
#: every cache of a run, at a fixed path in the checkout, so that only a
#: checkout's first run compiles (the port's nvcc libraries already build
#: into build/raft_tpu_torch/ there)
CACHE = ROOT / "build" / "vsbench"
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    spec: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])


def _read(root: Path, folder: str, name: str) -> dict:
    return json.loads((root / "vsbench" / folder / f"{name}.json").read_text())


def load_module(root: Path, folder: str, name: str) -> ModuleType:
    """``vsbench/<folder>/<name>.py`` under ``root``, loaded by its path."""
    path = root / "vsbench" / folder / f"{name}.py"
    safe = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(
        f"vsbench_{folder}_{safe}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, name: str) -> Cell:
    spec = _read(root, "workloads", name)
    return Cell(name, root, spec, _read(root, "configs", spec["config"]),
                _read(root, "traffic", spec["traffic"]))


def cell_metrics(benchmark: dict, section: str, cell: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in benchmark[section]
            if cell in m.get("workloads", [cell])]


#: numbers that must reach their limit; every other must stay under it
FLOORS = ("recall",)


def compare(cell: Cell, numbers: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit: counts of faults have the limit 0,
    every other number the cell's limit."""
    out = {}
    for name, value in numbers.items():
        if name == "answers":
            out[name] = {"value": value, "limit": 1, "ok": value >= 1}
        elif name in ("invalid", "ids_once"):
            out[name] = {"value": value, "limit": 0, "ok": value <= 0}
        elif name in FLOORS:
            limit = float(cell.spec["limits"][name])
            out[name] = {"value": value, "limit": limit, "ok": value >= limit}
        else:
            limit = float(cell.spec["limits"][name])
            out[name] = {"value": value, "limit": limit, "ok": value <= limit}
    return out


def pin_caches() -> None:
    """Point the caches of Triton and of CUDA's JIT into the checkout;
    before torch is imported."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class _Builds:
    """Counts the kernel libraries the port builds with nvcc."""

    def __init__(self, gk):
        self.n = 0
        gk.BUILD_LISTENERS.append(self)

    def __call__(self, n_builds: int, seconds: float) -> None:
        self.n += n_builds


def execute(cell: Cell, benchmark: dict, seed: int, seconds: float,
            trace: bool, device, t_start: float,
            control: bool = False) -> dict:
    """Run ``cell`` on ``device`` and return its result line (``control``:
    also the control's numbers, under ``"control"``)."""
    import torch

    from raft_tpu_torch.ops import gpu_kernels as gk
    from vsbench import readers
    from vsbench.trace import Tracer, port_kernels

    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    builds = _Builds(gk)
    family = load_module(cell.root, "families", cell.config["family"])
    kind = load_module(cell.root, "traffic", cell.traffic["kind"])
    run = kind.Run(cell, family, seed, device)
    t_port = time.perf_counter()
    run.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    phases = {"start": t_port - t_start, **run.phases}
    print("vsbench: set-up phases " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items()), file=sys.stderr)
    built_before = builds.n
    if trace:  # the host's own times, without the profiler's cost
        run.window(seconds, Tracer(False))
    tracer = Tracer(trace)
    with tracer.window():
        run.window(seconds, tracer)
    gk.BUILD_LISTENERS.remove(builds)
    if builds.n != built_before:
        raise RuntimeError(f"{builds.n - built_before} kernel libraries "
                           "were built inside the window")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run.release(control=control)
    metrics = {}
    if trace:
        view = readers.View(tracer.trace, run, port_kernels(gk.CSRC))
        for m in cell_metrics(benchmark, "per_layer", cell.name):
            value = load_module(cell.root, "metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(run.end_to_end(), setup_s=(setup_s, "s"))
        for m in cell_metrics(benchmark, "end_to_end", cell.name):
            value, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    t_judge = time.perf_counter()
    checks = compare(cell, run.judge())
    print(f"vsbench: set-up {setup_s:.3f} s, window {seconds} s, judged in "
          f"{time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": (torch.cuda.get_device_name(device) if on_card
                         else device.type),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = tracer.trace.busy_s
        dev_info["window_s"] = tracer.trace.window_s
        result["breakdown"] = {"device_ops": tracer.trace.top_ops(),
                               "idle_gaps": tracer.trace.idle_by_span()}
    if control:
        result["control"] = compare(cell, run.control())
    result["checks"] = checks
    return result


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    pin_caches()
    parser = argparse.ArgumentParser(prog="python3 -m vsbench",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(ROOT, args.workload)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"vsbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 3
    result = execute(cell, benchmark, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"vsbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0
