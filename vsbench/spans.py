"""The program's own spans and counters in a cell's run.

``raft_tpu_torch`` names the steps inside its IVF searches with
``core.tracing`` spans (``<family>.search.plan``, ``.wait``, ``.coarse``,
``.scan``, ``.overflow``) and counts on its registry the host arrays a
search staged onto the card (``raft_tpu_host_sync_total{site}``), the
overflow rows scanned (``raft_tpu_overflow_rows_scanned_total``) and each
``select_k`` by its algorithm (``raft_tpu_select_k_total``). This module
reads them:

- ``counter_series``, ``counter_total`` and ``search_calls``: the
  program's counters over the run, for the ``search.staging_waits``,
  ``search.overflow_rows`` and ``select_k.calls`` readers;
- ``SpanTrace``: a ``vsbench.trace.Trace`` that also keeps the program's
  spans and each device operation's launch time (the correlation id of its
  ``cuda_runtime`` or ``cuda_driver`` launch event), and splits the device
  time and the idle gaps by the innermost program span; every number the
  ``Trace`` gives is the same. No run reads a trace through it yet: that
  takes ``vsbench/trace.py`` to build one in place of its ``Trace``;
- the command below, which sets a cell up as a run does and makes one
  window without the profiler, with span stats on, and prints the host ms
  a call by program span on standard error and one JSON line on standard
  output.

    python3 -m vsbench.spans --workload <cell> --seed <n> --seconds <s>
        [--sync-debug] [--span-cost N]

``--sync-debug`` makes one call of the cell's search, then one with the
batch on the host, under ``torch.cuda.set_sync_debug_mode("warn")`` and
counts the warnings; ``--span-cost N`` times N enters of a span with both
switches off, with span stats on, under the profiler, and a bare
``record_function`` for comparison. Neither is part of a benchmark run.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
import warnings
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from vsbench.trace import DEVICE_CATEGORIES, WINDOW_SPAN, Trace, Tracer

#: host events that launch device work and carry its correlation id
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
#: the key of a device operation whose launch no event records
UNATTRIBUTED = "(no launch event)"


def _registry():
    from raft_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY


def counter_series(name: str) -> Optional[List[Tuple[Dict[str, str],
                                                     float]]]:
    """``[(labels, value)]`` of each series of the program's counter
    ``name``; None where the program has no such counter."""
    fam = _registry().get(name)
    if fam is None:
        return None
    return [(dict(zip(fam.labelnames, key)), child.value)
            for key, child in fam.collect()]


def counter_total(name: str, **labels: str) -> Optional[float]:
    """The program's counter ``name`` summed over the series with the given
    label values; None where the program has no such counter."""
    series = counter_series(name)
    if series is None:
        return None
    return sum(value for got, value in series
               if all(got.get(k) == v for k, v in labels.items()))


def staging_waits(family: str) -> Optional[float]:
    """``raft_tpu_host_sync_total`` over the sites of ``family``'s search
    (``<family>.queries``, ``<family>.filter``)."""
    series = counter_series("raft_tpu_host_sync_total")
    if series is None:
        return None
    return sum(value for got, value in series
               if got.get("site", "").startswith(family + "."))


def search_calls(view) -> Optional[int]:
    """Search calls of the cell's family in this process, by the program's
    ``raft_tpu_dispatch_total`` (one a call): the warm-up and both
    windows."""
    calls = counter_total("raft_tpu_dispatch_total",
                          family=view.run.cfg["family"])
    return int(calls) if calls else None


def histogram_totals(name: str) -> Dict[str, Tuple[int, float]]:
    """``{label: (count, sum)}`` of the program's histogram ``name``."""
    fam = _registry().get(name)
    if fam is None:
        return {}
    out = {}
    for key, child in fam.collect():
        snap = child.snapshot()
        out[key[0] if key else ""] = (snap.count, snap.sum)
    return out


class SpanTrace(Trace):
    """A traced window with the program's spans and each device operation's
    launch time. ``program`` holds ``(name, t0, t1)`` of every
    ``user_annotation`` event that is neither the harness's nor the
    window's; ``launched`` holds ``(category, name, t0, t1, launch time or
    None)`` of each device operation of ``ops``, in the same order."""

    def __init__(self, events: List[dict], span_names: Iterable[str]):
        span_names = set(span_names)
        super().__init__(events, span_names)
        launch: Dict[int, float] = {}
        device = []
        self.program: List[Tuple[str, float, float]] = []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            t0 = float(ev["ts"]) * 1e-6
            t1 = t0 + float(ev["dur"]) * 1e-6
            cat, name = ev.get("cat", ""), ev.get("name", "")
            corr = (ev.get("args") or {}).get("correlation")
            if cat in DEVICE_CATEGORIES:
                device.append((cat, name, t0, t1, corr))
            elif cat in LAUNCH_CATEGORIES and corr is not None:
                launch[corr] = t0
            elif (cat == "user_annotation" and name != WINDOW_SPAN
                    and name not in span_names):
                if t1 > self.t0 and t0 < self.t1:
                    self.program.append((name, t0, t1))
        self.launched = [
            (c, n, max(s, self.t0), min(e, self.t1), launch.get(corr))
            for c, n, s, e, corr in device if e > self.t0 and s < self.t1]
        self.program.sort(key=lambda s: s[1])
        self._starts = [s for _, s, _ in self.program]
        self._longest = max((e - s for _, s, e in self.program), default=0.0)
        self._harness_starts = [s for _, s, _ in self.spans]

    def innermost(self, t: float) -> Optional[str]:
        """The innermost program span the host was in at time ``t``: of the
        spans that hold ``t``, the one that started last."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and t - self._starts[i] <= self._longest:
            name, s, e = self.program[i]
            if e >= t:
                return name
            i -= 1
        return None

    def _harness(self, t: float) -> str:
        i = bisect.bisect_right(self._harness_starts, t) - 1
        if i >= 0 and self.spans[i][2] >= t:
            return self.spans[i][0]
        return "between"

    def where(self, t: Optional[float]) -> str:
        """The program span at ``t``, else the harness span, else
        ``between``."""
        if t is None:
            return UNATTRIBUTED
        return self.innermost(t) or self._harness(t)

    def device_by_span(self) -> Dict[str, float]:
        """Device seconds of the window by the span that launched each
        operation."""
        by = defaultdict(float)
        for _, _, s, e, t in self.launched:
            by[self.where(t)] += e - s
        return dict(by)

    def idle_by_program_span(self) -> Dict[str, float]:
        """Idle seconds of the window by the innermost program span (else
        the harness span) the host was in at each gap's middle."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        by = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                by[self.where(0.5 * (a + b))] += b - a
        return dict(by)

    def launched_in(self, spans: Iterable[str], within: str) -> float:
        """Share of the device time launched inside the harness span
        ``within`` whose launch lies in one of the program ``spans``."""
        spans = set(spans)
        inside = total = 0.0
        for _, _, s, e, t in self.launched:
            if t is None or self._harness(t) != within:
                continue
            total += e - s
            if self.innermost(t) in spans:
                inside += e - s
        return inside / total if total else 0.0


def span_cost(n: int) -> Dict[str, float]:
    """Host ns a span enter and exit: both switches off, span stats on,
    under the profiler (CPU activity), and a bare ``record_function``
    (what every span cost before the switches) with the profiler off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.core import tracing

    def loop(enter) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with enter("vsbench.span_cost"):
                pass
        return 1e9 * (time.perf_counter() - t0) / n

    out = {"off": loop(tracing.span),
           "record_function": loop(torch.profiler.record_function)}
    with tracing.span_stats():
        out["stats"] = loop(tracing.span)
    with profile(activities=[ProfilerActivity.CPU]):
        out["profiler"] = loop(tracing.span)
    return out


def sync_debug(run) -> dict:
    """Warnings of ``torch.cuda.set_sync_debug_mode("warn")`` (each where it
    was raised) in one call of the run's search with the batch on the card,
    and in one with it on the host; and the program's staging waits
    (``raft_tpu_host_sync_total``) in each."""
    import torch

    out = {}
    for where, batch in (("card", run.batches[0]),
                         ("host", run.batches[0].cpu())):
        before = staging_waits(run.cfg["family"]) or 0.0
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run.search(batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out[f"{where}_sync_warnings"] = [
            f"{w.filename}:{w.lineno}: {w.message}" for w in caught
            if "called a synchronizing" in str(w.message)]
        out[f"{where}_staging_waits"] = int(
            (staging_waits(run.cfg["family"]) or 0.0) - before)
    return out


def measure(workload: str, seed: int, seconds: float, device,
            sync: bool = False, root=None) -> dict:
    """Set-up, as a run makes it, and one window without the profiler with
    span stats on, of the cell ``workload`` of the benchmark at ``root``
    (this checkout's by default); returns the host ms a call by span and
    the counters a call or a query over that window."""
    import torch

    from raft_tpu_torch.core import tracing
    from vsbench.run import ROOT, load_cell, load_module

    root = ROOT if root is None else root
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = load_cell(root, workload)
    family = cell.config["family"]
    kind = load_module(root, "traffic", cell.traffic["kind"])
    run = kind.Run(cell, load_module(root, "families", family), seed,
                   torch.device(device))
    run.setup()
    out = {"workload": workload, "seed": seed, "family": family,
           "index_overflow_rows": int(run.index.overflow_indices.shape[0])}
    if sync:
        out.update(sync_debug(run))

    def counters():
        return (staging_waits(family) or 0.0,
                counter_total("raft_tpu_overflow_rows_scanned_total",
                              family=family) or 0.0,
                counter_total("raft_tpu_select_k_total") or 0.0)

    before, c0 = histogram_totals("raft_tpu_span_seconds"), counters()
    with tracing.span_stats():
        run.window(seconds, Tracer(False))
    after, c1 = histogram_totals("raft_tpu_span_seconds"), counters()
    calls = len(run.untraced_returned)
    waits, rows, selects = (b - a for a, b in zip(c0, c1))
    out.update(
        calls=calls, return_ms=run.return_ms(),
        host_ms={k: 1e3 * (v[1] - before.get(k, (0, 0.0))[1]) / calls
                 for k, v in after.items()},
        span_counts={k: v[0] - before.get(k, (0, 0.0))[0]
                     for k, v in after.items()},
        staging_waits_per_call=waits / calls,
        overflow_rows_per_query=rows / (calls * run.batches[0].shape[0]),
        select_k_per_call=selects / calls)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from vsbench.run import pin_caches

    pin_caches()
    parser = argparse.ArgumentParser(prog="python3 -m vsbench.spans",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--sync-debug", action="store_true")
    parser.add_argument("--span-cost", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    out = {}
    if args.span_cost:
        out["span_cost_ns"] = span_cost(args.span_cost)
    if args.workload:
        out.update(measure(args.workload, args.seed, args.seconds,
                           args.device, args.sync_debug))
        print("vsbench.spans: host ms a call by program span (inclusive; "
              "window without the profiler):", file=sys.stderr)
        for name, ms in sorted(out["host_ms"].items(),
                               key=lambda kv: -kv[1]):
            print(f"  {name:32s} {ms:10.4f}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
