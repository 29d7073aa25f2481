"""The traced run: ``torch.profiler`` over the window, read back as device
intervals, the harness's own host spans, and the port's kernel names.

Device time is what the profiler's CUDA activity records: kernels, copies
and memsets, each an interval on the card. Busy time is the union of those
intervals inside the window; an idle gap is a stretch of the window that no
interval covers, named by the harness span the host was in at its middle
(``batch.call``, ``batch.readback``, ``build.call``; ``between`` outside
them).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

import torch

WINDOW_SPAN = "vsbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def kernel_name(name: str) -> str:
    """A kernel's own identifier: from a demangled name (``void
    ns::grouped_topk_kernel<float, 8>(GroupArgs)``) the last identifier
    before its template arguments or parameters; from a mangled one, as
    ``raft_tpu_torch/obs/costs.kernel_name`` reads it, the first
    length-prefixed identifier that ends in "kernel"."""
    if name.startswith("_Z"):
        for m in re.finditer(r"\d+(?=[A-Za-z_])", name):
            digits = m.group()
            for j in range(len(digits)):
                ident = name[m.end():m.end() + int(digits[j:])]
                if len(ident) == int(digits[j:]) and ident.endswith("kernel"):
                    return ident
        return name
    name = name.replace("(anonymous namespace)::", "")
    head = name.removeprefix("void ").split("<", 1)[0].split("(", 1)[0]
    return head.strip().rsplit("::", 1)[-1]


def port_kernels(csrc: Path) -> Dict[str, Set[str]]:
    """Each source file of the port's kernels (by stem) → the names of the
    ``__global__`` functions it defines."""
    out = {}
    for path in sorted(csrc.glob("*.cu*")):
        out[path.stem] = set(_GLOBAL.findall(path.read_text()))
    return out


def _union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """One traced window, times in seconds on the profiler's clock."""

    def __init__(self, events: List[dict], span_names: Iterable[str]):
        span_names = set(span_names)
        self.ops: List[Tuple[str, str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        window = None
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            t0 = float(ev["ts"]) * 1e-6
            t1 = t0 + float(ev["dur"]) * 1e-6
            cat, name = ev.get("cat", ""), ev.get("name", "")
            if cat in DEVICE_CATEGORIES:
                self.ops.append((cat, name, t0, t1))
            elif cat == "user_annotation":
                if name == WINDOW_SPAN:
                    window = (t0, t1)
                elif name in span_names:
                    self.spans.append((name, t0, t1))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        self.t0, self.t1 = window
        self.ops = [(c, n, max(s, self.t0), min(e, self.t1))
                    for c, n, s, e in self.ops if e > self.t0 and s < self.t1]
        self.spans.sort(key=lambda s: s[1])
        self.busy = _union((s, e) for _, _, s, e in self.ops)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernel_s(self, names: Optional[Set[str]] = None,
                 exclude: Optional[Set[str]] = None) -> float:
        """Summed seconds of the kernels named in ``names`` (all kernels by
        default), less those in ``exclude``."""
        total = 0.0
        for cat, name, s, e in self.ops:
            if cat != "kernel":
                continue
            short = kernel_name(name)
            if names is not None and short not in names:
                continue
            if exclude is not None and short in exclude:
                continue
            total += e - s
        return total

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for cat, name, s, e in self.ops:
            by[kernel_name(name) if cat == "kernel" else cat] += e - s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_by_span(self, n: int = 10) -> List[list]:
        """Idle seconds of the window by the host span at each gap's
        middle, largest first."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        by = defaultdict(float)
        starts = [s for _, s, _ in self.spans]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            name = "between"
            if i >= 0 and self.spans[i][2] >= mid:
                name = self.spans[i][0]
            by[name] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]


class Tracer:
    """Spans around the calls into the program; with ``enabled``, the
    profiler over the window and its trace read back."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[Trace] = None
        self._names: Set[str] = set()

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        self._names.add(name)
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.trace = Trace(events, self._names)
