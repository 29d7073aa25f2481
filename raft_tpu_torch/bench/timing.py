"""Timing primitives shared by the port's benchmark entry points.

Counterpart of ``raft_tpu.bench.timing``. On the card a kernel launch
returns before the kernel ends, so a timed region must end in a fence that
waits for the device work it measures: here ``torch.cuda.synchronize`` of
every device the outputs lie on (the CUDA-event timing of the reference's
benches fences the same way). The JAX package's version also works around a
remote TPU link whose ``block_until_ready`` returned at the enqueue and
whose readback cost about 80 ms: it subtracts a measured round trip from
each loop and grows a loop's iterations until the work dwarfs it. A local
card has neither problem (a synchronize on idle work costs microseconds and
waits for the work it fences), so this module subtracts nothing and scales
nothing; ``fence_overhead`` still reports the fence's own cost.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List

import numpy as np
import torch

__all__ = [
    "fence",
    "fence_index",
    "fence_overhead",
    "prepare",
    "time_dispatches",
    "time_latency_chained",
    "chain_perturb",
    "last_info",
]

#: Filled by ``time_dispatches`` / ``time_latency_chained`` after every
#: measurement: ``{"fence_overhead_frac": float, "samples_s": [per-round
#: per-call seconds]}``. Read it right after the timing call: the next one
#: overwrites it.
last_info: dict = {"fence_overhead_frac": 0.0, "samples_s": []}


def _leaves(out: Any) -> List[torch.Tensor]:
    """The tensors of a nested tuple/list/dict (other leaves ignored)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return []


def fence(out: Any) -> int:
    """Wait until the work producing ``out``'s tensors has finished: one
    ``torch.cuda.synchronize`` per CUDA device they lie on (CPU tensors are
    done when they are returned). Returns the number of tensor leaves (0:
    host data, nothing to wait for)."""
    leaves = _leaves(out)
    for dev in {t.device for t in leaves if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return len(leaves)


def fence_index(index: Any) -> None:
    """Fence a built index: every tensor attribute it holds."""
    fence(list(getattr(index, "__dict__", {}).values()))


_FENCE_OVERHEAD_S = None


def fence_overhead() -> float:
    """Median seconds of a fence on finished work (a synchronize on the
    card; about zero on the CPU). Measured once per process; reported, not
    subtracted."""
    global _FENCE_OVERHEAD_S
    if _FENCE_OVERHEAD_S is None:
        dev = torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
        x = torch.zeros(8, device=dev)
        fence(x)
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            fence(x)
            samples.append(time.perf_counter() - t0)
        _FENCE_OVERHEAD_S = sorted(samples)[1]
    return _FENCE_OVERHEAD_S


def _record(elapsed: float, samples: List[float], fenced: bool) -> None:
    last_info["samples_s"] = list(samples)
    last_info["fence_overhead_frac"] = round(
        fence_overhead() / max(elapsed, 1e-12), 4) if fenced else 0.0


def prepare(x: Any, device=None) -> Any:
    """Inputs on the device before a timed region: numpy arrays become
    tensors on ``device`` (default: the card when there is one), tensors
    stay where they are; fenced, so no copy runs into the timing."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"

    def _put(a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if isinstance(a, (list, tuple)):
            return type(a)(_put(v) for v in a)
        if isinstance(a, dict):
            return {k: _put(v) for k, v in a.items()}
        return a

    out = _put(x)
    fence(out)
    return out


def time_dispatches(dispatch: Callable[[], Any], iters: int = 5,
                    warmup: int = 1) -> float:
    """Seconds per ``dispatch()``: ``warmup`` fenced calls, then ``iters``
    calls launched back to back and one fence at the end (throughput mode:
    the card stays fed by the calls in flight, as the reference harness's
    thread-pool mode keeps it)."""
    for _ in range(warmup):
        fence(dispatch())
    t0 = time.perf_counter()
    outs = [dispatch() for _ in range(iters)]
    fenced = fence(outs) > 0
    elapsed = time.perf_counter() - t0
    _record(elapsed, [elapsed / iters], fenced)
    return elapsed / iters


def time_latency_chained(step: Callable[[Any], Any], x0: Any,
                         iters: int = 8, rounds: int = 1) -> float:
    """Seconds per call when each call's input depends on the previous
    call's output (the caller encodes the dependency, for example with
    :func:`chain_perturb`), so the calls run one after another on the
    device; one fence per round. ``rounds > 1`` repeats the round and
    leaves one per-call sample per round in ``last_info["samples_s"]``;
    returns their mean."""
    fence(step(x0))  # warm
    samples = []
    elapsed = 0.0
    fenced = False
    for _ in range(max(int(rounds), 1)):
        t0 = time.perf_counter()
        out = x0
        for _ in range(iters):
            out = step(out)
        fenced = fence(out) > 0
        elapsed = time.perf_counter() - t0
        samples.append(elapsed / iters)
    _record(elapsed, samples, fenced)
    return sum(samples) / len(samples)


def chain_perturb(x: torch.Tensor, prev_out: Any) -> torch.Tensor:
    """``x`` plus zero times the first element of ``prev_out``'s first
    tensor: the same values, but data-dependent on the previous call, so
    chained calls run in order. A non-finite probe contributes 0 (inf * 0
    would turn every later input into NaN)."""
    leaves = _leaves(prev_out)
    if not leaves:
        return x
    p = leaves[0].reshape(-1)[:1].to(torch.float32)
    z = torch.where(torch.isfinite(p), p, torch.zeros_like(p)) * 0
    return x + z.to(x.dtype).to(x.device)
