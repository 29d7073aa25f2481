"""Roofline cost reports of the port's kernels.

Counterpart of ``raft_tpu.obs.costs``. The JAX package asks XLA for each
canonical entry point's FLOPs, bytes accessed and workspace
(``compiled.cost_analysis()``/``memory_analysis()``) and places them on a
roofline against the chip's peaks. The port's hot path is its eight
hand-written kernels, whose work is known from their inputs, so here each
entry's operations and bytes are counted by formula: every input read
once, every output written once, and the operations the function must do
on these inputs. ``chip_smoke.py`` computes each kernel's ``bound_ms`` from
the same formulas with the counts its run's data gave (rows scanned, lists
probed, rows a beam touched), and ``planner.sweep`` its
``roofline_min_ms``: one formula serves all three.

Peaks (:data:`CHIP_PEAKS`) are public data-sheet numbers per chip, matched
by a substring of the device's name: the JAX package's TPUs, and the NVIDIA
H100 SXM (``torch.cuda.get_device_name`` "NVIDIA H100 80GB HBM3"): 67
TFLOP/s fp32 outside the tensor cores, 495 TFLOP/s dense TF32 on them (the
3xTF32 products' figure), 3.35 TB/s HBM3.

The measured accounting, raft_tpu's compiled accounting's counterpart.
raft_tpu compiles each canonical entry and reads XLA's ``memory_analysis``
(the workspace a planner predicted) and the collectives of the compiled
program. The port has no compiler to ask; it runs the entry instead
(:func:`measure_entry`, the entries of
``analysis.memory_audit.default_entries``):

- on the card, the caching allocator's peak over the call
  (``reset_peak_memory_stats``, then ``max_memory_allocated`` less the
  bytes live before it), the kernels the call launched
  (``gpu_kernels.LAUNCHES``) and each one's ptxas figures (registers,
  spills, static shared memory: :func:`ptxas_figures`);
- on the CPU, the memory audit's figure (the route under a dispatch mode,
  on fake tensors).

:meth:`CostReport.calibration_findings` then gives C001 where a planner's
predicted workspace and the measured one drift beyond
:data:`DEFAULT_DRIFT_TOLERANCE` either way, and where the bytes a rank
receives in a sharded merge (counted by ``parallel.comms``:
:func:`merge_entries`) drift from ``core.resources.solve_merge_bytes``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

from raft_tpu_torch.analysis.findings import Finding

__all__ = [
    "ChipPeaks", "CHIP_PEAKS", "H100_PEAKS", "peaks_for_device_kind",
    "peaks_for_device", "EntryCost", "apply_roofline", "roofline_bound",
    "tf32_bound", "CostReport", "build_report", "default_cost_entries",
    "export_gauges", "l2_topk_work", "l2_argmin_work", "ivf_topk_work",
    "pq_topk_work", "select_k_work", "cagra_topk_work", "ivf_scan_work",
    "ring_shift_work", "COST_RULE", "COST_FILE", "DEFAULT_DRIFT_TOLERANCE",
    "measure_entry", "merge_entries", "ptxas_figures", "calibrate",
]

COST_RULE = "C001"
COST_FILE = "cost-calibration"

#: planner-predicted vs measured workspace drift beyond this ratio (either
#: direction) raises a C001 finding
DEFAULT_DRIFT_TOLERANCE = 1.5


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Peak throughput of the arithmetic a bound counts (fp32 outside the
    tensor cores on a GPU, the MXU's on a TPU) and the memory bandwidth,
    per chip; ``tf32_flops_per_s`` the tensor cores' dense TF32 rate where
    the chip has one."""

    flops_per_s: float
    hbm_bytes_per_s: float
    tf32_flops_per_s: Optional[float] = None

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte where the roofline's memory slope meets the compute
        ceiling; below it a kernel is bandwidth-bound."""
        return self.flops_per_s / self.hbm_bytes_per_s


#: NVIDIA H100 SXM5 80 GB (data sheet): 67 TFLOP/s fp32, 495 TFLOP/s dense
#: TF32, 3.35 TB/s
H100_PEAKS = ChipPeaks(67e12, 3.35e12, 495e12)

#: substring of the device's name (lower case) → peaks, matched
#: longest-substring-first. The H100 entry names the SXM card: the PCIe
#: and NVL H100s have other peaks.
CHIP_PEAKS = {
    "h100 80gb hbm3": H100_PEAKS,
    "v6e": ChipPeaks(918e12, 1640e9),
    "v5p": ChipPeaks(459e12, 2765e9),
    "v5e": ChipPeaks(197e12, 819e9),
    "v5 lite": ChipPeaks(197e12, 819e9),
    "v4": ChipPeaks(275e12, 1228e9),
    "v3": ChipPeaks(123e12, 900e9),
    "v2": ChipPeaks(45e12, 700e9),
}


def peaks_for_device_kind(device_kind: str) -> Optional[ChipPeaks]:
    """Look up :data:`CHIP_PEAKS` by substring (None for CPU/unknown)."""
    kind = device_kind.lower()
    for sub in sorted(CHIP_PEAKS, key=len, reverse=True):
        if sub in kind:
            return CHIP_PEAKS[sub]
    return None


def peaks_for_device(device=None) -> Optional[ChipPeaks]:
    """Peaks of a torch device (default: the current card); None on the
    CPU or an unknown card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return peaks_for_device_kind(torch.cuda.get_device_name(device))


# ----------------------------------------------------------- the formulas
#
# Each returns (bytes, operations) of one call: inputs read once, outputs
# written once. Where the work depends on the data (rows in the probed
# lists, lists probed, a beam's walk), the caller passes what its data
# needs.


def l2_topk_work(m: int, n: int, dim: int, k: int) -> Tuple[int, int]:
    """``fused_l2_topk``: x [m, dim], y [n, dim] and both norms read, the
    top k values and ids written; a multiply-add per (x, y, dim)."""
    return 4 * (m * dim + n * dim + m + n) + 8 * m * k, 2 * m * n * dim


def l2_argmin_work(m: int, n: int, dim: int) -> Tuple[int, int]:
    """``fused_l2_argmin``: as ``l2_topk_work`` with one value and id a
    row."""
    return 4 * (m * dim + n * dim + m + n) + 8 * m, 2 * m * n * dim


def ivf_topk_work(nq: int, n_probes: int, rot: int, pad: int,
                  elem_bytes: int, k: int, n_probed: int,
                  rows_scanned: int) -> Tuple[int, int]:
    """``fused_ivf_topk``: the probes, each (query, probe)'s residual and
    norm, each probed slab with its norms and ids once, the result; 2·rot
    operations a filled slot scanned."""
    return (4 * nq * n_probes * (rot + 2)
            + n_probed * pad * (rot * elem_bytes + 8) + 8 * nq * k,
            2 * rot * rows_scanned)


def pq_topk_work(nq: int, n_probes: int, rot: int, n_lists: int,
                 pq_dim: int, pq_len: int, pad: int, k: int, n_probed: int,
                 rows_scanned: int, book: int = 256) -> Tuple[int, int]:
    """``fused_pq_topk``: the probes, rotated queries, rotated centres,
    codebooks and their norms, each probed list's codes and ids once, the
    result; each (query, probe)'s LUT (2·pq_len + 2 operations an entry)
    and one add a (row, subspace) scanned."""
    return (4 * (nq * n_probes + nq * rot + n_lists * rot
                 + pq_dim * book * pq_len + pq_dim * book)
            + n_probed * pad * (pq_dim + 4) + 8 * nq * k,
            nq * n_probes * pq_dim * book * (2 * pq_len + 2)
            + rows_scanned * pq_dim)


def select_k_work(rows: int, n: int, k: int,
                  with_ids: bool) -> Tuple[int, int]:
    """``select_k``: the values (and ids) read, the top k written; one
    comparison a value."""
    return 4 * rows * n * (2 if with_ids else 1) + 8 * rows * k, rows * n


def cagra_topk_work(nq: int, dim: int, degree: int, k: int, n_seeds: int,
                    rows_touched: int, nodes_expanded: int,
                    rows_scored: int) -> Tuple[int, int]:
    """``fused_cagra_topk``: each row the walk touches read once, each
    expanded node's graph row once, the queries, their norms and seeds, the
    result; a dot product per (query, row) scored and a norm per row
    touched."""
    return (rows_touched * dim * 4 + nodes_expanded * degree * 4
            + 4 * nq * (dim + 1 + n_seeds) + 8 * nq * k,
            2 * dim * (rows_scored + rows_touched))


def ivf_scan_work(t: int, n_probes: int, rot: int, pad: int,
                  elem_bytes: int, n_probed: int) -> Tuple[int, int]:
    """``ivf_scan``: the probes and residuals, each probed slab with its
    norms once, every probed slot's partial written; 2·rot operations a
    slot."""
    slots = t * n_probes * pad
    return (4 * (t * n_probes + t * n_probes * rot)
            + n_probed * pad * (rot * elem_bytes + 4) + 4 * slots,
            2 * rot * slots)


def ring_shift_work(ranks: int, block_bytes: int) -> Tuple[int, int]:
    """``ring_shift``: every block read and written once."""
    return 2 * ranks * block_bytes, 0


def roofline_bound(n_bytes: float, n_ops: float,
                   peaks: Optional[ChipPeaks] = None) -> dict:
    """The least time the chip could take: the larger of the bytes over its
    memory rate and the operations over its arithmetic peak.
    ``{"bound_ms", "bound_by"}``, the keys of ``chip_smoke.py``'s kernels
    line; ``peaks`` defaults to the H100's."""
    p = peaks or H100_PEAKS
    t_bytes, t_ops = n_bytes / p.hbm_bytes_per_s, n_ops / p.flops_per_s
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def tf32_bound(n_bytes: float, n_ops: float,
               peaks: Optional[ChipPeaks] = None) -> dict:
    """The design figure of a 3xTF32 product: three TF32 products of
    ``n_ops`` at the tensor cores' rate, or the bytes.
    ``{"bound_3xtf32_ms", "bound_3xtf32_by"}``."""
    p = peaks or H100_PEAKS
    tc = 3 * n_ops / p.tf32_flops_per_s
    t_bytes = n_bytes / p.hbm_bytes_per_s
    return {"bound_3xtf32_ms": 1e3 * max(tc, t_bytes),
            "bound_3xtf32_by": ("operations (3xTF32)" if tc > t_bytes
                                else "bytes")}


# ------------------------------------------------------------- the report


@dataclasses.dataclass
class EntryCost:
    """One entry's cost record, with the JAX package's fields.
    ``temp_bytes`` is the measured workspace (:func:`measure_entry`: the
    allocator's peak on the card, the memory audit's on the CPU) and
    ``compile_s`` the seconds the measured call took; ``argument_bytes`` and
    ``output_bytes`` stay None. ``launches`` and ``ptxas`` are the port's:
    the kernels the call launched and their ptxas figures."""

    name: str
    family: str
    flops: Optional[float]
    hbm_bytes: Optional[float]
    temp_bytes: Optional[int] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    compile_s: float = 0.0
    planner: Optional[str] = None
    predicted_bytes: Optional[int] = None
    tiles: dict = dataclasses.field(default_factory=dict)
    # cross-rank accounting (sharded merge entries): the bytes each rank
    # received, counted by parallel.comms, against solve_merge_bytes
    collective_bytes: Optional[int] = None
    predicted_collective_bytes: Optional[int] = None
    arithmetic_intensity: Optional[float] = None
    bound: Optional[str] = None  # "memory" | "compute"
    peak_utilization: Optional[float] = None
    min_time_us: Optional[float] = None
    device: str = "cpu"
    launches: dict = dataclasses.field(default_factory=dict)
    ptxas: dict = dataclasses.field(default_factory=dict)

    @property
    def drift_ratio(self) -> Optional[float]:
        """predicted / measured workspace; None when either side is missing
        (no planner, or nothing measured)."""
        if self.predicted_bytes is None or not self.temp_bytes:
            return None
        return self.predicted_bytes / self.temp_bytes

    @property
    def collective_drift_ratio(self) -> Optional[float]:
        """predicted / counted per-rank receive bytes of a sharded merge."""
        if self.predicted_collective_bytes is None or \
                not self.collective_bytes:
            return None
        return self.predicted_collective_bytes / self.collective_bytes

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["drift_ratio"] = self.drift_ratio
        d["collective_drift_ratio"] = self.collective_drift_ratio
        return d


def apply_roofline(entry: EntryCost, peaks: Optional[ChipPeaks]) -> None:
    """Fill the roofline fields in place. Arithmetic intensity needs only
    the counts; regime + utilization also need chip peaks."""
    if entry.flops and entry.hbm_bytes:
        entry.arithmetic_intensity = entry.flops / entry.hbm_bytes
    if peaks is None or entry.arithmetic_intensity is None:
        return
    ai = entry.arithmetic_intensity
    if ai < peaks.ridge_intensity:
        entry.bound = "memory"
        t = entry.hbm_bytes / peaks.hbm_bytes_per_s
    else:
        entry.bound = "compute"
        t = entry.flops / peaks.flops_per_s
    entry.min_time_us = t * 1e6
    # roofline-attainable fraction of the chip's peak at this intensity:
    # 1.0 on the compute ceiling, AI/ridge on the bandwidth slope
    entry.peak_utilization = min(1.0, ai / peaks.ridge_intensity)


def _entry(name: str, family: str, work: Tuple[int, int],
           **tiles) -> EntryCost:
    return EntryCost(name=name, family=family, flops=float(work[1]),
                     hbm_bytes=float(work[0]), tiles=dict(tiles))


def default_cost_entries() -> List[EntryCost]:
    """The main path's kernels at ``chip_smoke.py``'s shapes (sift-1M's
    1,000,000 × 128 rows, 10,000 queries, k = 10, 1,024 lists). Where the
    work depends on the data the entry assumes full lists (every probed
    list holds rows / lists rows) and, for CAGRA, one node expanded and
    every graph neighbour scored an iteration; ``chip_smoke.py`` counts
    its run's data instead."""
    nq, n, dim, k, lists, probes, pad = 10_000, 1_000_000, 128, 10, 1024, \
        32, 1456
    per_list = n // lists
    scanned = nq * probes * per_list
    itopk, degree, max_iter = 64, 32, 64
    return [
        _entry("fused_l2_topk@1m", "brute_force",
               l2_topk_work(nq, n, dim, k), m=nq, n=n, dim=dim, k=k),
        _entry("fused_ivf_topk@1m", "ivf_flat",
               ivf_topk_work(nq, probes, dim, pad, 4, k, lists, scanned),
               n_probes=probes, pad=pad, row_type="f32"),
        _entry("fused_ivf_topk.bf16@1m", "ivf_pq",
               ivf_topk_work(nq, probes, dim, pad, 2, k, lists, scanned),
               n_probes=probes, pad=pad, row_type="bf16"),
        _entry("fused_pq_topk@1m", "ivf_pq",
               pq_topk_work(nq, probes, dim, lists, 64, 2, pad, k, lists,
                            scanned),
               n_probes=probes, pq_dim=64, pq_len=2),
        _entry("select_k.coarse@1m", "ivf_flat",
               select_k_work(nq, lists, 32, False), n=lists, k=32),
        _entry("fused_cagra_topk@1m", "cagra",
               cagra_topk_work(nq, dim, degree, k, itopk,
                               nq * max_iter * degree, nq * max_iter,
                               nq * max_iter * degree),
               itopk=itopk, graph_degree=degree, max_iter=max_iter),
        _entry("fused_l2_argmin@1m", "kmeans",
               l2_argmin_work(n, 1024, dim), m=n, n=1024, dim=dim),
        _entry("ivf_scan@1m", "ivf_flat",
               ivf_scan_work(440, probes, dim, pad, 4, lists),
               t=440, n_probes=probes, pad=pad),
        _entry("ring_shift@4", "sharded_merge",
               ring_shift_work(4, 3 * nq * k * 4), ranks=4),
    ]


@dataclasses.dataclass
class CostReport:
    """The report: per-entry costs and the device they were placed for;
    for measured entries the budget they were planned against and the
    drift tolerance of the calibration."""

    platform: str
    device_kind: str
    peaks: Optional[ChipPeaks]
    entries: list  # of EntryCost
    budget_bytes: Optional[int] = None
    drift_tolerance: float = DEFAULT_DRIFT_TOLERANCE

    def calibration_findings(self) -> List[Finding]:
        """One C001 :class:`Finding` per planner whose drift ratio leaves
        ``[1/tol, tol]``, and per sharded merge whose counted receive bytes
        leave it around ``solve_merge_bytes`` — keyed by entry name so the
        baseline can carry a justification."""
        out = []
        tol = self.drift_tolerance
        for e in self.entries:
            r = e.drift_ratio
            if r is not None and e.planner is not None and \
                    not (1.0 / tol <= r <= tol):
                side = "over" if r > 1 else "under"
                out.append(Finding(
                    COST_RULE, COST_FILE, e.name, 0,
                    f"planner {e.planner} {side}-predicts workspace: "
                    f"predicted {e.predicted_bytes / 2**20:.0f} MiB vs "
                    f"measured {e.temp_bytes / 2**20:.0f} MiB on {e.device} "
                    f"(ratio {r:.2f}, tolerance {tol:g}x)"))
            c = e.collective_drift_ratio
            if c is not None and not (1.0 / tol <= c <= tol):
                side = "over" if c > 1 else "under"
                out.append(Finding(
                    COST_RULE, COST_FILE, f"{e.name}.collective", 0,
                    f"merge planner {e.planner} {side}-predicts the bytes a "
                    f"rank receives: predicted "
                    f"{e.predicted_collective_bytes} B vs counted "
                    f"{e.collective_bytes} B (ratio {c:.2f}, tolerance "
                    f"{tol:g}x)"))
        return out

    def to_dict(self) -> dict:
        return {
            "schema": "raft_tpu.perf_report/v1",
            "platform": self.platform,
            "device_kind": self.device_kind,
            "peaks": dataclasses.asdict(self.peaks) if self.peaks else None,
            "budget_bytes": self.budget_bytes,
            "drift_tolerance": self.drift_tolerance,
            "entries": [e.to_dict() for e in self.entries],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def format(self) -> str:
        lines = [f"perf report — platform={self.platform} "
                 f"device_kind={self.device_kind!r}"]
        for e in self.entries:
            line = f"  {e.name}:"
            if e.flops is not None and e.hbm_bytes is not None:
                line += (f" {e.flops / 1e9:.2f} GFLOP, "
                         f"{e.hbm_bytes / 2**20:.0f} MiB")
            if e.temp_bytes is not None:
                line += (f" workspace {e.temp_bytes / 2**20:.1f} MiB "
                         f"({e.device})")
            if e.arithmetic_intensity is not None:
                line += f", AI {e.arithmetic_intensity:.1f}"
            if e.bound:
                line += f" [{e.bound}-bound, min {e.min_time_us:.0f} us]"
            if e.drift_ratio is not None:
                line += f", planner drift {e.drift_ratio:.2f}x"
            if e.collective_bytes is not None:
                line += f", received {e.collective_bytes} B"
                if e.collective_drift_ratio is not None:
                    line += f" (drift {e.collective_drift_ratio:.2f}x)"
            lines.append(line)
        return "\n".join(lines)


def build_report(entries: Optional[List[EntryCost]] = None,
                 device=None, device_kind: Optional[str] = None
                 ) -> CostReport:
    """Place every entry (default: :func:`default_cost_entries`) on the
    roofline of ``device`` (default: the current card), or of the chip
    named by ``device_kind``."""
    if device_kind is None:
        import torch

        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        if device is not None and torch.device(device).type == "cuda":
            device_kind = torch.cuda.get_device_name(device)
            platform = "cuda"
        else:
            device_kind, platform = "cpu", "cpu"
    else:
        platform = "cuda" if "nvidia" in device_kind.lower() else "unknown"
    peaks = peaks_for_device_kind(device_kind)
    out = list(default_cost_entries() if entries is None else entries)
    for e in out:
        apply_roofline(e, peaks)
    return CostReport(platform=platform, device_kind=device_kind,
                      peaks=peaks, entries=out)


def export_gauges(report: CostReport, registry=None) -> None:
    """Mirror the report into registry gauges, so a scrape shows the cost
    picture next to the serving metrics."""
    from raft_tpu_torch.obs import metrics as m

    reg = registry if registry is not None else m.REGISTRY
    flops = reg.gauge("raft_tpu_cost_flops",
                      "counted operations per cost entry",
                      labelnames=("entry",))
    hbm = reg.gauge("raft_tpu_cost_hbm_bytes",
                    "counted bytes moved per cost entry",
                    labelnames=("entry",))
    floor = reg.gauge("raft_tpu_cost_min_time_us",
                      "roofline floor per cost entry (us)",
                      labelnames=("entry",))
    for e in report.entries:
        if e.flops is not None:
            flops.labels(e.name).set(e.flops)
        if e.hbm_bytes is not None:
            hbm.labels(e.name).set(e.hbm_bytes)
        if e.min_time_us is not None:
            floor.labels(e.name).set(e.min_time_us)



# ------------------------------------------------- the measured accounting


def ptxas_figures(lib) -> dict:
    """Registers, spills and static shared memory of each kernel of a
    library, from ptxas's report kept beside it (``gpu_kernels.build_all``
    writes nvcc's output to ``library_path(name).with_suffix(".log")``):
    kernel name → ``{"registers", "static_smem", "spill_stores",
    "spill_loads"}``. A device function's spill line is not credited to
    the kernel before it."""
    out, name, entry, props = {}, None, None, None
    for line in Path(lib).with_suffix(".log").read_text().splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            name = base = kernel_name(entry)
            suffix = 1
            while name in out:
                suffix += 1
                name = f"{base}#{suffix}"
            out[name] = {}
        elif "Function properties for" in line:
            props = line.split()[-1]  # a kernel's, or a device function's
        elif name and "spill stores" in line and props == entry:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def kernel_name(mangled: str) -> str:
    """The kernel's own identifier in a mangled name: the first
    length-prefixed identifier that ends in "kernel"."""
    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        digits = m.group()
        for j in range(len(digits)):
            ident = mangled[m.end():m.end() + int(digits[j:])]
            if len(ident) == int(digits[j:]) and ident.endswith("kernel"):
                return ident
    return mangled


def measure_entry(name: str, make: Callable, ctx: Optional[dict] = None,
                  budget_bytes: Optional[int] = None,
                  warm: bool = True) -> EntryCost:
    """Run one memory-audit entry (``make(budget, ctx)`` → ``(fn, meta)``,
    ``analysis.memory_audit``) and record what it takes — the counterpart
    of raft_tpu's ``compile_entry``.

    With ``ctx`` (the entry's inputs as real tensors on a card), the call
    runs there once to warm (its kernel builds and lazily made caches are
    not workspace) and once measured: the caching allocator's peak less the
    bytes live before the call, the kernels it launched and their ptxas
    figures. Without ``ctx`` (or on the CPU) the workspace is the memory
    audit's figure under ``FakeTensorMode``."""
    import torch

    from raft_tpu_torch.analysis import memory_audit as ma
    from raft_tpu_torch.ops import gpu_kernels as gk

    budget = ma.DEFAULT_BUDGET_BYTES if budget_bytes is None else \
        int(budget_bytes)
    dev = None
    if ctx is not None:
        dev = ctx["queries"].device
    if dev is None or dev.type != "cuda":
        t0 = time.perf_counter()
        if ctx is None:
            res = ma.AuditEntry(name, budget, make).run()
            temp, meta = res.peak_bytes, res.meta
        else:
            fn, meta = make(budget, ctx)
            temp = ma.peak_live_bytes(fn, resident=[ctx])
        return EntryCost(name=name, family=meta.get("family", "unknown"),
                         flops=None, hbm_bytes=None, temp_bytes=int(temp),
                         compile_s=time.perf_counter() - t0,
                         planner=meta.get("planner"),
                         predicted_bytes=meta.get("predicted_bytes"),
                         tiles=dict(meta.get("tiles", {})))
    fn, meta = make(budget, ctx)
    if warm:
        fn()
    torch.cuda.synchronize(dev)
    gk.reset_launch_counts()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - before
    del out
    launches = {k: v for k, v in gk.LAUNCHES.items() if v}
    ptxas = {}
    for kernel in launches:
        path = gk.library_path(kernel)
        if path.with_suffix(".log").exists():
            ptxas[kernel] = ptxas_figures(path)
    return EntryCost(name=name, family=meta.get("family", "unknown"),
                     flops=None, hbm_bytes=None, temp_bytes=int(peak),
                     compile_s=seconds, planner=meta.get("planner"),
                     predicted_bytes=meta.get("predicted_bytes"),
                     tiles=dict(meta.get("tiles", {})), device=str(dev),
                     launches=launches, ptxas=ptxas)


def merge_entries(comms, nq: int = 1024, kk: int = 100, k: int = 100,
                  seed: int = 0) -> List[EntryCost]:
    """The three sharded merges (allgather, tree, ring) of per-rank [nq,
    kk] candidates over ``comms``, each rank's received bytes counted by
    the communicator against ``core.resources.solve_merge_bytes``; the ring
    hops through ``gpu_kernels.ring_shift`` on CUDA ranks. Returns one
    entry a merge, ``collective_bytes`` the largest count of any rank."""
    import torch

    from raft_tpu_torch.core.resources import solve_merge_bytes
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops.select_k import select_k

    size = comms.size
    k_out = min(int(k), size * kk)
    predicted = solve_merge_bytes(size, nq, kk, k_out)
    gen = torch.Generator().manual_seed(seed)
    vs = comms.shard(torch.rand((size * nq, kk), generator=gen), 0)
    ids = comms.shard(torch.randint(0, 1 << 30, (size * nq, kk),
                                    generator=gen, dtype=torch.int32), 0)
    cuda = comms.devices[0].type == "cuda"

    def allgather():
        v_all = comms.allgather(vs, axis=1)
        i_all = comms.allgather(ids, axis=1)
        return [None if va is None else select_k(va, k_out)
                for va in v_all], i_all

    merges = {"allgather": allgather,
              "tree": lambda: comms.tree_topk_merge(vs, ids, k_out),
              "ring": lambda: comms.ring_topk_merge(
                  vs, ids, k_out, shift=gk.ring_shift if cuda else None)}
    out = []
    for mode, merge in merges.items():
        if mode == "tree" and size & (size - 1):
            continue
        launches0 = gk.LAUNCHES["ring_shift"]
        comms.reset_received()
        t0 = time.perf_counter()
        merge()
        if cuda:
            torch.cuda.synchronize(comms.devices[0])
        got = max(comms.received.values(), default=0)
        out.append(EntryCost(
            name=f"sharded_merge_{mode}@s{size}", family="sharded_merge",
            flops=None, hbm_bytes=None, compile_s=time.perf_counter() - t0,
            planner="solve_merge_bytes",
            tiles={"size": size, "nq": nq, "kk": kk, "k_out": k_out},
            collective_bytes=int(got),
            predicted_collective_bytes=int(predicted[mode]),
            device=str(comms.devices[0]),
            launches={"ring_shift": gk.LAUNCHES["ring_shift"] - launches0}))
    return out


def calibrate(entries: Optional[list] = None, ctx: Optional[dict] = None,
              budget_bytes: Optional[int] = None, comms=None,
              drift_tolerance: float = DEFAULT_DRIFT_TOLERANCE
              ) -> CostReport:
    """Measure every memory-audit entry (default: all of
    ``memory_audit.default_entries``'s makers, as ``(name, make)`` pairs)
    and, given ``comms``, the three merges, into a :class:`CostReport`
    whose :meth:`~CostReport.calibration_findings` are the C001 gate."""
    from raft_tpu_torch.analysis import memory_audit as ma

    budget = ma.DEFAULT_BUDGET_BYTES if budget_bytes is None else \
        int(budget_bytes)
    pairs = list(ma.ENTRY_MAKERS) if entries is None else list(entries)
    out = [measure_entry(name, make, ctx, budget) for name, make in pairs]
    if comms is not None:
        out += merge_entries(comms)
    device = ctx["queries"].device if ctx is not None else None
    report = build_report(out, device=device)
    report.budget_bytes = budget
    report.drift_tolerance = drift_tolerance
    return report
