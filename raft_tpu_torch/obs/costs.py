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

Not ported: the compiled accounting (``compile_entry``,
``collective_bytes_from_hlo``) and the planner-workspace calibration audit
that reads it; they need a CUDA analog of XLA's compiled cost and memory
analysis (ROADMAP Queue A, item 15).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

__all__ = [
    "ChipPeaks", "CHIP_PEAKS", "H100_PEAKS", "peaks_for_device_kind",
    "peaks_for_device", "EntryCost", "apply_roofline", "roofline_bound",
    "tf32_bound", "CostReport", "build_report", "default_cost_entries",
    "export_gauges", "l2_topk_work", "l2_argmin_work", "ivf_topk_work",
    "pq_topk_work", "select_k_work", "cagra_topk_work", "ivf_scan_work",
    "ring_shift_work",
]


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
    """One entry's cost record (the JAX package's fields; the compiled
    ones, ``temp_bytes`` to ``output_bytes``, stay None)."""

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
    collective_bytes: Optional[int] = None
    predicted_collective_bytes: Optional[int] = None
    arithmetic_intensity: Optional[float] = None
    bound: Optional[str] = None  # "memory" | "compute"
    peak_utilization: Optional[float] = None
    min_time_us: Optional[float] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


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
    """The report: per-entry costs and the device they were placed for."""

    platform: str
    device_kind: str
    peaks: Optional[ChipPeaks]
    entries: list  # of EntryCost

    def to_dict(self) -> dict:
        return {
            "schema": "raft_tpu.perf_report/v1",
            "platform": self.platform,
            "device_kind": self.device_kind,
            "peaks": dataclasses.asdict(self.peaks) if self.peaks else None,
            "entries": [e.to_dict() for e in self.entries],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def format(self) -> str:
        lines = [f"perf report — platform={self.platform} "
                 f"device_kind={self.device_kind!r}"]
        for e in self.entries:
            line = (f"  {e.name}: {e.flops / 1e9:.2f} GFLOP, "
                    f"{e.hbm_bytes / 2**20:.0f} MiB")
            if e.arithmetic_intensity is not None:
                line += f", AI {e.arithmetic_intensity:.1f}"
            if e.bound:
                line += f" [{e.bound}-bound, min {e.min_time_us:.0f} us]"
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

