"""The port's hand-written CUDA kernels: build, wrappers, plain versions.

Counterpart of ``raft_tpu.ops.pallas_kernels`` for the kernels of this
slice. Each kernel has

- a source in ``raft_tpu_torch/csrc/`` with a plain C interface, compiled by
  ``nvcc`` for ``sm_90a`` into its own shared library at first use (into
  ``build/raft_tpu_torch/`` at the repo root, keyed by a hash of the sources
  and flags) and loaded with ``ctypes``;
- a wrapper that checks device, dtype, shape and contiguity, allocates the
  outputs, launches on PyTorch's current stream, raises if the launch
  failed, and adds one to its count in ``LAUNCHES`` (``fused_l2_topk``
  over several database ranges and the grouped routes of
  ``fused_ivf_topk`` and ``fused_pq_topk`` end in a launch of select_k's
  kernel, their per-query merge, counted under ``select_k`` and, by
  shape, in ``SELECT_K_SHAPES``);
- a plain PyTorch version of the same function, which the wrapper runs for
  tensors on the CPU and which the CPU tests and ``chip_smoke.py`` hold the
  kernel against.

A CUDA tensor always launches the kernel or raises; nothing falls back to
the plain version on the card. Launches go to the tensors' device, on
PyTorch's current stream there.

Selection order everywhere: ascending value; ties by candidate order (row
id for brute force, (probe, slot) for IVF and IVF-PQ, column for select_k,
buffer first and then position for CAGRA's beam merges); +inf yields id -1;
NaN is never selected. ``fused_l2_argmin`` is a 1-NN: the first minimum,
lowest y index on ties, also when the minimum is +inf; ``ivf_scan`` selects
nothing and writes every probed slot; ``ring_shift`` copies bytes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from raft_tpu_torch.ops.distance import dot_fp32, einsum_fp32, row_norms_sq

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raft_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name → source file
SOURCES = {
    "fused_l2_topk": "fused_l2_topk.cu",
    "fused_ivf_topk": "fused_ivf_topk.cu",
    "select_k": "select_k.cu",
    "fused_pq_topk": "fused_pq_topk.cu",
    "fused_cagra_topk": "fused_cagra_topk.cu",
    "fused_l2_argmin": "fused_l2_argmin.cu",
    "ivf_scan": "ivf_scan.cu",
    "ring_shift": "ring_shift.cu",
}

#: callables ``(n_builds, seconds)`` told of every ``build_all`` call that
#: ran ``nvcc`` (``obs.device`` counts the builds through this)
BUILD_LISTENERS: List[Callable[[int, float], None]] = []

#: launches of each kernel since the last ``reset_launch_counts()``
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
#: select_k's launches of ``LAUNCHES`` by (caller, row width, k): "select_k"
#: for ``streaming_select_k``, else the fused kernel whose per-query merge
#: it is
SELECT_K_SHAPES: Dict[Tuple[str, int, int], int] = {}

#: largest dynamic shared memory a block may ask for on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_K = 1024

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fused_l2_topk": [_VP, _VP, _VP, _VP, _I, _LL, _I, _I, _I, _I, _I, _I,
                      _LL, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    "fused_ivf_topk": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    "select_k_rows": [_VP, _VP, _LL, _LL, _I, _I, _I, _I, _VP, _VP, _VP],
    "select_k_route": [_LL, _I],
    "fused_pq_topk": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    "fused_cagra_topk": [_VP, _VP, _VP, _VP, _VP, _I, _LL, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _VP, _VP, _VP],
    "fused_l2_argmin": [_VP, _VP, _VP, _VP, _I, _LL, _I, _I, _I, _I, _I, _I,
                        _VP, _VP, _VP, _VP],
    "ivf_scan": [_VP, _VP, _VP, _I, _VP, _VP, _LL, _I, _I, _I, _I, _VP, _VP],
    "ivf_scan_group": [_VP, _LL, _I, _VP, _VP],
    "ring_shift_copy": [_VP, _VP, _I, _LL, _I, _VP],
    "ring_shift_enable_peer": [_I, _I],
}
#: the C functions of each library (default: the kernel's own name)
_FUNCTIONS = {"select_k": ["select_k_rows", "select_k_route"],
              "ivf_scan": ["ivf_scan", "ivf_scan_group"],
              "ring_shift": ["ring_shift_copy", "ring_shift_enable_peer"]}


#: the counts are bumped under this lock: the sharded builds launch from a
#: thread a rank
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        SELECT_K_SHAPES.clear()


def _count_launch(name: str) -> None:
    """One launch of kernel ``name``."""
    with _count_lock:
        LAUNCHES[name] += 1


def _count_select_k(caller: str, n: int, k: int) -> None:
    """One launch of select_k's kernel over rows of n at this k."""
    key = (caller, int(n), int(k))
    with _count_lock:
        LAUNCHES["select_k"] += 1
        SELECT_K_SHAPES[key] = SELECT_K_SHAPES.get(key, 0) + 1


# ------------------------------------------------------------------- build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built: the name plus a hash
    of every source and header it could include and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu*"), *CSRC.glob("*.h")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the kernels' libraries that are not built yet, one ``nvcc`` per
    source, all started together. Returns name → library path; raises with
    the compiler's output if a build fails. The compiler's output (with
    ptxas's registers, shared memory and spills of each kernel) is kept
    beside the library, in ``library_path(name).with_suffix(".log")``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        paths[name].with_suffix(".log").write_text(out)
        os.replace(tmp, paths[name])
    if procs:
        for listener in list(BUILD_LISTENERS):
            listener(len(procs), time.perf_counter() - t0)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def _lib(name: str) -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            for fn_name in _FUNCTIONS.get(name, [name]):
                fn = getattr(lib, fn_name)
                fn.argtypes = _ARGTYPES[fn_name]
                fn.restype = ctypes.c_int
            lib.rtt_error_string.argtypes = [ctypes.c_int]
            lib.rtt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        msg = _lib(name).rtt_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_k(name: str, k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name} is a small-k kernel: need 1 <= k <= "
                         f"{MAX_K}, got k={k}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


# ------------------------------------------------- measured crossover gate
#
# Counterpart of ``raft_tpu.ops.pallas_kernels``' gate. Whether
# ``scan_mode="auto"`` takes a family's fused kernel on the card is a
# measured decision: ``python -m raft_tpu_torch.bench.probe`` A/Bs each
# family's fused route against its unfused route on the card and records a
# ``fused_wins`` verdict per family in
# ``raft_tpu_torch/artifacts/PALLAS_PROBE_<platform>.json``, keyed by the
# card's name (``select_k.platform_key``). The artifact arms by itself, as
# ``SELECT_K_TABLE``/``TOPK_PAD`` do; ``RAFT_TPU_TORCH_PALLAS_PROBE`` names
# an override, loaded last and loudly.
#
# On the CPU there is no kernel to route around: every family's fused
# route runs its kernels' plain versions (reason ``auto_fused``), which is
# what the CPU tests hold against the JAX package.

#: families whose verdicts route ``scan_mode="auto"`` (``merge_ring``
#: comes only from a probe over several cards)
VERDICT_FAMILIES = ("brute_force", "ivf_flat", "ivf_pq", "ivf_scan",
                    "l2_argmin", "cagra")

_fused_table_cache: Optional[Dict[str, Dict[str, bool]]] = None


def _extract_fused_table(art: dict) -> Dict[str, bool]:
    fused = art.get("fused", {})
    return {fam: bool(row.get("fused_wins"))
            for fam, row in fused.items() if isinstance(row, dict)}


def _load_fused_table() -> Dict[str, Dict[str, bool]]:
    global _fused_table_cache
    if _fused_table_cache is None:
        from raft_tpu_torch.ops.select_k import _scan_artifacts

        _fused_table_cache = _scan_artifacts(
            {}, "PALLAS_PROBE", "RAFT_TPU_TORCH_PALLAS_PROBE",
            _extract_fused_table)
    return _fused_table_cache


def fused_platform_key(device=None) -> str:
    """The key the verdicts of ``device`` (default: the current card, else
    the CPU) are recorded under: ``select_k.platform_key``."""
    from raft_tpu_torch.ops.select_k import platform_key

    return platform_key(device)


def set_fused_crossover(platform: str, families) -> None:
    """Install (or with None, drop) a platform's verdicts:
    ``{"brute_force": True, "ivf_flat": False, ...}``."""
    global _fused_table_cache
    tables = _load_fused_table()
    if families is None:
        tables.pop(platform, None)
    else:
        tables[platform] = {k: bool(v) for k, v in families.items()}
    _fused_table_cache = tables


def _fused_verdict(family: str, device=None) -> Optional[bool]:
    """The measured verdict of ``family`` on ``device``'s platform: True or
    False, None when the artifact has no row."""
    v = _load_fused_table().get(fused_platform_key(device), {}).get(family)
    return None if v is None else bool(v)


def fused_crossover(family: str, device=None) -> bool:
    """Whether ``auto`` takes ``family``'s fused route on ``device``: on the
    card, True only where the verdict says the fused route wins; on the CPU
    always (the plain versions)."""
    if device is not None and torch.device(device).type != "cuda":
        return True
    if device is None and not torch.cuda.is_available():
        return True
    return bool(_fused_verdict(family, device))


def ring_merge_verdict(device=None) -> Optional[bool]:
    """The ``merge_ring`` verdict: True or False when a probe over several
    cards measured it, None when the artifact has no row (a one-card probe
    writes none)."""
    return _fused_verdict("merge_ring", device)


_warned_no_verdict = False


def _reset_fused_warn() -> None:
    """Re-arm the once-per-process warning of a missing verdict."""
    global _warned_no_verdict
    _warned_no_verdict = False


def _warn_no_verdict_once(family: str) -> None:
    global _warned_no_verdict
    if _warned_no_verdict:
        return
    _warned_no_verdict = True
    import logging

    logging.getLogger(__name__).warning(
        "scan_mode='auto' is routing %s (and every family without a "
        "verdict) to its unfused route on the card because the loaded "
        "PALLAS_PROBE artifact has no fused_wins verdict for this card. Run "
        "'python -m raft_tpu_torch.bench.probe --require-verdicts' on it to "
        "record verdicts, or force scan_mode='pallas'.", family)


def fused_dispatch_explained(family: str, scan_mode: str, device=None
                             ) -> Tuple[bool, str]:
    """``(use_fused, reason)`` of a family's search on ``device`` (default:
    the current card, else the CPU), the reason from ``obs.explain``'s
    vocabulary. ``"pallas"``: the kernel (``forced``; its plain version on
    the CPU). ``"auto"`` on the card: the kernel where the verdict says it
    wins (``auto_fused_wins``), else the unfused route (``fused_loses``, or
    ``no_fused_wins_verdict`` with a warning once per process); on the CPU
    the plain versions (``auto_fused``). Any other mode names an unfused
    engine (``forced``)."""
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    if scan_mode == "pallas":
        return True, "forced"
    if scan_mode == "auto":
        if not on_card:
            return True, "auto_fused"
        verdict = _fused_verdict(family, device)
        if verdict:
            return True, "auto_fused_wins"
        if verdict is None:
            _warn_no_verdict_once(family)
            return False, "no_fused_wins_verdict"
        return False, "fused_loses"
    return False, "forced"


# ------------------------------------------------------ plain selection


def _stable_topk(values: torch.Tensor, k: int,
                 ids: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' selection rule in plain PyTorch: the first k of a stable
    ascending sort, +inf → id -1 (padded when k exceeds the row), NaN never
    selected, -0.0 equal to +0.0. ``ids`` [b, n] relabels the positions."""
    b, n = values.shape
    v = values.to(torch.float32)
    v = torch.where(torch.isnan(v), torch.inf, v) + 0.0
    kk = min(k, n)
    sv, si = torch.sort(v, dim=1, stable=True)
    sv, si = sv[:, :kk], si[:, :kk]
    out_i = si.to(torch.int32) if ids is None else torch.gather(ids, 1, si)
    out_i = torch.where(sv == torch.inf, -1, out_i.to(torch.int32))
    if kk < k:
        sv = torch.cat([sv, sv.new_full((b, k - kk), torch.inf)], dim=1)
        out_i = torch.cat([out_i, out_i.new_full((b, k - kk), -1)], dim=1)
    return sv, out_i


def _row_chunk(n_cols: int, bytes_per_col: int = 4,
               budget: int = 1 << 29) -> int:
    return max(1, budget // max(n_cols * bytes_per_col, 1))


# ------------------------------------------------------ fused_l2_topk


#: fused_l2_topk's tensor-core route: query rows per consumer warpgroup,
#: database rows per tile, floats per k-slice, survivor slots per row
TC_BM, TC_BN, TC_BK, TC_SURV = 64, 128, 32, 16
#: device memory the tensor-core route may take for its hi/lo planes; a
#: larger problem is cut into query and database chunks
L2_TOPK_SCRATCH_BUDGET = 1 << 30


def l2_topk_tc_smem_bytes(k: int, stages: int, wgs: int = 1) -> int:
    """Dynamic shared memory of one block of fused_l2_topk's tensor-core
    route with ``wgs`` consumer warpgroups (the same function of
    csrc/smem_budget.h): alignment slack, the ring (each stage the hi/lo
    planes of a 64·wgs × 32 query and a 128 × 32 database slice), its
    barriers, the carry, the survivor buffers and their counts."""
    bm = TC_BM * wgs
    stage = 2 * bm * TC_BK * 4 + 2 * TC_BN * TC_BK * 4
    return (1024 + stages * stage + stages * 16 + bm * k * 8
            + bm * TC_SURV * 8 + bm * 4)


def l2_topk_fma_smem_bytes(k: int) -> int:
    """Dynamic shared memory of one block of the large-k FMA route
    (the same function of csrc/smem_budget.h): 16 query rows."""
    return 32 * 17 * 4 + 32 * 129 * 4 + 8 + 16 * 128 * 8 + 16 * k * 8 + 16 * 4


#: the largest k of the tensor-core route: its 64-row carry beside a
#: two-stage ring fills a block's shared memory at 243; above, the FMA route
TC_MAX_K = max(k for k in range(1, MAX_K + 1)
               if l2_topk_tc_smem_bytes(k, 2) <= SMEM_LIMIT)
#: the largest k at which a block holds two consumer warpgroups (81)
TC_WGS2_MAX_K = max(k for k in range(1, MAX_K + 1)
                    if l2_topk_tc_smem_bytes(k, 2, 2) <= SMEM_LIMIT)


@dataclasses.dataclass(frozen=True)
class L2TopkPlan:
    """How ``fused_l2_topk`` runs: ``route`` "tc" (3×TF32 on the tensor
    cores) or "fma" (large k); ``wgs`` consumer warpgroups of 64 query rows
    a block; ``d_pad`` the feature width of the hi/lo planes; ``stages`` of
    the ring; the database cut into ``splits`` ranges of ``split_len`` rows
    (merged by one more pass when > 1), ``chunk_splits`` ranges per
    database chunk and ``q_chunk`` query rows per call, so that
    ``scratch_bytes`` stays within ``L2_TOPK_SCRATCH_BUDGET``; ``smem``
    bytes a block."""

    route: str
    wgs: int
    d_pad: int
    stages: int
    split_len: int
    splits: int
    chunk_splits: int
    q_chunk: int
    smem: int
    scratch_bytes: int


def _wave_splits(q_tiles: int, slots: int, lo: int, hi: int) -> int:
    """The fewest database ranges in [lo, hi] whose q_tiles·s blocks fill
    90% of their last wave of ``slots`` resident blocks, else the best
    fill (the fewest ranges among equals)."""
    best, best_fill = lo, -1.0
    for s in range(lo, max(lo, hi) + 1):
        blocks = q_tiles * s
        fill = blocks / (-(-blocks // slots) * slots)
        if fill >= 0.9:
            return s
        if fill > best_fill + 1e-12:
            best, best_fill = s, fill
    return best


def plan_fused_topk(m: int, n: int, d: int, k: int, n_sm: int) -> L2TopkPlan:
    """The plan of ``fused_l2_topk`` for x [m, d], y [n, d] on ``n_sm`` SMs.

    The tensor-core route for k <= ``TC_MAX_K``: 128 query rows a block
    (two consumer warpgroups sharing each database slice) where their carry
    fits beside a two-stage ring (k <= ``TC_WGS2_MAX_K``), else 64; as many
    ring stages (up to 4) as fit, which leaves room for one block an SM.
    The database is cut into ranges (each at least 8 tiles) so that the
    (query tile, range) blocks fill whole waves of the SMs, and into chunks
    whose hi/lo planes fit the scratch budget; the queries into chunks of
    at most half of it. Above ``TC_MAX_K`` (or with no rows or no features)
    the large-k FMA route: 16 query rows a block, the database cut until
    the query tiles give four blocks an SM."""
    q_rows = max(m, 1)
    if k > TC_MAX_K or n < 1 or d < 1:
        q_blocks = -(-q_rows // 16)
        splits = max(1, min(-(-4 * n_sm // q_blocks), n // (8 * 128)))
        split_len = -(-max(-(-n // splits), 1) // 128) * 128
        return L2TopkPlan("fma", 0, d, 0, split_len,
                          -(-max(n, 1) // split_len), 1, q_rows,
                          l2_topk_fma_smem_bytes(k), 0)
    d_pad = -(-d // TC_BK) * TC_BK
    wgs = 2 if k <= TC_WGS2_MAX_K else 1
    bm = TC_BM * wgs
    stages = max(s for s in (2, 3, 4)
                 if l2_topk_tc_smem_bytes(k, s, wgs) <= SMEM_LIMIT)
    row_bytes = 2 * d_pad * 4  # a row's hi and lo planes
    q_chunk = max(bm, (L2_TOPK_SCRATCH_BUDGET // 2 // row_bytes) // bm * bm)
    q_chunk = min(q_chunk, q_rows)
    y_rows = max(TC_BN, (L2_TOPK_SCRATCH_BUDGET - q_chunk * row_bytes)
                 // row_bytes // TC_BN * TC_BN)
    q_tiles = -(-q_chunk // bm)
    s_min = -(-n // y_rows)
    s_max = max(1, min(64, n // (8 * TC_BN)))
    s = _wave_splits(q_tiles, n_sm, s_min, s_max)
    split_len = -(-(-(-n // s)) // TC_BN) * TC_BN
    splits = -(-n // split_len)
    chunk_splits = min(splits, max(1, y_rows // split_len))
    chunk_rows = min(split_len * chunk_splits, n)
    return L2TopkPlan("tc", wgs, d_pad, stages, split_len, splits,
                      chunk_splits, q_chunk,
                      l2_topk_tc_smem_bytes(k, stages, wgs),
                      (2 * q_chunk + 2 * chunk_rows) * d_pad * 4)


def fused_l2_topk_plain(x, y, k: int, x_norms=None, y_norms=None):
    """Plain version of ``fused_l2_topk``: the [m, n] distances in fp32
    matrix products, chunked over query rows, then the stable selection."""
    xn = row_norms_sq(x) if x_norms is None else x_norms
    yn = row_norms_sq(y) if y_norms is None else y_norms
    out_v, out_i = [], []
    step = _row_chunk(y.shape[0], 16)
    for s in range(0, x.shape[0], step):
        d = (xn[s:s + step, None] + yn[None, :]) - 2.0 * dot_fp32(
            x[s:s + step], y)
        v, i = _stable_topk(torch.clamp_min(d, 0.0), k)
        out_v.append(v)
        out_i.append(i)
    if not out_v:
        return (x.new_empty((0, k), dtype=torch.float32),
                x.new_empty((0, k), dtype=torch.int32))
    return torch.cat(out_v), torch.cat(out_i)


def fused_l2_topk(x, y, k: int, x_norms=None, y_norms=None):
    """Squared-L2 scan fused with top-k: ``(distances [m, k] f32, ids [m, k]
    i32)`` ascending, distances clamped at 0, ids -1 where fewer than k rows
    exist. x [m, d] and y [n, d] float32; norms [m], [n] (computed when not
    given)."""
    _check_k("fused_l2_topk", k)
    xn = row_norms_sq(x) if x_norms is None else x_norms
    yn = row_norms_sq(y) if y_norms is None else y_norms
    if _on_cpu(x, y, xn, yn):
        return fused_l2_topk_plain(x, y, k, xn, yn)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_l2_topk: unsupported device {dev}")
    m, d = x.shape
    n = y.shape[0]
    _check("x", x, torch.float32, 2, dev)
    _check("y", y, torch.float32, 2, dev)
    _check("x_norms", xn, torch.float32, 1, dev)
    _check("y_norms", yn, torch.float32, 1, dev)
    if y.shape[1] != d or xn.shape[0] != m or yn.shape[0] != n:
        raise ValueError("fused_l2_topk: shapes disagree")
    out_v = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m == 0:
        return out_v, out_i
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_fused_topk(m, n, d, k, n_sm)
    scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                           device=dev) if plan.scratch_bytes else None)
    lib = _lib("fused_l2_topk")
    for r0 in range(0, m, plan.q_chunk):
        r1 = min(r0 + plan.q_chunk, m)
        part_v = part_i = None
        if plan.splits > 1:
            part_v = torch.empty((r1 - r0, plan.splits, k),
                                 dtype=torch.float32, device=dev)
            part_i = torch.empty((r1 - r0, plan.splits, k),
                                 dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.fused_l2_topk(
                x[r0:r1].data_ptr(), y.data_ptr(), xn[r0:r1].data_ptr(),
                yn.data_ptr(), r1 - r0, n, d, k, int(plan.route == "fma"),
                plan.wgs, plan.d_pad, plan.stages, plan.split_len, plan.splits,
                plan.chunk_splits, _ptr(scratch), _ptr(part_v), _ptr(part_i),
                out_v[r0:r1].data_ptr(), out_i[r0:r1].data_ptr(),
                _stream(dev))
        _check_rc("fused_l2_topk", rc)
        _count_launch("fused_l2_topk")
        if plan.splits > 1:  # the ranges' merge
            _count_select_k("fused_l2_topk", plan.splits * k, k)
    return out_v, out_i


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


#: the list row types of the IVF scans (``fused_ivf_topk``, ``ivf_scan``),
#: by the code their C entries take (``ivfg::RowType`` in ivf_group.cuh).
#: Every value of the narrow types is exact in fp32, so a narrow list gives
#: bitwise the result of the same list cast to fp32.
ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.int8: 3, torch.uint8: 4}


# ------------------------------------------------------ fused_ivf_topk


def fused_ivf_topk_plain(probes, qres, qres_norms, list_data, row_norms,
                         list_indices, k: int, clamp: bool = True):
    """Plain version of ``fused_ivf_topk``: gather the probed slabs, fp32
    products, mask ids < 0 (and probes outside [0, n_lists)) to +inf, and
    select over the candidates in (probe, slot) order."""
    nq, n_probes = probes.shape
    n_lists, pad, rot = list_data.shape
    out_v, out_i = [], []
    step = _row_chunk(n_probes * pad * rot, 8)
    for s in range(0, nq, step):
        pr = probes[s:s + step].to(torch.int64)
        valid = (pr >= 0) & (pr < n_lists)
        pr = pr.clamp(0, n_lists - 1)
        data = list_data[pr].to(torch.float32)  # [t, P, pad, rot]
        dots = torch.einsum("tpr,tplr->tpl",
                            qres[s:s + step].to(torch.float32), data)
        d = (qres_norms[s:s + step, :, None] + row_norms[pr]) - 2.0 * dots
        if clamp:
            d = torch.clamp_min(d, 0.0)
        ids = list_indices[pr]
        d = torch.where((ids < 0) | ~valid[:, :, None], torch.inf, d)
        t = pr.shape[0]
        v, i = _stable_topk(d.reshape(t, n_probes * pad), k,
                            ids.reshape(t, n_probes * pad))
        out_v.append(v)
        out_i.append(i)
    if not out_v:
        return (qres.new_empty((0, k), dtype=torch.float32),
                qres.new_empty((0, k), dtype=torch.int32))
    return torch.cat(out_v), torch.cat(out_i)


#: the IVF scans' work item (ivf_scan's and fused_ivf_topk's grouped
#: route): up to this many of one list's (query, probe) pairs (kGroupPairs
#: in ivf_group.cuh)
IVF_SCAN_GROUP = 32
#: the IVF scans' slots per chunk and the elements a staged slab or query
#: row takes (kS and kRS in ivf_group.cuh)
IVF_SCAN_SLOTS, IVF_STAGE_ROW = 64, 132
#: device memory the grouped route's partials may take; a larger batch is
#: cut into query chunks
IVF_TOPK_SCRATCH_BUDGET = 1 << 28


#: up to this k the grouped route keeps each pair's carry in the registers
#: of its 16 lanes (kRegMaxK in fused_ivf_topk.cu), above it in shared
#: memory
IVF_TOPK_REG_MAX_K = 16


def ivf_topk_smem_bytes(k: int, elem_bytes: int) -> int:
    """Shared memory of one block of ``fused_ivf_topk``'s grouped route over
    list rows of ``elem_bytes`` (the same function of csrc/smem_budget.h:
    the dynamic bytes plus the kernel's static arrays): two slab buffers of 64
    staged rows, the group's 32 query vectors, and above
    ``IVF_TOPK_REG_MAX_K`` a chunk's 64 survivors of each pair, their counts
    and each pair's carry of k (value, slot)."""
    g = IVF_SCAN_GROUP
    smem = (2 * IVF_SCAN_SLOTS * IVF_STAGE_ROW * elem_bytes
            + g * IVF_STAGE_ROW * 4 + 4 * g + 16)
    if k > IVF_TOPK_REG_MAX_K:
        smem += g * IVF_SCAN_SLOTS * 8 + g * 4 + g * k * 8
    return smem


def ivf_topk_per_query_smem_bytes(rot: int, k: int) -> int:
    """Shared memory of one block of the per-query route (the same
    function of csrc/smem_budget.h): a 256-row chunk's survivors, the carry, the
    survivor count, the probe's query vector."""
    return 256 * 8 + k * 8 + 16 + rot * 4


#: the largest k of the grouped route: a 32-pair block over f32 rows keeps
#: every pair's carry beside its slab buffers up to 512; above, the
#: per-query route
IVF_TOPK_GROUPED_MAX_K = max(k for k in range(1, MAX_K + 1)
                             if ivf_topk_smem_bytes(k, 4) <= SMEM_LIMIT)


@dataclasses.dataclass(frozen=True)
class IvfTopkPlan:
    """How ``fused_ivf_topk`` runs: ``route`` "grouped" (pairs grouped by
    list, a partial top-k per pair and run of slots, then a merge per query)
    or "per_query" (large k); runs of ``chunks_per_run`` 64-slot chunks,
    ``runs`` of them; ``q_chunk`` queries a launch, so that the partials
    stay within ``IVF_TOPK_SCRATCH_BUDGET``; ``scratch_bytes`` of the
    partials and the grouping; ``smem`` bytes a block."""

    route: str
    chunks_per_run: int
    runs: int
    q_chunk: int
    smem: int
    scratch_bytes: int


def plan_fused_ivf(nq: int, n_probes: int, n_lists: int, pad: int, rot: int,
                   k: int, elem_bytes: int, n_sm: int) -> IvfTopkPlan:
    """The plan of ``fused_ivf_topk`` for nq queries × n_probes probes over
    n_lists lists of pad slots, rot features of ``elem_bytes`` each, on
    ``n_sm`` SMs.

    The grouped route up to ``IVF_TOPK_GROUPED_MAX_K``: the slots of a list
    cut into as few runs as give at least four blocks an SM, since each run
    of a pair adds k partials and a carry's warm-up; the queries cut into
    chunks whose partials fit the budget. Above it the per-query route."""
    q_rows = max(nq, 1)
    if k > IVF_TOPK_GROUPED_MAX_K:
        return IvfTopkPlan("per_query", 0, 0, q_rows,
                           ivf_topk_per_query_smem_bytes(rot, k), 0)
    chunks = -(-max(pad, 1) // IVF_SCAN_SLOTS)

    def runs_for(q: int) -> Tuple[int, int]:
        groups = -(-q * n_probes // IVF_SCAN_GROUP)
        cpr = -(-chunks // min(chunks, -(-4 * n_sm // groups)))
        return cpr, -(-chunks // cpr)

    def fit(runs: int) -> int:
        return min(q_rows, max(1, IVF_TOPK_SCRATCH_BUDGET
                               // (n_probes * runs * k * 8)))

    cpr, runs = runs_for(q_rows)
    q_chunk = fit(runs)
    if q_chunk < q_rows:
        cpr, runs = runs_for(q_chunk)
        q_chunk = fit(runs)
    scratch = (q_chunk * n_probes * runs * k * 8
               + 4 * ivf_group_scratch(q_chunk * n_probes, n_lists))
    return IvfTopkPlan("grouped", cpr, runs, q_chunk,
                       ivf_topk_smem_bytes(k, elem_bytes), scratch)


def fused_ivf_topk(probes, qres, qres_norms, list_data, row_norms,
                   list_indices, k: int, clamp: bool = True):
    """Fused probe gather + scan + top-k for the IVF families.

    probes [nq, P] int32; qres [nq, P, rot] f32 (the query, or its residual
    per probe); qres_norms [nq, P] f32; list_data [L, pad, rot] of a type of
    ``ROW_TYPES`` (f32, bf16, fp16, int8, uint8; fp32 accumulation); row_norms [L, pad] f32; list_indices [L, pad] int32
    with -1 at unfilled slots. Returns ``(distances [nq, k], ids [nq, k])``
    ascending; ``clamp`` applies max(d, 0). On the card the route and its
    sizes come from ``plan_fused_ivf``; the grouped route takes int32 and
    float scratch of ``plan.scratch_bytes``, one launch per query chunk."""
    _check_k("fused_ivf_topk", k)
    tensors = (probes, qres, qres_norms, list_data, row_norms, list_indices)
    if _on_cpu(*tensors):
        return fused_ivf_topk_plain(*tensors, k, clamp)
    dev = probes.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ivf_topk: unsupported device {dev}")
    nq, n_probes = probes.shape
    n_lists, pad, rot = list_data.shape
    _check("probes", probes, torch.int32, 2, dev)
    _check("qres", qres, torch.float32, 3, dev)
    _check("qres_norms", qres_norms, torch.float32, 2, dev)
    _check("list_data", list_data, tuple(ROW_TYPES), 3, dev)
    _check("row_norms", row_norms, torch.float32, 2, dev)
    _check("list_indices", list_indices, torch.int32, 2, dev)
    if (tuple(qres.shape) != (nq, n_probes, rot)
            or tuple(qres_norms.shape) != (nq, n_probes)
            or tuple(row_norms.shape) != (n_lists, pad)
            or tuple(list_indices.shape) != (n_lists, pad)):
        raise ValueError("fused_ivf_topk: shapes disagree")
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_v, out_i
    if n_probes == 0 or n_lists == 0 or pad == 0:  # no candidate
        return out_v.fill_(torch.inf), out_i.fill_(-1)
    if rot < 1:
        raise ValueError(f"fused_ivf_topk: rot={rot} < 1")
    plan = plan_fused_ivf(nq, n_probes, n_lists, pad, rot, k,
                          list_data.element_size(), torch.cuda
                          .get_device_properties(dev).multi_processor_count)
    grouped = plan.route == "grouped"
    groups = part_v = part_i = None
    if grouped:
        n_pairs = plan.q_chunk * n_probes
        if (n_pairs > 2**31 - 1
                or -(-n_pairs // IVF_SCAN_GROUP) + n_lists + 1 > 2**31 - 1
                or plan.runs > 65535):
            raise ValueError(f"fused_ivf_topk: {n_pairs} (query, probe) "
                             f"pairs over {n_lists} lists of {pad} slots "
                             "exceed one launch's grid")
        groups = torch.empty(ivf_group_scratch(n_pairs, n_lists),
                             dtype=torch.int32, device=dev)
        part_v = torch.empty(n_pairs * plan.runs * k, dtype=torch.float32,
                             device=dev)
        part_i = torch.empty(n_pairs * plan.runs * k, dtype=torch.int32,
                             device=dev)
    lib = _lib("fused_ivf_topk")
    for r0 in range(0, nq, plan.q_chunk):
        r1 = min(r0 + plan.q_chunk, nq)
        with torch.cuda.device(dev):
            rc = lib.fused_ivf_topk(
                probes[r0:r1].data_ptr(), qres[r0:r1].data_ptr(),
                qres_norms[r0:r1].data_ptr(), list_data.data_ptr(),
                ROW_TYPES[list_data.dtype], row_norms.data_ptr(),
                list_indices.data_ptr(), r1 - r0, n_probes, n_lists, pad, rot,
                k, int(bool(clamp)), int(not grouped), plan.chunks_per_run,
                _ptr(groups), _ptr(part_v),
                _ptr(part_i), out_v[r0:r1].data_ptr(),
                out_i[r0:r1].data_ptr(), _stream(dev))
        _check_rc("fused_ivf_topk", rc)
        _count_launch("fused_ivf_topk")
        if grouped:  # the per-query merge
            _count_select_k("fused_ivf_topk", n_probes * plan.runs * k, k)
    return out_v, out_i


# ----------------------------------------------------------- select_k

#: select_k's register route (a warp's carry in its registers, entry j in
#: lane j) takes k up to this; above it the shared-memory carry, up to MAX_K
#: (kRegMaxK in topk_carry.cuh)
SELECT_REG_MAX_K = 32
#: a 32-value step with up to this many survivors inserts them one by one;
#: more are sorted and merged (kRegInsertMax)
SELECT_INSERT_MAX = 16
#: most values a lane loads a chunk on the register route (kRegMaxV)
SELECT_REG_MAX_V = 8
#: rows longer than this take the register route's bounding first pass
#: (each lane's two smallest keys, the k-th of those 64 as a bound on the
#: k-th value) before the exact pass (kRegTwoPassMinN)
SELECT_TWO_PASS_MIN_N = 256
#: values a warp streams a chunk on the shared-memory route (kSelectChunk)
SELECT_SHARED_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class SelectKPlan:
    """How select_k's kernel runs a row of n at k: ``route`` "register" (the
    carry in one warp's registers) or "shared" (in shared memory); ``v``
    values a lane loads a chunk (chunks of 32·v values); ``rows_per_warp``
    (one: a short row leaves lanes idle rather than share a warp);
    ``passes`` over the row (2: a bounding pass first, on the register
    route)."""

    route: str
    v: int
    rows_per_warp: int
    passes: int


def plan_select_k(n: int, k: int) -> SelectKPlan:
    """The plan ``launch_select_rows`` in topk_carry.cuh picks for rows of n
    at k (``select_reg_route`` and ``select_reg_v`` there): the register
    route up to k = ``SELECT_REG_MAX_K`` while positions fit 31 bits, with
    the row's 32-value steps rounded up to a power of two, at most
    ``SELECT_REG_MAX_V``, a chunk, and two passes over rows longer than
    ``SELECT_TWO_PASS_MIN_N``."""
    if k <= SELECT_REG_MAX_K and n < 2**31:
        v = 1
        while v < SELECT_REG_MAX_V and 32 * v < n:
            v *= 2
        return SelectKPlan("register", v, 1,
                           2 if n > SELECT_TWO_PASS_MIN_N else 1)
    return SelectKPlan("shared", SELECT_SHARED_CHUNK // 32, 1, 1)


#: rows a block of select_k's shared-memory route (one warp each)
SELECT_SHARED_WARPS = 8


def select_k_smem_bytes(k: int) -> int:
    """Dynamic shared memory of one block of select_k's shared-memory route
    (the same function of csrc/smem_budget.h): each warp's chunk of
    survivors, its carry of k and its count."""
    return SELECT_SHARED_WARPS * (SELECT_SHARED_CHUNK * 8 + k * 8 + 16)


def streaming_select_k_plain(values, k: int, select_min: bool = True):
    """Plain version of ``streaming_select_k``."""
    v = values.to(torch.float32)
    sv, si = _stable_topk(v if select_min else -v, k)
    return (sv if select_min else -sv).to(values.dtype), si


def streaming_select_k(values, k: int, select_min: bool = True):
    """Streaming top-k of the rows of values [b, n] (the counterpart of
    ``pallas_select_k``): ``(values [b, k], ids [b, k] int32)``, ascending
    (descending for ``select_min=False``), ids -1 past the row's finite
    entries. Values come back in the input dtype; the kernel reads float32.
    On the card the route comes from ``plan_select_k``."""
    _check_k("select_k", k)
    if _on_cpu(values):
        return streaming_select_k_plain(values, k, select_min)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"select_k: unsupported device {dev}")
    _check("values", values, torch.float32, 2, dev)
    b, n = values.shape
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_v, out_i
    plan = plan_select_k(n, k)
    lib = _lib("select_k")
    with torch.cuda.device(dev):
        rc = lib.select_k_rows(
            values.data_ptr(), None, b, n, k, int(not select_min),
            plan.v if plan.route == "register" else -1, plan.passes,
            out_v.data_ptr(), out_i.data_ptr(), _stream(dev))
    _check_rc("select_k", rc)
    _count_select_k("select_k", n, k)
    return out_v, out_i


# ------------------------------------------------------ fused_pq_topk

PQ_BOOK = 256  # codebook entries per subspace at pq_bits 8


def pq_topk_smem_bytes(pq_dim: int, pq_len: int, k: int) -> int:
    """Dynamic shared memory of one fused_pq_topk block (the same
    function of csrc/smem_budget.h): survivors, the probe's LUT, the
    carry, the residual and the partial sums of its norm."""
    return (256 * 8 + pq_dim * PQ_BOOK * 4 + k * 8 + 16 + pq_dim * pq_len * 4
            + (256 // 32 + 1) * 4)


def fused_pq_fits(pq_dim: int, pq_len: int, k: int) -> bool:
    """True when one probe's LUT, with the carry, fits a block's shared
    memory on Hopper (pq_dim up to about 200 at k=1024): the per-query
    route's need, which also bounds what the grouped route is asked."""
    return pq_topk_smem_bytes(pq_dim, pq_len, k) <= SMEM_LIMIT


#: fused_pq_topk's grouped route (fused_pq_topk.cu): a work item's pairs,
#: one a lane (``IVF_SCAN_GROUP``); subspaces a LUT chunk (one code word);
#: floats a pair's LUT chunk takes (pair stride 1025 ≡ 1 mod 32, so the 32
#: lanes' lookups of one code hit 32 banks); list rows a warp scans; warps
#: a block at most
PQ_SUB, PQ_LUT_STRIDE, PQ_ROWS_PER_WARP, PQ_MAX_WARPS = 4, 4 * 256 + 1, 64, 16
#: up to this k a pair's carry lives in the registers of one warp (entry l
#: in lane l); above it the per-query route
PQ_GROUPED_MAX_K = 32


def pq_grouped_smem_bytes(pq_dim: int, pq_len: int, warps: int,
                          res_chunked: bool = False) -> int:
    """Shared memory of one block of ``fused_pq_topk``'s grouped route with
    ``warps`` warps (the same function of csrc/smem_budget.h, with 512
    bytes for its static arrays): the 32 pairs' LUT chunk (later the
    run's distance keys, [32, rows + 1]), the pairs' residuals ([32, rot],
    or [32, 4·pq_len] when staged a LUT chunk at a time) and the run's
    codes as words [⌈pq_dim / 4⌉, rows + 1]."""
    rows = PQ_ROWS_PER_WARP * warps
    words = -(-pq_dim // PQ_SUB)
    res = PQ_SUB * pq_len if res_chunked else pq_dim * pq_len
    return 4 * (IVF_SCAN_GROUP * PQ_LUT_STRIDE + IVF_SCAN_GROUP * res
                + words * (rows + 1)) + 512


@dataclasses.dataclass(frozen=True)
class PqTopkPlan:
    """How ``fused_pq_topk`` runs: ``route`` "grouped" (pairs grouped by
    list, 32 a block, each pair's top k of a run of ``64·warps`` slots, then
    a merge per query) or "per_query" (large k, or a shape whose grouped
    block does not fit); ``runs`` of a list's slots; the pairs' residuals
    staged whole, or a LUT chunk at a time (``res_chunked``, for wide
    rotations); ``q_chunk`` queries a launch, so that the partials stay
    within ``IVF_TOPK_SCRATCH_BUDGET``; ``scratch_bytes`` of the partials
    and the grouping; ``smem`` bytes a block."""

    route: str
    warps: int
    res_chunked: bool
    runs: int
    q_chunk: int
    smem: int
    scratch_bytes: int


def plan_fused_pq(nq: int, n_probes: int, n_lists: int, pad: int,
                  pq_dim: int, pq_len: int, k: int) -> PqTopkPlan:
    """The plan of ``fused_pq_topk`` for nq queries × n_probes probes over
    n_lists lists of pad slots, codes of pq_dim bytes, codebooks of pq_len.

    The grouped route up to ``PQ_GROUPED_MAX_K``: as many warps (64 slots
    each, up to 16, no more than the list needs) as fit a block's shared
    memory, since every run of a pair rebuilds its LUT, with the residuals
    staged whole unless staging them a chunk at a time fits more warps; the
    queries cut into chunks whose partials fit the budget. Above it, or
    when no block fits, the per-query route (which ``fused_pq_fits``
    bounds)."""
    q_rows = max(nq, 1)
    need = min(PQ_MAX_WARPS, -(-max(pad, 1) // PQ_ROWS_PER_WARP))

    def most(chunked: bool) -> int:
        return max([w for w in range(1, need + 1) if pq_grouped_smem_bytes(
            pq_dim, pq_len, w, chunked) <= SMEM_LIMIT], default=0)

    whole, chunked = most(False), most(True)
    if k > PQ_GROUPED_MAX_K or not chunked:
        return PqTopkPlan("per_query", 0, False, 0, q_rows,
                          pq_topk_smem_bytes(pq_dim, pq_len, k), 0)
    res_chunked = chunked > whole
    warps = chunked if res_chunked else whole
    runs = -(-max(pad, 1) // (PQ_ROWS_PER_WARP * warps))
    q_chunk = min(q_rows, max(1, IVF_TOPK_SCRATCH_BUDGET
                              // (n_probes * runs * k * 8)))
    scratch = (q_chunk * n_probes * runs * k * 8
               + 4 * ivf_group_scratch(q_chunk * n_probes, n_lists))
    return PqTopkPlan("grouped", warps, res_chunked, runs, q_chunk,
                      pq_grouped_smem_bytes(pq_dim, pq_len, warps,
                                            res_chunked), scratch)


def _pq_distances(probes, q_rot, centers_rot, codebooks, cb_norms,
                  list_codes, list_indices):
    """The ADC distances of the plain version for a chunk of queries: [t,
    P, pad] (+inf at ids < 0 and probes outside [0, n_lists)) and the slots'
    ids [t, P, pad]."""
    n_probes = probes.shape[1]
    n_lists, pad, pq_dim = list_codes.shape
    pq_len = codebooks.shape[2]
    pr = probes.to(torch.int64)
    valid = (pr >= 0) & (pr < n_lists)
    pr = pr.clamp(0, n_lists - 1)
    t = pr.shape[0]
    res = q_rot[:, None, :].to(torch.float32) - centers_rot[pr]
    base = (res * res).sum(-1)  # [t, P]
    dots = einsum_fp32("tpsl,scl->tpsc",
                       res.reshape(t, n_probes, pq_dim, pq_len), codebooks)
    lut = cb_norms[None, None] - 2.0 * dots  # [t, P, s, book]
    acc = torch.zeros((t, n_probes, pad), dtype=torch.float32,
                      device=q_rot.device)
    for s in range(pq_dim):
        code_s = list_codes[:, :, s][pr].to(torch.int64)  # [t, P, pad]
        acc = acc + torch.gather(lut[:, :, s, :], 2, code_s)
    d = acc + base[:, :, None]
    ids = list_indices[pr]
    return torch.where((ids < 0) | ~valid[:, :, None], torch.inf, d), ids


def fused_pq_topk_plain(probes, q_rot, centers_rot, codebooks, cb_norms,
                        list_codes, list_indices, k: int):
    """Plain version of ``fused_pq_topk``: per query chunk the probes'
    residuals, their LUTs by one fp32 product, the per-subspace entries
    gathered and summed in subspace order, ‖res‖² added, ids < 0 (and probes
    outside [0, n_lists)) +inf, and the selection over the candidates in
    (probe, slot) order."""
    nq, n_probes = probes.shape
    pad, pq_dim = list_codes.shape[1:]
    book = codebooks.shape[1]
    # per query: the LUTs and their product, then acc, ids, gathered codes
    per_q = n_probes * (pq_dim * book * 8 + pad * 24)
    step = _row_chunk(1, per_q)
    out_v, out_i = [], []
    for s0 in range(0, nq, step):
        d, ids = _pq_distances(probes[s0:s0 + step], q_rot[s0:s0 + step],
                               centers_rot, codebooks, cb_norms, list_codes,
                               list_indices)
        t = d.shape[0]
        v, i = _stable_topk(d.reshape(t, n_probes * pad), k,
                            ids.reshape(t, n_probes * pad))
        out_v.append(v)
        out_i.append(i)
    if not out_v:
        return (q_rot.new_empty((0, k), dtype=torch.float32),
                q_rot.new_empty((0, k), dtype=torch.int32))
    return torch.cat(out_v), torch.cat(out_i)


def fused_pq_topk(probes, q_rot, centers_rot, codebooks, cb_norms,
                  list_codes, list_indices, k: int):
    """Fused PQ LUT build + code scan + top-k (ivf_pq's LUT engine).

    pq_bits 8 and PER_SUBSPACE codebooks only: probes [nq, P] int32; q_rot
    [nq, rot] f32 (the rotated queries); centers_rot [L, rot] f32; codebooks
    [pq_dim, 256, pq_len] f32 with rot = pq_dim·pq_len; cb_norms [pq_dim,
    256] f32 (the codebook rows' squared norms); list_codes [L, pad, pq_dim]
    uint8, one byte per code; list_indices [L, pad] int32, -1 at unfilled
    slots. Returns the ascending ADC squared distances ``(distances [nq, k],
    ids [nq, k])``, unclamped. On the card the route and its sizes come from
    ``plan_fused_pq``; the grouped route takes int32 and float scratch of
    ``plan.scratch_bytes``, one launch per query chunk."""
    _check_k("fused_pq_topk", k)
    tensors = (probes, q_rot, centers_rot, codebooks, cb_norms, list_codes,
               list_indices)
    n_lists, pad, n_code_bytes = list_codes.shape
    pq_dim, book, pq_len = codebooks.shape
    if n_code_bytes != pq_dim or book != PQ_BOOK:
        raise ValueError(
            f"fused_pq_topk requires pq_bits=8 (one byte per code, 256 "
            f"entries per codebook); got {n_code_bytes} code bytes for "
            f"pq_dim={pq_dim} and {book} entries")
    if _on_cpu(*tensors):
        return fused_pq_topk_plain(*tensors, k)
    dev = probes.device
    if dev.type != "cuda":
        raise ValueError(f"fused_pq_topk: unsupported device {dev}")
    nq, n_probes = probes.shape
    rot = pq_dim * pq_len
    _check("probes", probes, torch.int32, 2, dev)
    _check("q_rot", q_rot, torch.float32, 2, dev)
    _check("centers_rot", centers_rot, torch.float32, 2, dev)
    _check("codebooks", codebooks, torch.float32, 3, dev)
    _check("cb_norms", cb_norms, torch.float32, 2, dev)
    _check("list_codes", list_codes, torch.uint8, 3, dev)
    _check("list_indices", list_indices, torch.int32, 2, dev)
    if (tuple(q_rot.shape) != (nq, rot)
            or tuple(centers_rot.shape) != (n_lists, rot)
            or tuple(cb_norms.shape) != (pq_dim, book)
            or tuple(list_indices.shape) != (n_lists, pad)):
        raise ValueError("fused_pq_topk: shapes disagree")
    if not fused_pq_fits(pq_dim, pq_len, k):
        raise ValueError(
            f"fused_pq_topk: the LUT of pq_dim={pq_dim} with k={k} needs "
            f"{pq_topk_smem_bytes(pq_dim, pq_len, k)} bytes of shared memory, "
            f"more than a block's {SMEM_LIMIT}")
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_v, out_i
    if n_probes == 0 or n_lists == 0 or pad == 0:  # no candidate
        return out_v.fill_(torch.inf), out_i.fill_(-1)
    plan = plan_fused_pq(nq, n_probes, n_lists, pad, pq_dim, pq_len, k)
    grouped = plan.route == "grouped"
    groups = part_v = part_i = None
    if grouped:
        n_pairs = plan.q_chunk * n_probes
        if (n_pairs > 2**31 - 1
                or -(-n_pairs // IVF_SCAN_GROUP) + n_lists + 1 > 2**31 - 1
                or plan.runs > 65535):
            raise ValueError(f"fused_pq_topk: {n_pairs} (query, probe) pairs "
                             f"over {n_lists} lists of {pad} slots exceed one "
                             "launch's grid")
        groups = torch.empty(ivf_group_scratch(n_pairs, n_lists),
                             dtype=torch.int32, device=dev)
        part_v = torch.empty(n_pairs * plan.runs * k, dtype=torch.float32,
                             device=dev)
        part_i = torch.empty(n_pairs * plan.runs * k, dtype=torch.int32,
                             device=dev)
    # the route's widest code loads: 16 bytes a row (per-query route), 4
    # (grouped route), where every row starts on such a boundary
    align = 16 if not grouped else 4
    vec = int(pq_dim % align == 0 and list_codes.data_ptr() % align == 0)
    lib = _lib("fused_pq_topk")
    for r0 in range(0, nq, plan.q_chunk):
        r1 = min(r0 + plan.q_chunk, nq)
        with torch.cuda.device(dev):
            rc = lib.fused_pq_topk(
                probes[r0:r1].data_ptr(), q_rot[r0:r1].data_ptr(),
                centers_rot.data_ptr(), codebooks.data_ptr(),
                cb_norms.data_ptr(), list_codes.data_ptr(),
                list_indices.data_ptr(), r1 - r0, n_probes, n_lists, pad,
                pq_dim, pq_len, k, vec, int(not grouped), plan.warps,
                int(plan.res_chunked), _ptr(groups), _ptr(part_v),
                _ptr(part_i), out_v[r0:r1].data_ptr(), out_i[r0:r1].data_ptr(),
                _stream(dev))
        _check_rc("fused_pq_topk", rc)
        _count_launch("fused_pq_topk")
        if grouped:  # the per-query merge
            _count_select_k("fused_pq_topk", n_probes * plan.runs * k, k)
    return out_v, out_i


# ---------------------------------------------------- fused_cagra_topk

CAGRA_THREADS = 128  # kThreads of fused_cagra_topk.cu
MAX_ITOPK = 1024


def _align16(b: int) -> int:
    return (b + 15) & ~15


def cagra_cand_cap(width: int, degree: int) -> int:
    """Candidate slots of one fused_cagra_topk block: a hop's width·degree
    targets (and a chunk of seeds), rounded up to a power of two >= 32."""
    cap = 32
    while cap < width * degree:
        cap *= 2
    return cap


def cagra_topk_smem_bytes(itopk: int, dim: int, width: int,
                          degree: int) -> int:
    """Dynamic shared memory of one fused_cagra_topk block (the same
    function of csrc/smem_budget.h): two beam buffers (keys,
    ids, flags), the query row, the candidates' ids, keys and sort slots,
    the parents and two counters."""
    cap = cagra_cand_cap(width, degree)
    return (2 * (2 * _align16(itopk * 4) + _align16(itopk))
            + _align16(dim * 4) + cap * 8 + cap * 8 + _align16(width * 4)
            + 16)


#: fused_cagra_topk's warp route (fused_cagra_topk.cu): the largest beam
#: and hop (width·degree candidates, two a lane) one warp walks, and the
#: queries (warps) a block holds at most
CAGRA_WARP_MAX_ITOPK, CAGRA_WARP_MAX_CANDS, CAGRA_WARPS = 256, 64, 4


def cagra_warp_smem_bytes(itopk: int, dim: int, width: int,
                          degree: int) -> int:
    """Shared memory of one warp of fused_cagra_topk's warp route (the
    same function of csrc/smem_budget.h): two beam
    buffers (keys, ids, flags), the query row, the sorted candidates' keys
    (32 or 64) and the parents."""
    cands = 32 if width * degree <= 32 else 64
    return (2 * (2 * _align16(itopk * 4) + _align16(itopk))
            + _align16(dim * 4) + cands * 8 + _align16(width * 4))


@dataclasses.dataclass(frozen=True)
class CagraTopkPlan:
    """How ``fused_cagra_topk`` runs: ``route`` "warp" (one warp a query,
    ``warps`` queries a block) or "block" (one block of 128 threads a query,
    for the beams and hops beyond a warp's reach); ``smem`` bytes a block."""

    route: str
    warps: int
    smem: int


def plan_fused_cagra(itopk: int, dim: int, width: int,
                     degree: int) -> CagraTopkPlan:
    """The plan of ``fused_cagra_topk`` for a beam of ``itopk`` (raised to
    k) over rows of ``dim`` and hops of width·degree candidates.

    The warp route up to ``CAGRA_WARP_MAX_ITOPK`` and
    ``CAGRA_WARP_MAX_CANDS`` (two candidates a lane), with as many of its
    ``CAGRA_WARPS`` warps a block as fit the shared memory; else the block
    route."""
    slice_ = cagra_warp_smem_bytes(itopk, dim, width, degree)
    warps = min(CAGRA_WARPS, SMEM_LIMIT // slice_)
    if (itopk > CAGRA_WARP_MAX_ITOPK or width * degree > CAGRA_WARP_MAX_CANDS
            or warps < 1):
        return CagraTopkPlan("block", 0, cagra_topk_smem_bytes(
            itopk, dim, width, degree))
    return CagraTopkPlan("warp", warps, warps * slice_)


def lane_order_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order fused_cagra_topk adds: element e
    goes to lane (e // 4) % 32, each lane adds its elements in order
    (groups of four, groups 32 apart), then the 32 lane sums are folded in
    halves (lane l + lane l + 16, then + 8, 4, 2, 1: the xor shuffle
    ladder). Every step is one float32 addition, so the result is bitwise
    the kernel's."""
    dim = p.shape[-1]
    groups = -(-dim // 128)
    pad = groups * 128 - dim
    if pad:
        p = torch.cat([p, p.new_zeros(*p.shape[:-1], pad)], dim=-1)
    p = p.reshape(*p.shape[:-1], groups, 32, 4)
    acc = p[..., 0, :, 0]
    for j in range(groups):
        for c in range(4):
            if j or c:
                acc = acc + p[..., j, :, c]
    h = 16
    while h:
        acc = acc[..., :h] + acc[..., h:2 * h]
        h //= 2
    return acc[..., 0]


def beam_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared row norms summed in the kernel's order (``lane_order_sum``),
    so that they, and the distances built on them, are bitwise the same on
    the card and on the CPU."""
    xf = x.to(torch.float32)
    return lane_order_sum(xf * xf)


def beam_distances(queries, q_norms, dataset, ids,
                   inner_product: bool = False) -> torch.Tensor:
    """The minimised distance of each query [b, dim] to its rows ``ids``
    [b, c] (+inf where an id is < 0), with fused_cagra_topk's products and
    order of additions: max(‖q‖² + ‖v‖² − 2·q·v, 0) with ``q_norms`` [b]
    the queries' squared norms, or −q·v for ``inner_product``."""
    vecs = dataset[ids.clamp_min(0)].to(torch.float32)  # [b, c, dim]
    q = queries.to(torch.float32)[:, None, :]
    dot = lane_order_sum(vecs * q)
    if inner_product:
        d = -dot
    else:
        vn = lane_order_sum(vecs * vecs)
        d = torch.clamp_min((q_norms[:, None] + vn) - 2.0 * dot, 0.0) + 0.0
    return torch.where(ids < 0, torch.inf, d)


def _beam_merge(bd, bi, bf, cd, ci, itopk: int, clear_inf: bool = True):
    """The first ``itopk`` of a stable ascending sort of [buffer | candidates]
    by distance (the buffer first on ties, candidates in position order).
    With ``clear_inf`` +inf entries carry id -1 and a clear flag (the
    kernel's padding); without it they keep their ids."""
    d = torch.cat([bd, cd], 1)
    sd, order = torch.sort(d, dim=1, stable=True)
    sd, order = sd[:, :itopk], order[:, :itopk]
    si = torch.gather(torch.cat([bi, ci], 1), 1, order)
    sf = torch.gather(torch.cat([bf, torch.zeros_like(ci, dtype=torch.bool)],
                                1), 1, order)
    if not clear_inf:
        return sd, si, sf
    fin = torch.isfinite(sd)
    return sd, torch.where(fin, si, -1), sf & fin


def beam_hop(bd, bi, bf, done, graph, width: int, score,
             clear_inf: bool = True):
    """One hop of CAGRA's beam walk, shared by the kernel's plain version and
    the glue engine. The buffers [b, itopk] (distances ascending, int64 ids,
    expanded flags) of the rows not ``done``: flag the ``width`` first
    unexpanded finite entries (the cheapest, lowest index on ties), gather
    their graph rows (-1 for a missing parent; ids outside [0, n) are
    invalid edges), drop a target equal to a buffer id or to an earlier
    target, score the rest with ``score(ids [b, c]) -> [b, c]`` (+inf for an
    id < 0) and merge (``_beam_merge``). A row with nothing left to expand
    keeps its buffers. Returns ``(bd, bi, bf, active [b], parents [b, width],
    targets [b, c], target distances [b, c])``."""
    nq = bd.shape[0]
    n = graph.shape[0]
    avail = ~bf & torch.isfinite(bd) & ~done[:, None]
    rank = torch.cumsum(avail.to(torch.int32), 1)
    parents = []
    for w in range(width):
        hit = avail & (rank == w + 1)
        ok = hit.any(1)
        pos = hit.to(torch.int8).argmax(1, keepdim=True)
        bf = bf | torch.zeros_like(bf).scatter(1, pos, ok[:, None])
        parents.append(torch.where(ok, torch.gather(bi, 1, pos)[:, 0], -1))
    par = torch.stack(parents, 1)
    active = par[:, 0] >= 0
    tg = graph[par.clamp_min(0)].to(torch.int64)  # [b, width, degree]
    tg = torch.where(par[:, :, None] < 0, -1, tg).reshape(nq, -1)
    tg = torch.where((tg < 0) | (tg >= n), -1, tg)
    wd = tg.shape[1]
    earlier = torch.tril(torch.ones(wd, wd, dtype=torch.bool,
                                    device=tg.device), -1)
    drop = (tg[:, :, None] == bi[:, None, :]).any(-1) \
        | ((tg[:, :, None] == tg[:, None, :]) & earlier).any(-1)
    tg = torch.where(drop, -1, tg)
    td = score(tg)
    nd, ni, nf = _beam_merge(bd, bi, bf, td, tg, bd.shape[1], clear_inf)
    keep = ~active[:, None]
    return (torch.where(keep, bd, nd), torch.where(keep, bi, ni),
            torch.where(keep, bf, nf), active, par, tg, td)


def _cagra_walk(queries, dataset, graph, seeds, q_norms, itopk: int,
                width: int, max_iter: int, seen=None):
    """The beam walk of a chunk of queries; returns the buffer and the
    (hops, rows scored) per query. ``seen`` ([2, n] bool, or None) gets the
    rows scored (row 0) and the nodes expanded (row 1) marked."""
    nq = queries.shape[0]
    n = graph.shape[0]
    dev = queries.device
    seeds = seeds.to(torch.int64)
    seeds = torch.where((seeds < 0) | (seeds >= n), -1, seeds)
    # a seed equal to an earlier seed is dropped (first copy kept)
    order = torch.sort(seeds, dim=1, stable=True).indices
    s_sorted = torch.gather(seeds, 1, order)
    dup_sorted = torch.zeros_like(s_sorted, dtype=torch.bool)
    dup_sorted[:, 1:] = (s_sorted[:, 1:] == s_sorted[:, :-1]) \
        & (s_sorted[:, 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter(1, order, dup_sorted)
    seeds = torch.where(dup, -1, seeds)

    def score(ids):
        return beam_distances(queries, q_norms, dataset, ids)

    sd = score(seeds)
    rows = torch.isfinite(sd).sum(1)
    if seen is not None:
        seen[0, seeds[torch.isfinite(sd)]] = True
    bd = torch.full((nq, itopk), torch.inf, device=dev)
    bi = torch.full((nq, itopk), -1, dtype=torch.int64, device=dev)
    bf = torch.zeros((nq, itopk), dtype=torch.bool, device=dev)
    bd, bi, bf = _beam_merge(bd, bi, bf, sd, seeds, itopk)
    hops = torch.zeros(nq, dtype=torch.int64, device=dev)
    done = torch.zeros(nq, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        bd, bi, bf, active, par, tg, td = beam_hop(bd, bi, bf, done, graph,
                                                   width, score)
        done = done | ~active
        if not bool(active.any()):
            break
        fin = torch.isfinite(td)  # rows that stayed done have no target
        hops += active.to(torch.int64)
        rows += fin.sum(1)
        if seen is not None:
            seen[0, tg[fin]] = True
            seen[1, par[par >= 0]] = True
    return bd, bi, torch.stack([hops, rows], 1)


def fused_cagra_topk_plain(queries, dataset, graph, seed_ids, q_norms, k: int,
                           itopk: int, width: int, max_iter: int,
                           return_stats: bool = False):
    """Plain version of ``fused_cagra_topk``: the same walk, batched over
    queries (chunked), with the kernel's arithmetic and order of additions
    (``lane_order_sum``) and its tie order. With ``return_stats`` a third
    result, a dict, gives the walk's counts: ``hops`` and ``rows_scored``
    [nq] int64 per query (rows scored are seeds and targets with a finite
    distance), and over all queries ``rows_touched`` (distinct rows
    scored) and ``nodes_expanded`` (distinct parents)."""
    nq, dim = queries.shape
    itopk = max(int(itopk), int(k))
    wd = width * graph.shape[1]
    per_q = (wd * (itopk + wd) + (wd + seed_ids.shape[1]) * dim * 12
             + itopk * 64)
    step = _row_chunk(1, per_q, 1 << 28)
    seen = (torch.zeros((2, graph.shape[0]), dtype=torch.bool,
                        device=queries.device) if return_stats else None)
    out = [_cagra_walk(queries[s:s + step], dataset, graph,
                       seed_ids[s:s + step], q_norms[s:s + step], itopk,
                       width, max_iter, seen) for s in range(0, nq, step)]
    if not out:
        out = [(queries.new_empty((0, itopk)),
                queries.new_empty((0, itopk), dtype=torch.int64),
                queries.new_empty((0, 2), dtype=torch.int64))]
    v = torch.cat([o[0] for o in out])[:, :k]
    i = torch.cat([o[1] for o in out])[:, :k].to(torch.int32)
    if not return_stats:
        return v, i
    counts = torch.cat([o[2] for o in out])
    return v, i, {"hops": counts[:, 0], "rows_scored": counts[:, 1],
                  "rows_touched": int(seen[0].sum()),
                  "nodes_expanded": int(seen[1].sum())}


def resolve_max_iter(itopk: int, width: int, max_iter: int) -> int:
    """``max_iter`` <= 0 → the search plan's auto heuristic."""
    if max_iter > 0:
        return int(max_iter)
    return int(min(max(itopk // width + 10, 16), 200))


def fused_cagra_topk(queries, dataset, graph, seed_ids, q_norms, k: int,
                     itopk: int, width: int = 1, max_iter: int = 0):
    """The whole CAGRA beam walk of each query in one kernel.

    queries [nq, dim] f32, dataset [n, dim] f32, graph [n, degree] int32
    (-1 and ids outside [0, n) are invalid edges), seed_ids [nq, S] int32,
    q_norms [nq] f32 (the queries' squared norms). Returns the ascending
    squared L2 ``(distances [nq, k], ids [nq, k] int32)``, ids -1 where the
    walk found fewer than k nodes. ``itopk`` (raised to k, at most 1024) is
    the beam; ``max_iter`` <= 0 applies the auto heuristic. On the card the
    route (a warp or a block a query) comes from ``plan_fused_cagra``."""
    itopk = max(int(itopk), int(k))
    _check_k("fused_cagra_topk", k)
    if itopk > MAX_ITOPK:
        raise ValueError(f"fused_cagra_topk is a small-beam kernel: itopk="
                         f"{itopk} > {MAX_ITOPK}")
    width = max(int(width), 1)
    max_iter = resolve_max_iter(itopk, width, int(max_iter))
    tensors = (queries, dataset, graph, seed_ids, q_norms)
    if _on_cpu(*tensors):
        return fused_cagra_topk_plain(*tensors, k, itopk, width, max_iter)
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"fused_cagra_topk: unsupported device {dev}")
    nq, dim = queries.shape
    n, degree = graph.shape
    n_seeds = seed_ids.shape[1]
    _check("queries", queries, torch.float32, 2, dev)
    _check("dataset", dataset, torch.float32, 2, dev)
    _check("graph", graph, torch.int32, 2, dev)
    _check("seed_ids", seed_ids, torch.int32, 2, dev)
    _check("q_norms", q_norms, torch.float32, 1, dev)
    if (dataset.shape[1] != dim or seed_ids.shape[0] != nq
            or q_norms.shape[0] != nq or graph.shape[0] != n
            or dataset.shape[0] != n or n_seeds < 1 or degree < 1):
        raise ValueError("fused_cagra_topk: shapes disagree")
    plan = plan_fused_cagra(itopk, dim, width, degree)
    if plan.smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_cagra_topk: itopk={itopk}, dim={dim}, width={width}, "
            f"degree={degree} need {plan.smem} bytes of shared memory, more "
            f"than a block's {SMEM_LIMIT}")
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq > 0:
        vec4 = int(dim % 4 == 0 and dataset.data_ptr() % 16 == 0
                   and queries.data_ptr() % 16 == 0)
        lib = _lib("fused_cagra_topk")
        with torch.cuda.device(dev):
            rc = lib.fused_cagra_topk(
                queries.data_ptr(), dataset.data_ptr(), graph.data_ptr(),
                seed_ids.data_ptr(), q_norms.data_ptr(), nq, n, dim, degree,
                n_seeds, k, itopk, width, max_iter, vec4,
                int(plan.route != "warp"), plan.warps, out_v.data_ptr(),
                out_i.data_ptr(), _stream(dev))
        _check_rc("fused_cagra_topk", rc)
        _count_launch("fused_cagra_topk")
    return out_v, out_i


# ----------------------------------------------------- fused_l2_argmin

def fused_l2_argmin_plain(x, y, x_norms=None, y_norms=None,
                          clamp: bool = False, tile: Optional[int] = None):
    """Plain version of ``fused_l2_argmin``: the distances of ``tile`` x rows
    at a time (from a 512 MB budget when not given) by one fp32 matrix
    product, the clamp if asked, and the first minimum of each row."""
    xn = row_norms_sq(x) if x_norms is None else x_norms
    yn = row_norms_sq(y) if y_norms is None else y_norms
    step = max(1, int(tile)) if tile else _row_chunk(y.shape[0], 16)
    out_v, out_i = [], []
    for s in range(0, x.shape[0], step):
        d = (xn[s:s + step, None] + yn[None, :]) - 2.0 * dot_fp32(
            x[s:s + step], y)
        if clamp:
            d = torch.clamp_min(d, 0.0)
        v, i = torch.min(d, dim=1)
        out_v.append(v)
        out_i.append(i.to(torch.int32))
    if not out_v:
        return (x.new_empty((0,), dtype=torch.float32),
                x.new_empty((0,), dtype=torch.int32))
    return torch.cat(out_v), torch.cat(out_i)


def l2_argmin_smem_bytes(route: str, d_pad: int, stages: int) -> int:
    """Dynamic shared memory of one block of ``fused_l2_argmin`` (the
    same function of csrc/smem_budget.h, with ``route`` as 1 for
    "resident" there): alignment
    slack; the ring, each stage the hi/lo planes of a 128 × 32 slice of y
    (and of x in the "scratch" route); the block's 128 x rows as hi/lo
    planes of d_pad features in the "resident" route; the barriers."""
    slice_bytes = 128 * TC_BK * 4
    resident = route == "resident"
    stage = 2 * slice_bytes + (0 if resident else 2 * slice_bytes)
    x_planes = d_pad // TC_BK * 2 * slice_bytes if resident else 0
    return 1024 + stages * stage + x_planes + stages * 16


@dataclasses.dataclass(frozen=True)
class L2ArgminPlan:
    """How ``fused_l2_argmin`` runs on the tensor cores (3×TF32, 128 x rows
    a block): ``route`` "resident" (the block's x rows split into shared
    memory once) or "scratch" (x split into device-memory planes, in chunks
    of ``x_chunk`` rows, streamed with y); ``d_pad`` the planes' width;
    ``stages`` of the ring; ``smem`` bytes a block; ``scratch_bytes`` of
    the hi/lo planes (y's, and an x chunk's in the "scratch" route)."""

    route: str
    d_pad: int
    stages: int
    x_chunk: int
    smem: int
    scratch_bytes: int


def plan_fused_argmin(m: int, n: int, d: int) -> L2ArgminPlan:
    """The plan of ``fused_l2_argmin`` for x [m, d], y [n, d]: the
    "resident" route where the block's 128 rows, as hi/lo planes of d
    padded to a multiple of 32, fit beside a two-stage ring (d <= 160),
    else "scratch" with x chunks whose planes take at most half of
    ``L2_TOPK_SCRATCH_BUDGET``; as many ring stages (up to 4) as fit."""
    d_pad = -(-max(d, 1) // TC_BK) * TC_BK
    route = ("resident" if l2_argmin_smem_bytes("resident", d_pad, 2)
             <= SMEM_LIMIT else "scratch")
    stages = max(s for s in (2, 3, 4)
                 if l2_argmin_smem_bytes(route, d_pad, s) <= SMEM_LIMIT)
    row_bytes = 2 * d_pad * 4  # a row's hi and lo planes
    x_chunk = max(m, 1)
    if route == "scratch":
        x_chunk = min(x_chunk, max(128, L2_TOPK_SCRATCH_BUDGET // 2
                                   // row_bytes // 128 * 128))
    x_planes = x_chunk * row_bytes if route == "scratch" else 0
    return L2ArgminPlan(route, d_pad, stages, x_chunk,
                        l2_argmin_smem_bytes(route, d_pad, stages),
                        max(n, 1) * row_bytes + x_planes)


def fused_l2_argmin(x, y, x_norms=None, y_norms=None, clamp: bool = False,
                    tile: Optional[int] = None):
    """Squared-L2 1-NN of every x row among the y rows: ``(min distance [m]
    f32, argmin [m] int32)``, ties to the lowest y index. x [m, d] and y
    [n, d] float32, n >= 1; norms [m], [n] (computed when not given).
    ``clamp`` applies max(d, 0) before the comparison (the k-means E-step's
    form). ``tile`` is the plain version's row chunk on the CPU; the kernel
    walks x in its own blocks, by the plan of ``plan_fused_argmin``, with
    float scratch of ``plan.scratch_bytes`` for the hi/lo planes."""
    xn = row_norms_sq(x) if x_norms is None else x_norms
    yn = row_norms_sq(y) if y_norms is None else y_norms
    if y.shape[0] < 1:
        raise ValueError("fused_l2_argmin: y has no rows")
    if _on_cpu(x, y, xn, yn):
        return fused_l2_argmin_plain(x, y, xn, yn, clamp, tile)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_l2_argmin: unsupported device {dev}")
    m, d = x.shape
    n = y.shape[0]
    _check("x", x, torch.float32, 2, dev)
    _check("y", y, torch.float32, 2, dev)
    _check("x_norms", xn, torch.float32, 1, dev)
    _check("y_norms", yn, torch.float32, 1, dev)
    if y.shape[1] != d or xn.shape[0] != m or yn.shape[0] != n:
        raise ValueError("fused_l2_argmin: shapes disagree")
    if d < 1 or n > 2**31 - 1:
        raise ValueError(f"fused_l2_argmin: d={d}, n={n} (need d >= 1 and "
                         "n < 2**31)")
    out_v = torch.empty((m,), dtype=torch.float32, device=dev)
    out_i = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out_v, out_i
    plan = plan_fused_argmin(m, n, d)
    scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                          device=dev)
    lib = _lib("fused_l2_argmin")
    with torch.cuda.device(dev):
        rc = lib.fused_l2_argmin(
            x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(), m, n, d,
            int(bool(clamp)), int(plan.route == "resident"), plan.d_pad,
            plan.stages, plan.x_chunk, scratch.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), _stream(dev))
    _check_rc("fused_l2_argmin", rc)
    _count_launch("fused_l2_argmin")
    return out_v, out_i


# ------------------------------------------------------------ ivf_scan


def ivf_scan_plain(probes, qres, list_data, row_norms):
    """Plain version of ``ivf_scan``: gather the probed slabs (chunked over
    queries), one fp32 product, ``row_norms − 2·dot``; +inf for a probe
    outside [0, n_lists)."""
    nq, n_probes = probes.shape
    n_lists, pad, rot = list_data.shape
    out = []
    step = _row_chunk(n_probes * pad * rot, 8)
    for s in range(0, nq, step):
        pr = probes[s:s + step].to(torch.int64)
        valid = (pr >= 0) & (pr < n_lists)
        pr = pr.clamp(0, n_lists - 1)
        dots = einsum_fp32("tpr,tplr->tpl", qres[s:s + step], list_data[pr])
        part = row_norms[pr] - 2.0 * dots
        out.append(torch.where(valid[:, :, None], part, torch.inf))
    if not out:
        return qres.new_empty((0, n_probes, pad), dtype=torch.float32)
    return torch.cat(out)


#: pairs a block of the grouping passes counts and places (kGroupSegment in
#: ivf_group.cuh)
IVF_GROUP_SEGMENT = 4096
IVF_SCAN_CHUNKS_PER_BLOCK = 8  # chunks a block scans with one group


def ivf_scan_smem_bytes(elem_bytes: int) -> int:
    """Dynamic shared memory of one ``ivf_scan`` block over list rows of
    ``elem_bytes`` (the same function of csrc/smem_budget.h): two slab
    buffers of 64 staged rows and the group's 32 query vectors."""
    return (2 * IVF_SCAN_SLOTS * IVF_STAGE_ROW * elem_bytes
            + IVF_SCAN_GROUP * IVF_STAGE_ROW * 4)


def ivf_group_smem_bytes(n_lists: int) -> int:
    """Dynamic shared memory of the IVF scans' grouping passes (the same
    function of csrc/smem_budget.h): a counter or cursor for each list and
    one for the invalid probes; they take it while it is at most 96 KiB
    (24,575 lists), else they count in device memory."""
    return 4 * (n_lists + 1)


def ivf_group_scratch(n_pairs: int, n_lists: int) -> int:
    """int32 elements of the grouping's scratch (``group_scratch`` in
    ivf_group.cuh): the order of the pairs, each list's start, count and
    running group count, and each segment's count of every list."""
    segments = -(-n_pairs // IVF_GROUP_SEGMENT)
    return n_pairs + (3 + segments) * (n_lists + 1)


def ivf_scan_groups(probes: torch.Tensor, n_lists: int):
    """The grouping of the IVF scans' (query, probe) pairs, on the probes'
    device and without a read back to the host: ``(order, list_start,
    list_count, group_end)``, all int32. ``order`` [nq·P] is the pairs
    (row-major) sorted by list, stable, so that a list's pairs stay in
    (query, probe) order; a probe outside [0, n_lists) counts as list
    n_lists. For each of the n_lists + 1 lists: the start and count of its
    pairs in ``order``, and ``group_end`` the running count of its groups
    of ``IVF_SCAN_GROUP`` pairs. The groups number at most
    ⌈nq·P / IVF_SCAN_GROUP⌉ + n_lists + 1 (``ivf_scan_grid``). On the card
    it is ivf_group.cuh's grouping (a stable counting sort in three passes
    over segments of ``IVF_GROUP_SEGMENT`` pairs), which ``ivf_scan`` and
    ``fused_ivf_topk`` run before their scans; on the CPU a stable sort,
    its plain version."""
    if probes.device.type == "cuda":
        _check("probes", probes, torch.int32, 2, probes.device)
        n_pairs = probes.numel()
        buf = torch.empty(ivf_group_scratch(n_pairs, n_lists),
                          dtype=torch.int32, device=probes.device)
        with torch.cuda.device(probes.device):
            rc = _lib("ivf_scan").ivf_scan_group(
                probes.data_ptr(), n_pairs, n_lists, buf.data_ptr(),
                _stream(probes.device))
        _check_rc("ivf_scan", rc)
        return torch.split(buf[:n_pairs + 3 * (n_lists + 1)],
                           [n_pairs] + [n_lists + 1] * 3)
    key = probes.reshape(-1)
    key = torch.where((key >= 0) & (key < n_lists), key, n_lists)
    sorted_key, order = torch.sort(key, stable=True)
    # each list's first position among the sorted keys (no count is read
    # back to the host, as torch.bincount would)
    bounds = torch.searchsorted(
        sorted_key, torch.arange(n_lists + 2, dtype=key.dtype,
                                 device=key.device)).to(torch.int32)
    start, count = bounds[:-1], bounds[1:] - bounds[:-1]
    group_end = torch.cumsum(-(-count // IVF_SCAN_GROUP), 0,
                             dtype=torch.int32)
    return order.to(torch.int32), start, count, group_end


def ivf_scan_grid(n_pairs: int, n_lists: int, pad: int) -> Tuple[int, int]:
    """ivf_scan's grid: the host's bound on the groups (blocks past the last
    group exit at once) × the runs of ``IVF_SCAN_CHUNKS_PER_BLOCK`` slot
    chunks."""
    chunks = -(-pad // IVF_SCAN_SLOTS)
    return (-(-n_pairs // IVF_SCAN_GROUP) + n_lists + 1,
            -(-chunks // IVF_SCAN_CHUNKS_PER_BLOCK))


def ivf_scan(probes, qres, list_data, row_norms):
    """Partial distances of every probed slot, the scan of the IVF requests
    the fused kernels decline: ``out [nq, P, pad] f32`` with
    out[q, p, s] = row_norms[l, s] − 2·list_data[l, s]·qres[q, p], l =
    probes[q, p] (+inf for a probe outside [0, n_lists)). probes [nq, P]
    int32; qres [nq, P, rot] f32 (the query replicated per probe, or its
    residual); list_data [n_lists, pad, rot] of a type of ``ROW_TYPES``
    (f32, bf16, fp16, int8, uint8; fp32 accumulation); row_norms [n_lists, pad] f32. Every slot is written; the
    caller adds the query's norm and masks unfilled slots. On the card the
    pairs are grouped by list first (``ivf_scan_groups``, into int32
    scratch of ``ivf_group_scratch(nq·P, n_lists)``), so that each probed
    slab is read once per group of the queries that probe it."""
    tensors = (probes, qres, list_data, row_norms)
    if _on_cpu(*tensors):
        return ivf_scan_plain(*tensors)
    dev = probes.device
    if dev.type != "cuda":
        raise ValueError(f"ivf_scan: unsupported device {dev}")
    nq, n_probes = probes.shape
    n_lists, pad, rot = list_data.shape
    _check("probes", probes, torch.int32, 2, dev)
    _check("qres", qres, torch.float32, 3, dev)
    _check("list_data", list_data, tuple(ROW_TYPES), 3, dev)
    _check("row_norms", row_norms, torch.float32, 2, dev)
    if (tuple(qres.shape) != (nq, n_probes, rot)
            or tuple(row_norms.shape) != (n_lists, pad)):
        raise ValueError("ivf_scan: shapes disagree")
    if rot < 1:
        raise ValueError(f"ivf_scan: rot={rot} < 1")
    out = torch.empty((nq, n_probes, pad), dtype=torch.float32, device=dev)
    n_pairs = nq * n_probes
    if n_pairs == 0 or pad == 0:
        return out
    blocks, chunks = ivf_scan_grid(n_pairs, n_lists, pad)
    if n_pairs > 2**31 - 1 or blocks > 2**31 - 1 or chunks > 65535:
        raise ValueError(f"ivf_scan: {n_pairs} (query, probe) pairs over "
                         f"{n_lists} lists of {pad} slots exceed one "
                         "launch's grid")
    groups = torch.empty(ivf_group_scratch(n_pairs, n_lists),
                         dtype=torch.int32, device=dev)
    lib = _lib("ivf_scan")
    with torch.cuda.device(dev):
        rc = lib.ivf_scan(
            probes.data_ptr(), qres.data_ptr(), list_data.data_ptr(),
            ROW_TYPES[list_data.dtype], row_norms.data_ptr(),
            groups.data_ptr(), n_pairs, n_lists, pad, rot,
            IVF_SCAN_CHUNKS_PER_BLOCK, out.data_ptr(), _stream(dev))
    _check_rc("ivf_scan", rc)
    _count_launch("ivf_scan")
    return out


# ----------------------------------------------------------- ring_shift


def ring_shift_plain(blocks):
    """Plain version of ``ring_shift``: rank r receives a copy of rank
    r-1's block on its own device."""
    size = len(blocks)
    return [blocks[(r - 1) % size].to(blocks[r].device, copy=True)
            for r in range(size)]


#: (source, destination) pairs one ring_shift launch moves (kMaxPairs in
#: ring_shift.cu); a device with more ranks takes more launches
RING_SHIFT_MAX_PAIRS = 32

_sm_counts: Dict[int, int] = {}


def ring_shift_launches(devices) -> list:
    """The launches of one ``ring_shift`` over ranks on ``devices`` (one
    entry a rank, repeats allowed): ``[(source device, [ranks]), ...]``,
    rank r sending its block to rank r + 1. The ranks are grouped by the
    device of their block, in order of first appearance, each group cut
    into runs of at most ``RING_SHIFT_MAX_PAIRS``."""
    groups: Dict = {}
    for r, d in enumerate(devices):
        groups.setdefault(d, []).append(r)
    return [(d, ranks[i:i + RING_SHIFT_MAX_PAIRS])
            for d, ranks in groups.items()
            for i in range(0, len(ranks), RING_SHIFT_MAX_PAIRS)]


def _sm_count(index: int) -> int:
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def ring_shift(blocks):
    """+1 ring rotation of one block per rank (the counterpart of
    ``pallas_ring_shift``): ``out[r]`` is a copy of ``blocks[r - 1]`` on
    ``blocks[r]``'s device. The blocks share shape and dtype and are
    contiguous; devices may repeat (logical ranks on one card) or differ
    (peer cards, which must reach each other's memory: no copy is staged
    through the host). One kernel launch per source device (per
    ``RING_SHIFT_MAX_PAIRS`` of its ranks; ``ring_shift_launches``) moves
    every block on that device, on its current stream, ordered after the
    destination streams' earlier work and before their later work."""
    size = len(blocks)
    if size == 0:
        return []
    if _on_cpu(*blocks):
        return ring_shift_plain(blocks)
    shape, dtype = blocks[0].shape, blocks[0].dtype
    for r, b in enumerate(blocks):
        if b.device.type != "cuda":
            raise ValueError(f"ring_shift: block {r} is on {b.device}; all "
                             "blocks must be on CUDA devices (or all on the "
                             "CPU)")
        if b.shape != shape or b.dtype != dtype:
            raise ValueError(f"ring_shift: block {r} is {tuple(b.shape)} "
                             f"{b.dtype}, block 0 {tuple(shape)} {dtype}")
        if not b.is_contiguous():
            raise ValueError(f"ring_shift: block {r} must be contiguous")
    out = [torch.empty(shape, dtype=dtype, device=b.device) for b in blocks]
    n_bytes = blocks[0].numel() * blocks[0].element_size()
    if n_bytes == 0:
        return out
    lib = _lib("ring_shift")
    for sdev, ranks in ring_shift_launches([b.device for b in blocks]):
        dsts = [out[(r + 1) % size] for r in ranks]
        s_stream = torch.cuda.current_stream(sdev)
        d_streams = []
        for dst in dsts:
            if dst.device == sdev:  # ordered on the source's own stream
                continue
            d_stream = torch.cuda.current_stream(dst.device)
            dst.record_stream(s_stream)
            if d_stream not in d_streams:  # once per destination device
                rc = lib.ring_shift_enable_peer(sdev.index, dst.device.index)
                if rc != 0:
                    raise RuntimeError(
                        f"ring_shift: {sdev} cannot write the memory of "
                        f"{dst.device} (CUDA error {rc}: "
                        f"{lib.rtt_error_string(rc).decode()})")
                d_streams.append(d_stream)
        for d_stream in d_streams:
            s_stream.wait_stream(d_stream)
        n = len(ranks)
        srcs = (ctypes.c_void_p * n)(*(blocks[r].data_ptr() for r in ranks))
        dst_ptrs = (ctypes.c_void_p * n)(*(d.data_ptr() for d in dsts))
        with torch.cuda.device(sdev):
            rc = lib.ring_shift_copy(srcs, dst_ptrs, n, n_bytes,
                                     _sm_count(sdev.index),
                                     s_stream.cuda_stream)
        _check_rc("ring_shift", rc)
        _count_launch("ring_shift")
        for d_stream in d_streams:
            d_stream.wait_stream(s_stream)
    return out
