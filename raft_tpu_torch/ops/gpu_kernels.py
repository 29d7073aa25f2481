"""The port's hand-written CUDA kernels: build, wrappers, plain versions.

Counterpart of ``raft_tpu.ops.pallas_kernels`` for the kernels of this
slice. Each kernel has

- a source in ``raft_tpu_torch/csrc/`` with a plain C interface, compiled by
  ``nvcc`` for ``sm_90a`` into its own shared library at first use (into
  ``build/raft_tpu_torch/`` at the repo root, keyed by a hash of the sources
  and flags) and loaded with ``ctypes``;
- a wrapper that checks device, dtype, shape and contiguity, allocates the
  outputs, launches on PyTorch's current stream, raises if the launch
  failed, and adds one to its count in ``LAUNCHES``;
- a plain PyTorch version of the same function, which the wrapper runs for
  tensors on the CPU and which the CPU tests and ``chip_smoke.py`` hold the
  kernel against.

A CUDA tensor always launches the kernel or raises; nothing falls back to
the plain version on the card. Launches go to the tensors' device, on
PyTorch's current stream there.

Selection order everywhere: ascending value; ties by candidate order (row
id for brute force, (probe, slot) for IVF and IVF-PQ, column for select_k,
buffer first and then position for CAGRA's beam merges); +inf yields id -1;
NaN is never selected.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

from raft_tpu_torch.ops.distance import dot_fp32, einsum_fp32, row_norms_sq

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raft_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: kernel name → source file
SOURCES = {
    "fused_l2_topk": "fused_l2_topk.cu",
    "fused_ivf_topk": "fused_ivf_topk.cu",
    "select_k": "select_k.cu",
    "fused_pq_topk": "fused_pq_topk.cu",
    "fused_cagra_topk": "fused_cagra_topk.cu",
}

#: launches of each kernel since the last ``reset_launch_counts()``
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

#: largest dynamic shared memory a block may ask for on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_K = 1024

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fused_l2_topk": [_VP, _VP, _VP, _VP, _I, _LL, _I, _I, _I, _I,
                      _VP, _VP, _VP, _VP, _VP],
    "fused_ivf_topk": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I,
                       _I, _I, _VP, _VP, _VP],
    "select_k_rows": [_VP, _VP, _LL, _LL, _I, _I, _VP, _VP, _VP],
    "fused_pq_topk": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                      _I, _I, _I, _VP, _VP, _VP],
    "fused_cagra_topk": [_VP, _VP, _VP, _VP, _VP, _I, _LL, _I, _I, _I, _I, _I,
                         _I, _I, _I, _VP, _VP, _VP],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the kernels' libraries that are not built yet, one ``nvcc`` per
    source, all started together. Returns name → library path; raises with
    the compiler's output if a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
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
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def _lib(name: str) -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            fn_names = ["select_k_rows"] if name == "select_k" else [name]
            for fn_name in fn_names:
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


def l2_topk_smem_bytes(tm: int, k: int) -> int:
    """Dynamic shared memory of one fused_l2_topk block (the formula of
    ``l2_smem_bytes`` in fused_l2_topk.cu)."""
    return 32 * (tm + 1) * 4 + 32 * 129 * 4 + 8 + tm * 128 * 8 + tm * k * 8 \
        + tm * 4


def plan_fused_topk(m: int, n: int, k: int, n_sm: int) -> Tuple[int, int]:
    """(query rows per block, database splits) for ``fused_l2_topk``.

    64 query rows per block where the per-row carry leaves room in shared
    memory (k <= 256), else 16. When the query tiles alone give fewer than
    four blocks per SM, the database is cut into ranges scanned by separate
    blocks (at least 8 tiles of 128 rows each) and merged by one more
    pass."""
    tm = 64 if l2_topk_smem_bytes(64, k) <= SMEM_LIMIT else 16
    q_blocks = -(-max(m, 1) // tm)
    want = -(-4 * n_sm // q_blocks)
    splits = max(1, min(want, n // (8 * 128)))
    return tm, splits


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
    tm, splits = plan_fused_topk(m, n, k, n_sm)
    part_v = part_i = out_v
    if splits > 1:
        part_v = torch.empty((m, splits, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((m, splits, k), dtype=torch.int32, device=dev)
    lib = _lib("fused_l2_topk")
    with torch.cuda.device(dev):
        rc = lib.fused_l2_topk(
            x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(), m, n, d,
            k, tm, splits, part_v.data_ptr(), part_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), _stream(dev))
    _check_rc("fused_l2_topk", rc)
    LAUNCHES["fused_l2_topk"] += 1
    return out_v, out_i


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


def fused_ivf_topk(probes, qres, qres_norms, list_data, row_norms,
                   list_indices, k: int, clamp: bool = True):
    """Fused probe gather + scan + top-k for the IVF families.

    probes [nq, P] int32; qres [nq, P, rot] f32 (the query, or its residual
    per probe); qres_norms [nq, P] f32; list_data [L, pad, rot] f32 or bf16
    (fp32 accumulation); row_norms [L, pad] f32; list_indices [L, pad] int32
    with -1 at unfilled slots. Returns ``(distances [nq, k], ids [nq, k])``
    ascending; ``clamp`` applies max(d, 0)."""
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
    _check("list_data", list_data, (torch.float32, torch.bfloat16), 3, dev)
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
    lib = _lib("fused_ivf_topk")
    with torch.cuda.device(dev):
        rc = lib.fused_ivf_topk(
            probes.data_ptr(), qres.data_ptr(), qres_norms.data_ptr(),
            list_data.data_ptr(), int(list_data.dtype == torch.bfloat16),
            row_norms.data_ptr(), list_indices.data_ptr(), nq, n_probes,
            n_lists, pad, rot, k, int(bool(clamp)), out_v.data_ptr(),
            out_i.data_ptr(), _stream(dev))
    _check_rc("fused_ivf_topk", rc)
    LAUNCHES["fused_ivf_topk"] += 1
    return out_v, out_i


# ----------------------------------------------------------- select_k


def streaming_select_k_plain(values, k: int, select_min: bool = True):
    """Plain version of ``streaming_select_k``."""
    v = values.to(torch.float32)
    sv, si = _stable_topk(v if select_min else -v, k)
    return (sv if select_min else -sv).to(values.dtype), si


def streaming_select_k(values, k: int, select_min: bool = True):
    """Streaming top-k of the rows of values [b, n] (the counterpart of
    ``pallas_select_k``): ``(values [b, k], ids [b, k] int32)``, ascending
    (descending for ``select_min=False``), ids -1 past the row's finite
    entries. Values come back in the input dtype; the kernel reads float32."""
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
    lib = _lib("select_k")
    with torch.cuda.device(dev):
        rc = lib.select_k_rows(
            values.data_ptr(), None, b, n, k, int(not select_min),
            out_v.data_ptr(), out_i.data_ptr(), _stream(dev))
    _check_rc("select_k", rc)
    LAUNCHES["select_k"] += 1
    return out_v, out_i


# ------------------------------------------------------ fused_pq_topk

PQ_BOOK = 256  # codebook entries per subspace at pq_bits 8


def pq_topk_smem_bytes(pq_dim: int, pq_len: int, k: int) -> int:
    """Dynamic shared memory of one fused_pq_topk block (the formula of
    ``pq_smem_bytes`` in fused_pq_topk.cu): survivors, the probe's LUT, the
    carry, the residual and the partial sums of its norm."""
    return (256 * 8 + pq_dim * PQ_BOOK * 4 + k * 8 + 16 + pq_dim * pq_len * 4
            + (256 // 32 + 1) * 4)


def fused_pq_fits(pq_dim: int, pq_len: int, k: int) -> bool:
    """True when one probe's LUT, with the carry, fits a block's shared
    memory on Hopper (pq_dim up to about 200 at k=1024)."""
    return pq_topk_smem_bytes(pq_dim, pq_len, k) <= SMEM_LIMIT


def fused_pq_topk_plain(probes, q_rot, centers_rot, codebooks, cb_norms,
                        list_codes, list_indices, k: int):
    """Plain version of ``fused_pq_topk``: per query chunk the probes'
    residuals, their LUTs by one fp32 product, the per-subspace entries
    gathered and summed in subspace order, ‖res‖² added, ids < 0 (and probes
    outside [0, n_lists)) +inf, and the selection over the candidates in
    (probe, slot) order."""
    nq, n_probes = probes.shape
    n_lists, pad, pq_dim = list_codes.shape
    book, pq_len = codebooks.shape[1], codebooks.shape[2]
    # per query: the LUTs and their product, then acc, ids, gathered codes
    per_q = n_probes * (pq_dim * book * 8 + pad * 24)
    step = _row_chunk(1, per_q)
    out_v, out_i = [], []
    for s0 in range(0, nq, step):
        pr = probes[s0:s0 + step].to(torch.int64)
        valid = (pr >= 0) & (pr < n_lists)
        pr = pr.clamp(0, n_lists - 1)
        t = pr.shape[0]
        res = q_rot[s0:s0 + step, None, :].to(torch.float32) - centers_rot[pr]
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
        d = torch.where((ids < 0) | ~valid[:, :, None], torch.inf, d)
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
    ids [nq, k])``, unclamped."""
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
    vec16 = int(pq_dim % 16 == 0 and list_codes.data_ptr() % 16 == 0)
    lib = _lib("fused_pq_topk")
    with torch.cuda.device(dev):
        rc = lib.fused_pq_topk(
            probes.data_ptr(), q_rot.data_ptr(), centers_rot.data_ptr(),
            codebooks.data_ptr(), cb_norms.data_ptr(), list_codes.data_ptr(),
            list_indices.data_ptr(), nq, n_probes, n_lists, pad, pq_dim,
            pq_len, k, vec16, out_v.data_ptr(), out_i.data_ptr(),
            _stream(dev))
    _check_rc("fused_pq_topk", rc)
    LAUNCHES["fused_pq_topk"] += 1
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
    """Dynamic shared memory of one fused_cagra_topk block (the formula of
    ``cagra_smem_bytes`` in fused_cagra_topk.cu): two beam buffers (keys,
    ids, flags), the query row, the candidates' ids, keys and sort slots,
    the parents and two counters."""
    cap = cagra_cand_cap(width, degree)
    return (2 * (2 * _align16(itopk * 4) + _align16(itopk))
            + _align16(dim * 4) + cap * 8 + cap * 8 + _align16(width * 4)
            + 16)


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
    the beam; ``max_iter`` <= 0 applies the auto heuristic."""
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
    smem = cagra_topk_smem_bytes(itopk, dim, width, degree)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_cagra_topk: itopk={itopk}, dim={dim}, width={width}, "
            f"degree={degree} need {smem} bytes of shared memory, more than "
            f"a block's {SMEM_LIMIT}")
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
                n_seeds, k, itopk, width, max_iter, vec4, out_v.data_ptr(),
                out_i.data_ptr(), _stream(dev))
        _check_rc("fused_cagra_topk", rc)
        LAUNCHES["fused_cagra_topk"] += 1
    return out_v, out_i
