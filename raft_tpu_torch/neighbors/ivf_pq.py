"""IVF-PQ — inverted-file index with product-quantized residuals.

Counterpart of ``raft_tpu.neighbors.ivf_pq``, with its layout and its
engines. Lists are padded dense ``[n_lists, list_pad, pq_dim·pq_bits/8]``
uint8 storage of bit-packed codes (pq_bits 4-8, little-endian bit order)
with int32 row ids (-1 at unfilled slots), capped by ``list_pad_expansion``;
rows spilled from hot lists live in an overflow block (packed codes, their
coarse list, ids) that every query scans.

Build: balanced k-means on a trainset subsample, a rotation (identity when
``rot_dim == dim`` and no random rotation is asked for; else normal + QR),
codebooks per subspace or per cluster trained by Lloyd EM on rotated
residuals (groups batched and tiled from the workspace budget), then
``extend``: encode, bit-pack, and pack the lists (host numpy for a fresh
index, a device scatter when appending).

Search picks the probed lists in rotated space and scans them by one of four
engines (``plan_search`` says which, and why):

- ``pallas_cache``: the decoded-residual cache (bf16 or f32, built lazily)
  through the fused scan + top-k kernel ``ops.gpu_kernels.fused_ivf_topk``,
  unclamped, as ADC distances;
- ``pallas_lut``: the fused LUT kernel ``ops.gpu_kernels.fused_pq_topk``,
  which builds each probe's LUT in shared memory and scans the packed codes
  (pq_bits 8, PER_SUBSPACE, float32 LUT and distances, a LUT that fits a
  block's shared memory);
- ``cache`` and ``lut``: the unfused engines, which take every request the
  fused ones decline (InnerProduct, filters, k > 1024, pq_bits 4-7,
  PER_CLUSTER, bf16 or fp8 LUTs, bf16 distances), and, under ``"auto"``
  on the card, every request whose measured verdict says the fused engine
  loses (``ops.gpu_kernels.fused_dispatch_explained``). Under ``"pallas"``
  (and ``"auto"`` where the ``ivf_scan`` verdict wins) the cache engine
  scans the probed slots through the unfused scan kernel
  ``ops.gpu_kernels.ivf_scan`` (``plan["unfused_ivf_scan"]``); a forced
  ``"cache"`` gathers the probed slabs instead. The LUT engine
  tiles queries and probes jointly from the workspace budget.

``scan_mode="auto"``/``"pallas"`` choose between the cache and LUT regimes by
the same memory model as the JAX package (``resolve_scan_mode``, against
``Resources.device_memory_bytes``); ``"cache"``/``"lut"`` force an unfused
engine. The fused engines' overflow rows are scanned unfused and merged by
one ``select_k``.

Every search records its engine and why (``obs.explain.record_dispatch``;
``explain=True`` returns the record). ``serialize``/``deserialize`` write
and read the JAX package's file format; ``helpers`` unpacks, packs and
reconstructs one list.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.bitset import filter_mask as bitset_filter_mask
from raft_tpu_torch.core.resources import (Resources, ensure_resources,
                                           solve_joint_tiles)
from raft_tpu_torch.neighbors import list_packing
from raft_tpu_torch.neighbors.brute_force import (explained,
                                                  fused_ineligible_reason,
                                                  host_wait, kernel_plan)
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.neighbors.ivf_flat import _as_tensor, ivf_scan_routed
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops import rng as rrng
from raft_tpu_torch.ops.distance import (DistanceType, dot_fp32, einsum_fp32,
                                         resolve_metric, row_norms_sq)
from raft_tpu_torch.ops.select_k import (SelectAlgo, select_k,
                                         select_k_maybe_approx)
from raft_tpu_torch.utils.shape import (as_query_array, balanced_tile, cdiv,
                                        query_bucket)

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
_LUT_DTYPES = (torch.float32, torch.bfloat16) + _FP8
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)


class CodebookGen(enum.IntEnum):
    PER_SUBSPACE = 0
    PER_CLUSTER = 1


@dataclasses.dataclass
class IndexParams:
    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8
    pq_dim: int = 0  # 0 → heuristic (see _calc_pq_dim)
    codebook_kind: CodebookGen = CodebookGen.PER_SUBSPACE
    force_random_rotation: bool = False
    add_data_on_build: bool = True
    # caps list_pad so that L·pad plus the overflow block stays within this
    # multiple of the row count
    list_pad_expansion: float = 1.5

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        self.codebook_kind = CodebookGen(self.codebook_kind)
        if not 4 <= self.pq_bits <= 8:
            raise ValueError(f"pq_bits must be in [4, 8], got {self.pq_bits}")
        if self.list_pad_expansion < 1.0:
            raise ValueError(
                f"list_pad_expansion must be >= 1.0, got "
                f"{self.list_pad_expansion}")
        if self.metric not in (DistanceType.L2Expanded,
                               DistanceType.L2SqrtExpanded,
                               DistanceType.InnerProduct):
            raise ValueError(
                f"ivf_pq supports L2Expanded/L2SqrtExpanded/InnerProduct, got "
                f"{self.metric.name}")


def _dtype(value, allowed, what: str) -> torch.dtype:
    """A torch dtype from a dtype or its name ("float32", "bfloat16", ...)."""
    dt = value if isinstance(value, torch.dtype) else getattr(
        torch, str(value), None)
    if dt not in allowed:
        raise ValueError(f"{what}={value!r}: expected one of "
                         f"{[str(a) for a in allowed]}")
    return dt


@dataclasses.dataclass
class SearchParams:
    """``lut_dtype``: float32, bfloat16, float8_e4m3fn or float8_e5m2 (fp8
    LUTs are max-abs scaled per subspace); ``internal_distance_dtype`` and
    ``scan_cache_dtype``: float32 or bfloat16 (torch dtypes or their names).
    ``scan_mode``: ``"auto"``/``"pallas"`` take the fused kernels where the
    request allows, in the memory regime ``resolve_scan_mode`` picks;
    ``"cache"``/``"lut"`` force an unfused engine. ``select_recall`` < 1 asks
    for approximate selection, which the port answers exactly."""

    n_probes: int = 20
    lut_dtype: object = torch.float32
    internal_distance_dtype: object = torch.float32
    scan_mode: str = "auto"
    scan_cache_dtype: object = torch.bfloat16
    select_recall: float = 1.0

    def __post_init__(self):
        self.lut_dtype = _dtype(self.lut_dtype, _LUT_DTYPES, "lut_dtype")
        self.internal_distance_dtype = _dtype(
            self.internal_distance_dtype, _FLOAT_DTYPES,
            "internal_distance_dtype")
        self.scan_cache_dtype = _dtype(self.scan_cache_dtype, _FLOAT_DTYPES,
                                       "scan_cache_dtype")


def _calc_pq_dim(dim: int) -> int:
    """Default pq_dim: a power of two close to dim/2, at least 8."""
    p = 1
    while p * 2 <= dim // 2 or p < 8:
        p *= 2
        if p >= 512:
            break
    return max(min(p, dim + (-dim) % 8), 8)


class Index:
    """Coarse centers, rotation, codebooks, packed list codes with ids and
    sizes, and the overflow block, all on one device; plus the lazily built
    decoded scan cache and decoded overflow block."""

    def __init__(self, params: IndexParams, pq_dim: int, centers, rotation,
                 codebooks, list_codes, list_indices, list_sizes, n_rows: int,
                 overflow_codes=None, overflow_labels=None,
                 overflow_indices=None):
        self.params = params
        self.pq_dim = int(pq_dim)
        self.centers = centers  # [n_lists, dim] fp32
        self.rotation = rotation  # [rot_dim, dim] fp32
        # PER_SUBSPACE [pq_dim, book, pq_len]; PER_CLUSTER [n_lists, book, pq_len]
        self.codebooks = codebooks
        self.list_codes = list_codes  # [n_lists, list_pad, n_code_bytes] u8
        self.list_indices = list_indices  # [n_lists, list_pad] int32, -1 pad
        self.list_sizes = list_sizes  # [n_lists] int32
        self.n_rows = int(n_rows)
        dev = centers.device
        n_bytes = (self.pq_dim * params.pq_bits) // 8
        self.overflow_codes = (
            overflow_codes if overflow_codes is not None
            else torch.zeros((0, n_bytes), dtype=torch.uint8, device=dev))
        self.overflow_labels = (
            overflow_labels if overflow_labels is not None
            else torch.zeros((0,), dtype=torch.int32, device=dev))
        self.overflow_indices = (
            overflow_indices if overflow_indices is not None
            else torch.zeros((0,), dtype=torch.int32, device=dev))
        # decoded residuals [n_lists, list_pad, rot_dim] and their squared
        # norms [n_lists, list_pad] f32 (ensure_scan_cache)
        self.list_decoded = None
        self.decoded_norms = None
        # full rotated overflow vectors [n_over, rot_dim] + ‖v‖² f32
        self.overflow_decoded = None
        self.overflow_norms = None
        # True when the overflow rows (the lists) came decoded, without
        # their codes (``index_from_parts``: a sharded checkpoint): they
        # cannot be decoded in another dtype or re-packed, and lists without
        # codes are searched in the cache regime only
        self.overflow_decoded_only = False
        self.lists_decoded_only = False
        self._safe_ids = None

    @property
    def metric(self) -> DistanceType:
        return self.params.metric

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def pq_bits(self) -> int:
        return self.params.pq_bits

    @property
    def pq_len(self) -> int:
        return self.rot_dim // self.pq_dim

    @property
    def pq_book_size(self) -> int:
        return 1 << self.pq_bits

    @property
    def size(self) -> int:
        return self.n_rows

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def centers_rot(self) -> torch.Tensor:
        return dot_fp32(self.centers, self.rotation)

    def safe_ids(self) -> torch.Tensor:
        """List ids with -1 at every slot past the list's size."""
        if self._safe_ids is None:
            pad = self.list_codes.shape[1]
            valid = (torch.arange(pad, device=self.device)[None, :]
                     < self.list_sizes[:, None])
            self._safe_ids = torch.where(valid, self.list_indices,
                                         -1).to(torch.int32).contiguous()
        return self._safe_ids


# ------------------------------------------------------------ rotation matrix


def make_rotation_matrix(generator: torch.Generator, rot_dim: int, dim: int,
                         force_random: bool,
                         device: torch.device) -> torch.Tensor:
    """[rot_dim, dim] with orthonormal columns: the identity (an identity
    embedding when dim is padded) unless ``force_random``, else a normal
    matrix's QR factor."""
    if not force_random:
        return torch.eye(rot_dim, dim, dtype=torch.float32, device=device)
    a = torch.randn((rot_dim, rot_dim), generator=generator,
                    dtype=torch.float32, device=device)
    q, _ = torch.linalg.qr(a)
    return q[:, :dim].contiguous()


# ---------------------------------------------------------- code (un)packing


def _pack_codes_np(codes: np.ndarray, pq_bits: int) -> np.ndarray:
    """Bit-pack [n, pq_dim] uint8 codes → [n, pq_dim·pq_bits/8] bytes
    (little-endian bit order)."""
    n, pq_dim = codes.shape
    bits = (codes[:, :, None] >> np.arange(pq_bits, dtype=np.uint8)) & 1
    flat = bits.reshape(n, pq_dim * pq_bits)
    return np.packbits(flat, axis=1, bitorder="little")


@functools.lru_cache(maxsize=None)
def _pack_terms(pq_dim: int, pq_bits: int):
    """(code index, shift, valid) terms per output byte for device-side
    packing: byte j collects the codes whose bit span meets [8j, 8j+8), at
    most 3 for pq_bits in [4, 8]. shift >= 0 means ``code << shift``, else
    ``code >> -shift``. Host numpy, cached per shape."""
    n_bytes = pq_dim * pq_bits // 8
    terms = []
    for j in range(n_bytes):
        lo_k = (8 * j) // pq_bits
        hi_k = min((8 * j + 7) // pq_bits, pq_dim - 1)
        terms.append([(k, k * pq_bits - 8 * j)
                      for k in range(lo_k, hi_k + 1)])
    width = max(len(t) for t in terms)
    ks = np.zeros((n_bytes, width), np.int64)
    shifts = np.zeros((n_bytes, width), np.int32)
    valid = np.zeros((n_bytes, width), bool)
    for j, t in enumerate(terms):
        for w, (k, s) in enumerate(t):
            ks[j, w], shifts[j, w], valid[j, w] = k, s, True
    return ks, shifts, valid


def _pack_codes(codes: torch.Tensor, pq_dim: int, pq_bits: int) -> torch.Tensor:
    """[..., pq_dim] integer codes → [..., pq_dim·pq_bits/8] uint8 on the
    codes' device, bit-identical to ``_pack_codes_np``."""
    ks, shifts, valid = (torch.from_numpy(a).to(codes.device)
                         for a in _pack_terms(pq_dim, pq_bits))
    c = codes.to(torch.int32)[..., ks]  # [..., n_bytes, width]
    up = torch.where(shifts >= 0, c << shifts.clamp_min(0),
                     c >> (-shifts).clamp_min(0))
    up = torch.where(valid, up, 0)
    # the terms' in-byte bits are disjoint, so the sum mod 256 is their OR
    return (up.sum(-1) & 0xFF).to(torch.uint8)


def _unpack_positions(pq_dim: int, pq_bits: int, device: torch.device):
    """Per-subspace (lo_byte, hi_byte, shift) of the two-byte unpack, made
    on ``device``: a copy from host memory would block the host inside a
    search."""
    pos = torch.arange(pq_dim, device=device) * pq_bits
    lo = pos // 8
    sh = (pos % 8).to(torch.int32)
    hi = torch.clamp_max(lo + 1, pq_dim * pq_bits // 8 - 1)
    return lo, hi, sh


def _unpack_codes(code_bytes: torch.Tensor, pq_dim: int,
                  pq_bits: int) -> torch.Tensor:
    """[..., n_bytes] uint8 → [..., pq_dim] int32 codes; each field spans at
    most two bytes."""
    lo, hi, sh = _unpack_positions(pq_dim, pq_bits, code_bytes.device)
    b = code_bytes.to(torch.int32)
    word = b[..., lo] | (b[..., hi] << 8)
    return (word >> sh) & ((1 << pq_bits) - 1)


# --------------------------------------------------------- codebook training


def _train_codebooks(generator: torch.Generator, subvecs: torch.Tensor,
                     weights: torch.Tensor, book_size: int, n_iters: int,
                     workspace_limit_bytes: int) -> torch.Tensor:
    """Lloyd EM for G codebooks at once: subvecs [G, n, l], weights [G, n]
    (0 = padding) → codebooks [G, book, l].

    Per group: ``book_size`` distinct weighted rows seed the centers (rows
    reused cyclically when there are fewer); each iteration assigns every
    row to its nearest center, takes weighted means, and re-seeds empty
    codes from a random seed row. Groups are independent and run in
    lockstep, G_tile at a time and each E-step in row tiles, so that the
    [G_tile, row_tile, book] distance block fits the workspace budget (the
    JAX package maps one group at a time); the random draws are made up
    front, so the tiles do not change them. The M-step sums each code's rows
    in row order (``kmeans_balanced.sum_by_label``), so two runs from the
    same generator give the same codebooks on the card too."""
    n_groups, n, l = subvecs.shape
    dev = subvecs.device
    g_tile, r_tile = solve_joint_tiles(workspace_limit_bytes, book_size * 8,
                                       n, outer_cap=n_groups, outer_multiple=1)
    # every draw is made up front, so the tiling does not change the result:
    # seeds are a uniform sample of weighted rows without replacement
    keys = torch.rand((n_groups, n), generator=generator, device=dev)
    keys = torch.where(weights > 0, keys, -1.0)
    seed_rows = torch.topk(keys, min(book_size, n), dim=1).indices
    if n < book_size:
        seed_rows = seed_rows.repeat(1, cdiv(book_size, n))[:, :book_size]
    donor_draws = torch.randint(0, seed_rows.shape[1],
                                (n_iters, n_groups, book_size),
                                generator=generator, device=dev)
    out = torch.empty((n_groups, book_size, l), dtype=torch.float32,
                      device=dev)
    for g0 in range(0, n_groups, g_tile):
        sv = subvecs[g0:g0 + g_tile].to(torch.float32)
        w = weights[g0:g0 + g_tile].to(torch.float32)
        seeds = seed_rows[g0:g0 + g_tile]
        g = sv.shape[0]
        rows_g = torch.arange(g, device=dev)[:, None]
        centers = sv[rows_g, seeds]  # [g, book, l]
        flat_base = (torch.arange(g, device=dev) * book_size)[:, None]
        wx = (sv * w[:, :, None]).reshape(g * n, l)
        for it in range(n_iters):
            cn = (centers * centers).sum(-1)  # [g, book]
            labels = torch.empty((g, n), dtype=torch.int64, device=dev)
            for r0 in range(0, n, r_tile):
                d = cn[:, None, :] - 2.0 * einsum_fp32(
                    "grl,gcl->grc", sv[:, r0:r0 + r_tile], centers)
                labels[:, r0:r0 + r_tile] = torch.argmin(d, dim=2)
            flat = (labels + flat_base).reshape(-1)
            sums = kmeans_balanced.sum_by_label(wx, flat, g * book_size)
            counts = kmeans_balanced.sum_by_label(w.reshape(-1), flat,
                                                  g * book_size)
            new = (sums / torch.clamp_min(counts, 1.0)[:, None]).reshape(
                g, book_size, l)
            donor = seeds[rows_g, donor_draws[it, g0:g0 + g]]
            empty = (counts < 0.5).reshape(g, book_size)
            centers = torch.where(empty[:, :, None], sv[rows_g, donor], new)
        out[g0:g0 + g] = centers
    return out


def _group_rows(rows: torch.Tensor, labels: torch.Tensor, n_lists: int,
                cap: int):
    """Rows grouped by label into [n_lists, cap, d] with 0/1 weights,
    keeping each label's first ``cap`` rows in input order."""
    order, sl, slot = list_packing.label_slots(
        labels, torch.zeros(n_lists, dtype=torch.int32, device=rows.device),
        n_lists)
    keep = slot < cap
    grouped = torch.zeros((n_lists, cap, rows.shape[1]), dtype=torch.float32,
                          device=rows.device)
    grouped[sl[keep], slot[keep]] = rows[order][keep].to(torch.float32)
    weights = torch.zeros((n_lists, cap), dtype=torch.float32,
                          device=rows.device)
    weights[sl[keep], slot[keep]] = 1.0
    return grouped, weights


# ---------------------------------------------------------------- encoding


def _encode(x, labels, centers, rotation, codebooks, per_cluster: bool,
            row_tile: int) -> torch.Tensor:
    """Residual-encode rows → int32 codes [n, pq_dim], a row tile at a
    time: rotate the residual, pick each subspace's nearest codebook entry
    (ties to the lowest entry)."""
    pq_len = codebooks.shape[2]
    pq_dim = rotation.shape[0] // pq_len
    out = torch.empty((x.shape[0], pq_dim), dtype=torch.int32, device=x.device)
    if not per_cluster:
        cn_all = (codebooks * codebooks).sum(-1)  # [s, book]
    for r0 in range(0, x.shape[0], row_tile):
        lt = labels[r0:r0 + row_tile].to(torch.int64)
        rr = dot_fp32(x[r0:r0 + row_tile].to(torch.float32) - centers[lt],
                      rotation)
        sub = rr.reshape(-1, pq_dim, pq_len)
        if per_cluster:
            cb = codebooks[lt]  # [t, book, l]
            d = (cb * cb).sum(-1)[:, None, :] - 2.0 * einsum_fp32(
                "tsl,tcl->tsc", sub, cb)
        else:
            d = cn_all[None, :, :] - 2.0 * einsum_fp32("tsl,scl->tsc", sub,
                                                       codebooks)
        out[r0:r0 + row_tile] = torch.argmin(d, dim=-1).to(torch.int32)
    return out


def encode_batch(index: Index, vectors, labels,
                 res: Optional[Resources] = None) -> torch.Tensor:
    """Residual-encode and bit-pack one batch of vectors against their
    coarse labels → packed code bytes [n, pq_dim·pq_bits/8] on the index's
    device."""
    res = ensure_resources(res, index.device)
    vectors = _as_tensor(vectors, index.device).to(torch.float32)
    labels = _as_tensor(labels, index.device)
    per_cluster = index.params.codebook_kind == CodebookGen.PER_CLUSTER
    row_tile = int(np.clip(
        res.workspace_limit_bytes
        // max(index.pq_dim * index.pq_book_size * 4 * 4, 1), 8, 4096))
    row_tile = max(balanced_tile(len(vectors), row_tile, 8), 8)
    codes = _encode(vectors, labels, index.centers, index.rotation,
                    index.codebooks, per_cluster, row_tile)
    return _pack_codes(codes, index.pq_dim, index.pq_bits)


# ------------------------------------------------------------ the scan cache


def _decode_lists(codebooks, list_codes, pq_dim: int, pq_bits: int,
                  per_cluster: bool, list_tile: int, cache_dtype):
    """Decode packed list codes → residuals [L, pad, rot_dim] in
    ``cache_dtype`` plus their squared norms [L, pad] f32, taken from the
    float32 decode before the cast; a list tile at a time."""
    n_lists, list_pad, _ = list_codes.shape
    book, pq_len = codebooks.shape[1], codebooks.shape[2]
    rot = pq_dim * pq_len
    dev = list_codes.device
    dec_out = torch.empty((n_lists, list_pad, rot), dtype=cache_dtype,
                          device=dev)
    norms_out = torch.empty((n_lists, list_pad), dtype=torch.float32,
                            device=dev)
    flat = codebooks.reshape(-1, pq_len)
    offs = torch.arange(pq_dim, device=dev) * book
    for l0 in range(0, n_lists, list_tile):
        codes = _unpack_codes(list_codes[l0:l0 + list_tile], pq_dim,
                              pq_bits).to(torch.int64)  # [lt, pad, s]
        if per_cluster:
            lists = torch.arange(l0, l0 + codes.shape[0], device=dev)
            dec = codebooks[lists[:, None, None], codes]  # [lt, pad, s, l]
        else:
            dec = flat[codes + offs]
        dec = dec.reshape(codes.shape[0], list_pad, rot)
        norms_out[l0:l0 + list_tile] = (dec * dec).sum(-1)
        dec_out[l0:l0 + list_tile] = dec.to(cache_dtype)
    return dec_out, norms_out


def ensure_scan_cache(index: Index, dtype=torch.bfloat16) -> None:
    """Build the decoded-residual scan cache if it is absent or of another
    dtype. bf16 (the default) halves the scan's reads; float32 gives the
    LUT engine's distances up to summation order."""
    if index.list_codes is None:
        return
    dtype = _dtype(dtype, _FLOAT_DTYPES, "scan_cache_dtype")
    if index.list_decoded is not None and index.list_decoded.dtype == dtype:
        return
    if index.lists_decoded_only:
        raise ValueError(
            f"the lists of this index came decoded in "
            f"{index.list_decoded.dtype} without their codes; search it "
            f"with scan_cache_dtype={index.list_decoded.dtype}, not {dtype}")
    per_cluster = index.params.codebook_kind == CodebookGen.PER_CLUSTER
    list_tile = balanced_tile(index.n_lists, min(index.n_lists, 128), 8)
    index.list_decoded, index.decoded_norms = _decode_lists(
        index.codebooks, index.list_codes, index.pq_dim, index.pq_bits,
        per_cluster, list_tile, dtype)


def _decode_overflow(codebooks, centers_rot, codes_bytes, labels,
                     pq_dim: int, pq_bits: int, per_cluster: bool,
                     cache_dtype):
    """Decode spilled code rows → full rotated vectors [O, rot_dim] (coarse
    center + decoded residual: overflow rows mix lists) + ‖v‖² f32 from the
    float32 decode."""
    book, pq_len = codebooks.shape[1], codebooks.shape[2]
    codes = _unpack_codes(codes_bytes, pq_dim, pq_bits).to(torch.int64)
    lab = labels.to(torch.int64)
    if per_cluster:
        dec = codebooks[lab[:, None], codes]  # [O, s, l]
    else:
        offs = torch.arange(pq_dim, device=codes.device) * book
        dec = codebooks.reshape(-1, pq_len)[codes + offs]
    full = centers_rot[lab] + dec.reshape(codes.shape[0], pq_dim * pq_len)
    return full.to(cache_dtype), (full * full).sum(-1)


def drop_scan_cache(index: Index) -> None:
    """Free the decoded-residual scan cache; the next search in the cache
    regime decodes it again, and the LUT regime never needs it."""
    if index.lists_decoded_only:
        raise ValueError("the lists of this index came decoded without "
                         "their codes; their cache cannot be dropped")
    index.list_decoded = index.decoded_norms = None


def ensure_overflow_decoded(index: Index, dtype=torch.bfloat16) -> None:
    """Materialize the decoded overflow block (only spilled rows)."""
    if index.overflow_codes.shape[0] == 0:
        return
    dtype = _dtype(dtype, _FLOAT_DTYPES, "scan_cache_dtype")
    if (index.overflow_decoded is not None
            and index.overflow_decoded.dtype == dtype):
        return
    if index.overflow_decoded_only:
        raise ValueError(
            f"the overflow rows of this index came decoded in "
            f"{index.overflow_decoded.dtype} without their codes; search it "
            f"with scan_cache_dtype={index.overflow_decoded.dtype}, not "
            f"{dtype}")
    per_cluster = index.params.codebook_kind == CodebookGen.PER_CLUSTER
    index.overflow_decoded, index.overflow_norms = _decode_overflow(
        index.codebooks, index.centers_rot, index.overflow_codes,
        index.overflow_labels, index.pq_dim, index.pq_bits, per_cluster,
        dtype)


def _placeholder(shape, dtype, device) -> torch.Tensor:
    """Zeros of ``shape`` that hold no memory (every stride 0)."""
    return torch.zeros((), dtype=dtype, device=device).expand(*shape)


def index_from_parts(params: IndexParams, pq_dim: int, centers, rotation,
                     list_indices, list_sizes, n_rows: int, codebooks=None,
                     list_codes=None, list_decoded=None, decoded_norms=None,
                     overflow_decoded=None, overflow_norms=None,
                     overflow_indices=None) -> Index:
    """An index from the parts one rank of a sharded index keeps (the JAX
    package's ``ShardedIvfPq`` fields, tensors on one device): the packed
    codes with their codebooks (LUT regime), the decoded cache with its
    norms (cache regime), or both; the overflow block decoded only
    ([O, rot_dim] full rotated vectors, ‖v‖², ids). Absent codes and
    codebooks become placeholders that hold no memory, and the index is
    marked ``lists_decoded_only`` / ``overflow_decoded_only``."""
    dev = centers.device
    n_bytes = pq_dim * params.pq_bits // 8
    lists_decoded_only = list_codes is None
    if lists_decoded_only:
        if list_decoded is None:
            raise ValueError("an index needs its codes or its decoded lists")
        list_codes = _placeholder((*list_indices.shape, n_bytes),
                                  torch.uint8, dev)
        codebooks = _placeholder((0, 1 << params.pq_bits, 0), torch.float32,
                                 dev)
    n_over = 0 if overflow_indices is None else overflow_indices.shape[0]
    idx = Index(params, pq_dim, centers, rotation, codebooks, list_codes,
                list_indices, list_sizes, n_rows,
                _placeholder((n_over, n_bytes), torch.uint8, dev),
                _placeholder((n_over,), torch.int32, dev),
                overflow_indices if n_over else None)
    idx.lists_decoded_only = lists_decoded_only
    if list_decoded is not None:
        idx.list_decoded, idx.decoded_norms = list_decoded, decoded_norms
    if n_over:
        idx.overflow_decoded, idx.overflow_norms = (overflow_decoded,
                                                    overflow_norms)
        idx.overflow_decoded_only = True
    return idx


# --------------------------------------------------------------------- build


def _pack_lists_np(code_bytes: np.ndarray, labels: np.ndarray, n_lists: int,
                   ids: np.ndarray, max_expansion: float = 1.5):
    """Group packed code rows by list into capped padded storage on the
    host; rows past a hot list's cap spill to the returned overflow block.
    Returns (codes, idxs, sizes, over_codes, over_labels, over_ids)."""
    sizes = np.bincount(labels, minlength=n_lists).astype(np.int32)
    pad = list_packing.choose_list_pad(sizes, max_expansion)
    ids = np.asarray(ids, np.int32)
    if int(sizes.max(initial=0)) <= pad:
        codes, idxs, sizes = native.pack_lists_numpy(code_bytes, labels,
                                                     n_lists, pad, ids)
        return (codes, idxs, sizes, code_bytes[:0],
                np.zeros((0,), np.int32), np.zeros((0,), np.int32))
    keep = list_packing.fit_mask(labels, n_lists, pad)
    codes, idxs, sizes = native.pack_lists_numpy(
        np.ascontiguousarray(code_bytes[keep]), labels[keep], n_lists, pad,
        np.ascontiguousarray(ids[keep]))
    over_codes, over_ids = list_packing.pad_overflow_block(
        np.ascontiguousarray(code_bytes[~keep]),
        np.ascontiguousarray(ids[~keep]))
    over_labels = np.zeros((len(over_ids),), np.int32)
    spill_lab = labels[~keep]
    over_labels[:len(spill_lab)] = spill_lab
    return codes, idxs, sizes, over_codes, over_labels, over_ids


@tracing.range("ivf_pq.build")
def build(dataset, params: Optional[IndexParams] = None,
          res: Optional[Resources] = None, coarse_centers=None,
          device=None) -> Index:
    """Train the coarse quantizer, rotation and codebooks on a subsample and
    (by default) add the dataset. ``coarse_centers`` [n_lists, dim] skips
    the coarse k-means. Runs on CUDA unless ``device="cpu"`` (or ``res``)
    says otherwise."""
    params = params or IndexParams()
    res = ensure_resources(res, device)
    dataset = _as_tensor(dataset, res.device)
    n_rows, dim = dataset.shape
    if params.n_lists > n_rows:
        raise ValueError(f"n_lists={params.n_lists} > n_rows={n_rows}")
    pq_dim = params.pq_dim or _calc_pq_dim(dim)
    if (pq_dim * params.pq_bits) % 8 != 0:
        raise ValueError(f"pq_dim*pq_bits must be a multiple of 8 (got "
                         f"{pq_dim}*{params.pq_bits})")
    pq_len = cdiv(dim, pq_dim)
    rot_dim = pq_len * pq_dim

    n_train = max(int(n_rows * params.kmeans_trainset_fraction),
                  params.n_lists)
    n_train = min(n_train, n_rows)
    trainset = rrng.subsample_rows(res.generator, dataset,
                                   n_train).to(torch.float32)
    km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric=params.metric)
    if coarse_centers is not None:
        centers = _as_tensor(coarse_centers, res.device).to(torch.float32)
        if tuple(centers.shape) != (params.n_lists, dim):
            raise ValueError(
                f"coarse_centers shape {tuple(centers.shape)} != "
                f"(n_lists={params.n_lists}, dim={dim})")
    else:
        centers = kmeans_balanced.fit(res.generator, trainset, params.n_lists,
                                      km)
    rotation = make_rotation_matrix(res.generator, rot_dim, dim,
                                    params.force_random_rotation, res.device)

    labels = kmeans_balanced.predict(centers, trainset, km)
    residuals = dot_fp32(trainset - centers[labels.long()], rotation)
    book = 1 << params.pq_bits
    if params.codebook_kind == CodebookGen.PER_SUBSPACE:
        sub = residuals.reshape(n_train, pq_dim, pq_len).permute(1, 0, 2)
        w = torch.ones((pq_dim, n_train), dtype=torch.float32,
                       device=res.device)
    else:
        sizes = torch.bincount(labels.long(), minlength=params.n_lists)
        cap = max(int(min(int(sizes.max()),
                          max(2 * n_train // params.n_lists, book))), book)
        grouped, weights = _group_rows(residuals, labels, params.n_lists, cap)
        sub = grouped.reshape(params.n_lists, cap * pq_dim, pq_len)
        w = weights.repeat_interleave(pq_dim, dim=1)
    codebooks = _train_codebooks(res.generator, sub.contiguous(), w, book,
                                 params.kmeans_n_iters,
                                 res.workspace_limit_bytes)
    index = Index(params, pq_dim, centers, rotation, codebooks, None, None,
                  None, 0)
    if params.add_data_on_build:
        index = extend(index, dataset, res=res)
    return index


@tracing.range("ivf_pq.extend")
def extend(index: Index, new_vectors, new_indices=None,
           res: Optional[Resources] = None) -> Index:
    """Encode and add vectors (with ids, or ids past every existing one) on
    the index's device and return the new index."""
    if index.overflow_decoded_only or index.lists_decoded_only:
        raise ValueError("this index came decoded without its codes, so it "
                         "cannot be extended")
    dev = index.device
    res = ensure_resources(res, dev)
    new_vectors = _as_tensor(new_vectors, dev).to(torch.float32)
    km = KMeansBalancedParams(metric=index.metric)
    labels = kmeans_balanced.predict(index.centers, new_vectors, km)
    code_bytes_np = encode_batch(index, new_vectors, labels, res).cpu().numpy()
    labels_np = labels.cpu().numpy()
    if new_indices is None:
        base = index.n_rows
        if index.list_indices is not None:
            base = max(base, int(index.list_indices.max()) + 1)
        if index.overflow_indices.shape[0]:
            base = max(base, int(index.overflow_indices.max()) + 1)
        new_ids = np.arange(base, base + len(code_bytes_np), dtype=np.int32)
    else:
        new_ids = np.asarray(torch.as_tensor(new_indices).cpu(), np.int32)

    if index.list_codes is None:
        data, idxs, sizes, o_codes, o_labels, o_ids = _pack_lists_np(
            code_bytes_np, labels_np, index.n_lists, new_ids,
            index.params.list_pad_expansion)
        data, idxs, sizes, o_codes, o_labels, o_ids = (
            _as_tensor(a, dev)
            for a in (data, idxs, sizes, o_codes, o_labels, o_ids))
        n_rows = len(code_bytes_np)
    else:
        # grow the pad (capped) if needed, then scatter the batch after each
        # list's tail on the device; rows past a hot list's cap spill
        old_sizes = index.list_sizes.cpu().numpy()
        counts = np.bincount(labels_np, minlength=index.n_lists)
        cap = max(list_packing.choose_list_pad(
            old_sizes + counts, index.params.list_pad_expansion),
            index.list_codes.shape[1])
        keep = list_packing.fit_mask(labels_np, index.n_lists, cap,
                                     sizes=old_sizes)
        data, idxs = list_packing.grow_pad(
            index.list_codes, index.list_indices,
            int((old_sizes + np.bincount(labels_np[keep],
                                         minlength=index.n_lists)).max()))
        data, idxs, sizes = list_packing.append_lists(
            data, idxs, index.list_sizes, _as_tensor(code_bytes_np[keep], dev),
            _as_tensor(new_ids[keep], dev),
            _as_tensor(labels_np[keep].astype(np.int64), dev), index.n_lists)
        o_codes, o_labels, o_ids = _merge_pq_overflow(
            index, code_bytes_np[~keep], labels_np[~keep], new_ids[~keep])
        n_rows = index.n_rows + len(code_bytes_np)
    return Index(index.params, index.pq_dim, index.centers, index.rotation,
                 index.codebooks, data, idxs, sizes, n_rows, o_codes,
                 o_labels, o_ids)


def _merge_pq_overflow(index: Index, new_codes_np, new_labels_np,
                       new_ids_np):
    """Append spilled code rows to the overflow block (8-aligned; valid rows
    stay a prefix)."""
    if len(new_codes_np) == 0:
        return (index.overflow_codes, index.overflow_labels,
                index.overflow_indices)
    old_ids = index.overflow_indices.cpu().numpy()
    n_old = int((old_ids >= 0).sum())
    codes = np.concatenate(
        [index.overflow_codes[:n_old].cpu().numpy(), new_codes_np], axis=0)
    labels = np.concatenate([index.overflow_labels[:n_old].cpu().numpy(),
                             np.asarray(new_labels_np, np.int32)])
    ids = np.concatenate([old_ids[:n_old], np.asarray(new_ids_np, np.int32)])
    codes_p, ids_p = list_packing.pad_overflow_block(codes, ids)
    labels_p = np.zeros((len(ids_p),), np.int32)
    labels_p[:len(labels)] = labels
    dev = index.device
    return (_as_tensor(codes_p, dev), _as_tensor(labels_p, dev),
            _as_tensor(ids_p, dev))


# -------------------------------------------------------------------- search


def _pq_overflow_scan(q_rot, overflow_decoded, overflow_norms,
                      overflow_indices, filter_words, metric: DistanceType,
                      bad_fill):
    """Distances of a query tile to the decoded overflow block (full rotated
    vectors), in the space of the probed-list scan: [t, O] distances and
    ids, ready for the final select_k."""
    dots = dot_fp32(q_rot, overflow_decoded)
    if metric == DistanceType.InnerProduct:
        od = dots
    else:
        od = (row_norms_sq(q_rot)[:, None] - 2.0 * dots) \
            + overflow_norms[None, :]
    ok = overflow_indices >= 0
    if filter_words is not None:
        ok = ok & bitset_filter_mask(overflow_indices, filter_words)
    od = torch.where(ok[None, :], od, bad_fill)
    return od, overflow_indices[None, :].expand(q_rot.shape[0], -1)


def _overflow_join(flat_d, flat_i, q_rot, index: Index, filter_words,
                   metric: DistanceType, bad_fill):
    """The unfused engines' overflow step of a query tile: the overflow
    rows' distances and ids appended to the tile's candidates
    (``ivf_pq.search.overflow``)."""
    with tracing.span("ivf_pq.search.overflow"):
        obs_explain.note_overflow_scan("ivf_pq", q_rot.shape[0],
                                       index.overflow_indices.shape[0])
        od, oi = _pq_overflow_scan(q_rot, index.overflow_decoded,
                                   index.overflow_norms,
                                   index.overflow_indices, filter_words,
                                   metric, bad_fill)
        return torch.cat([flat_d, od], dim=1), torch.cat([flat_i, oi], dim=1)


def _coarse(q_rot, centers_rot, n_probes: int, metric: DistanceType,
            select_recall: float):
    """(probes [t, P] int64, dots_c [t, L]): the probed lists of the unfused
    engines, by the rotated queries' coarse scores."""
    dots_c = dot_fp32(q_rot, centers_rot)
    if metric == DistanceType.InnerProduct:
        _, probes = select_k_maybe_approx(dots_c, n_probes, False,
                                          select_recall)
    else:
        coarse = row_norms_sq(centers_rot)[None, :] - 2.0 * dots_c
        _, probes = select_k_maybe_approx(coarse, n_probes, True,
                                          select_recall)
    return probes.long(), dots_c


def _finish(flat_d, flat_i, k: int, metric: DistanceType, select_recall):
    """The final selection of a query tile: top-k over its candidates,
    padded with (bad fill, -1) past the candidate count; sqrt for L2Sqrt."""
    minimize = metric != DistanceType.InnerProduct
    bad_fill = torch.inf if minimize else -torch.inf
    t = flat_d.shape[0]
    kk = min(k, flat_d.shape[1])
    v, sel = select_k_maybe_approx(flat_d, kk, minimize, select_recall)
    i_out = torch.gather(flat_i, 1, sel.long()).to(torch.int32)
    if kk < k:
        v = torch.cat([v, v.new_full((t, k - kk), bad_fill)], dim=1)
        i_out = torch.cat([i_out, i_out.new_full((t, k - kk), -1)], dim=1)
    if metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(torch.clamp_min(v, 0.0))
    return v, i_out


def _scan_distances(q_rot, probes, list_probes, dots_c, centers_rot,
                    list_decoded, decoded_norms, metric: DistanceType):
    """ADC distances [t, P, pad] of a query tile to its probed lists through
    ``gk.ivf_scan`` (partials ‖dec‖² − 2·q·dec): ``probes`` pick the
    centres, ``list_probes`` the lists' rows (the same, but for a tiered
    index's arena slots)."""
    t, n_probes = probes.shape
    pr32 = list_probes.to(torch.int32).contiguous()
    if metric == DistanceType.InnerProduct:
        qv = q_rot[:, None, :].expand(t, n_probes, -1).contiguous()
        part = gk.ivf_scan(pr32, qv, list_decoded, decoded_norms)
        g_n = decoded_norms[list_probes]
        base = torch.gather(dots_c, 1, probes)
        return base[:, :, None] + 0.5 * (g_n - part)
    qr_res = (q_rot[:, None, :] - centers_rot[probes]).contiguous()
    part = gk.ivf_scan(pr32, qr_res, list_decoded, decoded_norms)
    return (qr_res * qr_res).sum(-1)[:, :, None] + part


def _search_cache_core(queries, index: Index, filter_words, k: int,
                       n_probes: int, q_tile: int,
                       select_recall: float = 1.0, use_scan: bool = False):
    """ADC scan over the decoded-residual cache, per query tile: the same
    distances as the LUT engine (‖q_res − dec‖² expanded into ‖q_res‖² −
    2·q_res·dec + ‖dec‖²; q·center + q_rot·dec for inner product). With
    ``use_scan`` the partials ‖dec‖² − 2·q·dec come from ``gk.ivf_scan`` (the
    JAX package's ``use_pallas`` arithmetic), else from a gather of the
    probed slabs and one batched product per tile."""
    metric = index.metric
    list_pad = index.list_decoded.shape[1]
    minimize = metric != DistanceType.InnerProduct
    bad_fill = torch.inf if minimize else -torch.inf
    centers_rot = index.centers_rot
    valid_slot = (torch.arange(list_pad, device=index.device)[None, :]
                  < index.list_sizes[:, None])
    has_overflow = index.overflow_codes.shape[0] > 0
    out_v, out_i = [], []
    for qs in range(0, queries.shape[0], q_tile):
        with tracing.span("ivf_pq.search.coarse"):
            q_rot = dot_fp32(queries[qs:qs + q_tile], index.rotation)
            t = q_rot.shape[0]
            probes, dots_c = _coarse(q_rot, centers_rot, n_probes, metric,
                                     select_recall)
        # the overflow rows join the tile's candidates before its one
        # selection: .overflow runs inside .scan here
        with tracing.span("ivf_pq.search.scan"):
            g_idx = index.list_indices[probes]
            if use_scan:
                d = _scan_distances(q_rot, probes, probes, dots_c,
                                    centers_rot, index.list_decoded,
                                    index.decoded_norms, metric)
            else:
                g_dec = index.list_decoded[probes]  # [t, P, pad, rot]
                if metric == DistanceType.InnerProduct:
                    dots = einsum_fp32("td,tpld->tpl", q_rot, g_dec)
                    d = torch.gather(dots_c, 1, probes)[:, :, None] + dots
                else:
                    # [t, P, rot]
                    qr_res = q_rot[:, None, :] - centers_rot[probes]
                    dots = einsum_fp32("tpd,tpld->tpl", qr_res, g_dec)
                    qn = (qr_res * qr_res).sum(-1)
                    d = (qn[:, :, None] - 2.0 * dots) \
                        + index.decoded_norms[probes]
            ok = valid_slot[probes]
            if filter_words is not None:
                ok = ok & bitset_filter_mask(g_idx, filter_words)
            flat_d = torch.where(ok, d, bad_fill).reshape(
                t, n_probes * list_pad)
            flat_i = g_idx.reshape(t, n_probes * list_pad)
            if has_overflow:
                flat_d, flat_i = _overflow_join(flat_d, flat_i, q_rot, index,
                                                filter_words, metric,
                                                bad_fill)
            v, i = _finish(flat_d, flat_i, k, metric, select_recall)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


def _lut_probe_block(q_rot, dots_c, probes_blk, *, index: Index,
                     filter_words, cb_norms, centers_rot, valid_slot,
                     lut_dtype, dist_dtype):
    """LUT build and code scan of one probe chunk [t, pt] → (distances [t,
    pt, pad], ids [t, pt, pad])."""
    metric = index.metric
    t, pt = probes_blk.shape
    pq_dim, pq_len, book = index.pq_dim, index.pq_len, index.pq_book_size
    list_pad = index.list_codes.shape[1]
    per_cluster = index.params.codebook_kind == CodebookGen.PER_CLUSTER
    if metric == DistanceType.InnerProduct:
        qr_res = q_rot[:, None, :].expand(t, pt, -1)
    else:
        qr_res = q_rot[:, None, :] - centers_rot[probes_blk]
    sub = qr_res.reshape(t, pt, pq_dim, pq_len)
    if per_cluster:
        dots = einsum_fp32("tpsl,tpcl->tpsc", sub,
                           index.codebooks[probes_blk])
        cbn = cb_norms[probes_blk][:, :, None, :]
    else:
        dots = einsum_fp32("tpsl,scl->tpsc", sub, index.codebooks)
        cbn = cb_norms[None, None, :, :]
    if metric == DistanceType.InnerProduct:
        lut = dots  # score = q·center + Σ_s q_sub·cb[code_s]
        base = torch.gather(dots_c, 1, probes_blk)
    else:
        lut = cbn - 2.0 * dots  # ‖q_res − cb‖² − ‖q_res‖², per subspace
        base = (qr_res * qr_res).sum(-1)
    lut_scale = None
    if lut_dtype in _FP8:
        # per-subspace max-abs scaling into the fp8 range
        lut_scale = torch.clamp_min(lut.abs().amax(-1), 1e-30)  # [t, pt, s]
        lut = (lut / lut_scale[..., None]).to(lut_dtype)
    else:
        lut = lut.to(lut_dtype)

    codes = _unpack_codes(index.list_codes[probes_blk], pq_dim,
                          index.pq_bits).to(torch.int64)  # [t, pt, pad, s]
    gidx = (codes + torch.arange(pq_dim, device=codes.device) * book
            ).reshape(t, pt, list_pad * pq_dim)
    flat_lut = lut.reshape(t, pt, pq_dim * book)
    if lut_scale is None:
        contrib = torch.gather(flat_lut.to(dist_dtype), 2, gidx)
    else:
        # fp8 has no gather kernel: gather the bytes
        contrib = torch.gather(flat_lut.view(torch.uint8), 2,
                               gidx).view(lut_dtype)
    contrib = contrib.reshape(t, pt, list_pad, pq_dim)
    if lut_scale is not None:
        contrib = contrib.to(dist_dtype) \
            * lut_scale[:, :, None, :].to(dist_dtype)
    d = contrib.to(dist_dtype).sum(-1).to(torch.float32) + base[:, :, None]
    g_idx = index.list_indices[probes_blk]
    ok = valid_slot[probes_blk]
    if filter_words is not None:
        ok = ok & bitset_filter_mask(g_idx, filter_words)
    bad_fill = torch.inf if metric != DistanceType.InnerProduct else -torch.inf
    return torch.where(ok, d, bad_fill), g_idx


def _search_lut_core(queries, index: Index, filter_words, k: int,
                     n_probes: int, q_tile: int, lut_dtype, dist_dtype,
                     select_recall: float = 1.0, probe_tile: int = 0):
    """LUT engine over the packed codes, per query tile.

    ``probe_tile`` bounds the peak: 0 or >= n_probes scans all probed lists
    of a tile at once ([q_tile, n_probes, list_pad, ...]); otherwise probes
    go ``probe_tile`` at a time with a running top-k carry merged by
    ``select_k``. Distance values equal those of the single pass; only the
    order among equal distances may differ."""
    metric = index.metric
    list_pad = index.list_codes.shape[1]
    minimize = metric != DistanceType.InnerProduct
    bad_fill = torch.inf if minimize else -torch.inf
    p_tile = probe_tile if 0 < probe_tile < n_probes else n_probes
    centers_rot = index.centers_rot
    cb_norms = (index.codebooks.to(torch.float32) ** 2).sum(-1)  # [G, book]
    valid_slot = (torch.arange(list_pad, device=index.device)[None, :]
                  < index.list_sizes[:, None])
    has_overflow = index.overflow_codes.shape[0] > 0
    out_v, out_i = [], []
    for qs in range(0, queries.shape[0], q_tile):
        with tracing.span("ivf_pq.search.coarse"):
            q_rot = dot_fp32(queries[qs:qs + q_tile], index.rotation)
            t = q_rot.shape[0]
            probes, dots_c = _coarse(q_rot, centers_rot, n_probes, metric,
                                     select_recall)
        with tracing.span("ivf_pq.search.scan"):
            block = functools.partial(
                _lut_probe_block, q_rot, dots_c, index=index,
                filter_words=filter_words, cb_norms=cb_norms,
                centers_rot=centers_rot, valid_slot=valid_slot,
                lut_dtype=lut_dtype, dist_dtype=dist_dtype)
            if p_tile == n_probes:
                d, g_idx = block(probes)
                flat_d = d.reshape(t, n_probes * list_pad)
                flat_i = g_idx.reshape(t, n_probes * list_pad)
            else:
                # running top-kk carry: the peak stays [t, p_tile, pad, ...]
                kk = min(k, n_probes * list_pad)
                flat_d = q_rot.new_full((t, kk), bad_fill)
                flat_i = torch.full((t, kk), -1, dtype=torch.int32,
                                    device=q_rot.device)
                for p0 in range(0, n_probes, p_tile):
                    d, gi = block(probes[:, p0:p0 + p_tile])
                    cand_v = torch.cat([flat_d, d.reshape(t, -1)], dim=1)
                    cand_i = torch.cat([flat_i, gi.reshape(t, -1)], dim=1)
                    flat_d, sel = select_k_maybe_approx(
                        cand_v, kk, minimize, select_recall)
                    flat_i = torch.gather(cand_i, 1, sel.long())
            if has_overflow:
                flat_d, flat_i = _overflow_join(flat_d, flat_i, q_rot, index,
                                                filter_words, metric, bad_fill)
            v, i = _finish(flat_d, flat_i, k, metric, select_recall)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


def _coarse_probes_rot(queries, index: Index, n_probes: int):
    """The coarse step of the fused engines: rotate the queries and pick the
    top-n_probes lists in rotated space by the streaming select kernel →
    (q_rot [nq, rot], centers_rot [L, rot], probes [nq, P] int32)."""
    with tracing.span("ivf_pq.search.coarse"):
        q_rot = dot_fp32(queries, index.rotation).contiguous()
        centers_rot = index.centers_rot.contiguous()
        scores = (row_norms_sq(centers_rot)[None, :]
                  - 2.0 * dot_fp32(q_rot, centers_rot))
        algo = SelectAlgo.PALLAS if n_probes <= gk.MAX_K else SelectAlgo.AUTO
        _, probes = select_k(scores, n_probes, select_min=True, algo=algo)
        return q_rot, centers_rot, probes.to(torch.int32).contiguous()


def _fused_merge_overflow(v, i, q_rot, index: Index, k: int):
    """Merge the kernel's survivors with the unfused overflow scan (squared
    space on both sides) by one select_k."""
    od, oi = _pq_overflow_scan(q_rot, index.overflow_decoded,
                               index.overflow_norms, index.overflow_indices,
                               None, DistanceType.L2Expanded, torch.inf)
    return select_k(torch.cat([v, od], dim=1), k, select_min=True,
                    indices=torch.cat([i, oi], dim=1))


def _fused_finish(v, i, q_rot, index: Index, k: int):
    """The overflow rows merged by one select_k, sqrt for L2Sqrt (``index``:
    an Index or a ``tiered.TieredIvfPq``)."""
    n_over = index.overflow_indices.shape[0]
    if n_over > 0:
        with tracing.span("ivf_pq.search.overflow"):
            obs_explain.note_overflow_scan("ivf_pq", q_rot.shape[0], n_over)
            v, i = _fused_merge_overflow(v, i, q_rot, index, k)
    if index.metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(torch.clamp_min(v, 0.0))
    return v, i


def fused_cache_q_chunk(n_probes: int, rot_dim: int,
                        workspace_limit_bytes: int) -> int:
    """Queries per ``fused_ivf_topk`` launch of the cache regime, so that
    the residuals and their norms fit the workspace."""
    per_q = n_probes * (rot_dim * 4 + 4) * 2
    return max(1, workspace_limit_bytes // per_q)


def _search_fused_cache_core(q_rot, centers_rot, probes, list_probes,
                             list_decoded, decoded_norms, ids, index, k: int,
                             q_chunk: int):
    """Fused scan of the decoded cache (L2 metrics): ``fused_ivf_topk`` over
    the probed cache slabs with each query's residual per probe, unclamped
    (ADC distances, as the unfused cache engine), ``q_chunk`` queries per
    launch so that the residuals fit the workspace. ``probes`` pick the
    centres, ``list_probes`` the slabs of ``list_decoded``/``decoded_norms``
    /``ids`` (the same, but for a tiered index's arena slots); ``index``
    (an Index or a ``tiered.TieredIvfPq``) gives the overflow rows."""
    out_v, out_i = [], []
    with tracing.span("ivf_pq.search.scan"):
        for s in range(0, q_rot.shape[0], q_chunk):
            pr = probes[s:s + q_chunk]
            qr_res = (q_rot[s:s + q_chunk, None, :]
                      - centers_rot[pr.long()]).contiguous()  # [t, P, rot]
            qn = (qr_res * qr_res).sum(-1).contiguous()
            v, i = gk.fused_ivf_topk(list_probes[s:s + q_chunk].contiguous(),
                                     qr_res, qn, list_decoded, decoded_norms,
                                     ids, k, clamp=False)
            out_v.append(v)
            out_i.append(i)
        v, i = torch.cat(out_v), torch.cat(out_i)
    return _fused_finish(v, i, q_rot, index, k)


def _search_fused_lut_core(queries, index: Index, k: int, n_probes: int):
    """Fused LUT engine (pq_bits 8, PER_SUBSPACE, float32): each probe's LUT
    is built from the codebooks inside ``fused_pq_topk`` and the packed
    codes are scanned into its top-k carry; neither the LUTs nor the
    candidate slab exist in device memory."""
    q_rot, centers_rot, probes = _coarse_probes_rot(queries, index, n_probes)
    with tracing.span("ivf_pq.search.scan"):
        codebooks = index.codebooks.to(torch.float32).contiguous()
        cb_norms = (codebooks * codebooks).sum(-1).contiguous()
        v, i = gk.fused_pq_topk(probes, q_rot, centers_rot, codebooks,
                                cb_norms, index.list_codes.contiguous(),
                                index.safe_ids(), k)
    return _fused_finish(v, i, q_rot, index, k)


# ------------------------------------------------------------------ planners


def lut_bytes_per_query_probe(list_pad: int, pq_dim: int, pq_bits: int,
                              lut_itemsize: int = 4,
                              dist_itemsize: int = 4) -> int:
    """Peak live bytes of the LUT scan per (query, probe), itemized as in
    the JAX package:

      LUT build   pq_dim·book·(4 + 4 + lut_itemsize)   dots + lut f32 + cast
      code gather list_pad·n_code_bytes                packed u8 rows
      unpack      list_pad·pq_dim·3·4                  lo, hi, word i32
      score       list_pad·pq_dim·(4 + dist_itemsize)  gather idx + contrib
      reduce      list_pad·(4 + 4 + 1)                 d f32, ids i32, valid
    """
    book = 1 << pq_bits
    n_code_bytes = pq_dim * pq_bits // 8
    return (pq_dim * book * (8 + lut_itemsize)
            + list_pad * n_code_bytes
            + list_pad * pq_dim * 12
            + list_pad * pq_dim * (4 + dist_itemsize)
            + list_pad * 9)


def plan_lut_tiles(n_probes: int, list_pad: int, pq_dim: int, pq_bits: int,
                   workspace_limit_bytes: int, lut_itemsize: int = 4,
                   dist_itemsize: int = 4) -> Tuple[int, int]:
    """(q_tile, probe_tile) of the LUT engine from the workspace budget:
    ``q_tile · probe_tile · lut_bytes_per_query_probe`` fits it, all probes
    at once preferred, the probe grid balanced when it is tiled."""
    per_qp = lut_bytes_per_query_probe(list_pad, pq_dim, pq_bits,
                                       lut_itemsize, dist_itemsize)
    q_tile, probe_tile = solve_joint_tiles(workspace_limit_bytes, per_qp,
                                           n_probes, outer_cap=256)
    if 1 < probe_tile < n_probes:
        probe_tile = balanced_tile(n_probes, probe_tile, 1)
    return q_tile, probe_tile


def cache_bytes_per_query(n_probes: int, list_pad: int, rot_dim: int) -> int:
    """Peak live bytes of the decoded-cache scan per query: the gathered
    cache tile, its fp32 upcast, and the fp32 distance/id/mask
    temporaries."""
    return n_probes * list_pad * (rot_dim * 6 + 24)


def plan_cache_tiles(n_probes: int, list_pad: int, rot_dim: int,
                     workspace_limit_bytes: int) -> int:
    """q_tile of the unfused cache engine from the workspace budget."""
    per_q = cache_bytes_per_query(n_probes, list_pad, rot_dim)
    q_tile = int(np.clip(workspace_limit_bytes // max(per_q, 1), 1, 1024))
    if q_tile >= 8:
        q_tile -= q_tile % 8
    return q_tile


def _regime_bytes(n_lists: int, list_pad: int, rot_dim: int,
                  n_code_bytes: int, cache_itemsize: int) -> tuple[int, int]:
    """(packed, cache): the packed codes with their ids, L·pad·(n_code_bytes
    + 4), always resident; the decoded cache with its norms,
    L·pad·(rot_dim·itemsize + 4)."""
    slots = n_lists * list_pad
    return (slots * (n_code_bytes + 4),
            slots * (rot_dim * cache_itemsize + 4))


def scan_memory_bytes(index: Index,
                      cache_dtype=torch.bfloat16) -> tuple[int, int]:
    """(packed, cache) bytes of ``index`` as ``resolve_scan_mode`` counts
    them: a device memory of their sum puts the search in the LUT regime."""
    cache_dtype = _dtype(cache_dtype, _FLOAT_DTYPES, "scan_cache_dtype")
    return _regime_bytes(index.n_lists, index.list_codes.shape[1],
                         index.rot_dim, index.list_codes.shape[2],
                         cache_dtype.itemsize)


def resolve_scan_mode(n_lists: int, list_pad: int, rot_dim: int,
                      n_code_bytes: int, cache_itemsize: int,
                      device_memory_bytes: Optional[int],
                      workspace_limit_bytes: int) -> str:
    """The memory regime of ``scan_mode="auto"``: ``"cache"`` when the
    packed codes (always resident) plus the decoded cache
    (``_regime_bytes``) fit the budget, else ``"lut"``. The budget is half
    the device memory when it is known (the queries, tiles and the rest of
    the program need the other half), else four times the workspace."""
    packed_bytes, cache_bytes = _regime_bytes(n_lists, list_pad, rot_dim,
                                              n_code_bytes, cache_itemsize)
    if device_memory_bytes is not None:
        budget = device_memory_bytes // 2
    else:
        budget = 4 * workspace_limit_bytes
    return "cache" if packed_bytes + cache_bytes <= budget else "lut"


@dataclasses.dataclass
class SearchPlan:
    """The engine a search takes and why.

    ``engine``: ``"pallas_cache"``, ``"pallas_lut"`` (the fused kernels),
    ``"cache"`` or ``"lut"`` (the unfused engines). ``reason``: ``"forced"``
    (scan_mode named the engine, or "pallas"), ``"auto_fused_wins"`` /
    ``"auto_fused"`` ("auto" took the fused engine of its memory regime on
    the card's measured verdict, or on the CPU), ``"fused_loses"`` /
    ``"no_fused_wins_verdict"`` (the card's verdict kept "auto" off it), a
    clause of ``fused_ineligible_reason`` (``"non_l2"``, ``"filtered"``,
    ``"k_gt_1024"``), or ``"lut_params_unsupported"`` (the LUT regime's
    request needs the unfused engine: pq_bits < 8, PER_CLUSTER, a LUT or
    distance dtype other than float32, or a LUT beyond shared memory).
    ``plan`` holds the tiles, the memory regime and ``unfused_ivf_scan``:
    whether the engine scans through the ``ivf_scan`` kernel (the unfused
    cache engine under ``"pallas"``, and under ``"auto"`` where the
    ``ivf_scan`` verdict says it wins)."""

    engine: str
    reason: str
    plan: dict


def plan_search(index: Index, k: int, params: Optional[SearchParams] = None,
                has_filter: bool = False,
                res: Optional[Resources] = None,
                memory_mode: Optional[str] = None) -> SearchPlan:
    """Resolve the engine of ``search(index, queries, k, params, filter)``
    without running it. ``memory_mode`` (``"cache"`` or ``"lut"``) states the
    memory regime instead of ``resolve_scan_mode``'s choice, as a sharded
    index built for one regime does."""
    params = params or SearchParams()
    if memory_mode not in (None, "cache", "lut"):
        raise ValueError(f"unknown memory_mode: {memory_mode!r}")
    if params.scan_mode not in ("auto", "cache", "lut", "pallas"):
        raise ValueError(f"unknown scan_mode: {params.scan_mode!r}")
    res = ensure_resources(res, index.device)
    k = int(k)
    n_probes = int(min(params.n_probes, index.n_lists))
    list_pad = index.list_codes.shape[1]
    requested = params.scan_mode
    fused = requested in ("auto", "pallas")
    if index.lists_decoded_only:
        if memory_mode == "lut" or requested == "lut":
            raise ValueError(
                "index holds no packed codes (its lists came decoded, from "
                "a cache-regime sharded checkpoint); search it in the cache "
                "regime")
        memory_mode = "cache"
    if memory_mode is None:
        memory_mode = resolve_scan_mode(
            index.n_lists, list_pad, index.rot_dim, index.list_codes.shape[2],
            params.scan_cache_dtype.itemsize,
            device_memory_bytes=res.device_memory_bytes,
            workspace_limit_bytes=res.workspace_limit_bytes)
    ineligible = fused_ineligible_reason(index.metric, index.list_codes.dtype,
                                         k, has_filter, False,
                                         require_float=False)
    use_fused, dreason = False, "forced"
    if fused and ineligible is None:
        use_fused, dreason = gk.fused_dispatch_explained("ivf_pq", requested,
                                                         index.device)
    lut_unsupported = False
    if use_fused:
        if memory_mode == "cache":
            return SearchPlan("pallas_cache", dreason,
                              {"memory_model": "cache",
                               "unfused_ivf_scan": False})
        if (index.params.codebook_kind == CodebookGen.PER_SUBSPACE
                and index.pq_bits == 8
                and params.lut_dtype == torch.float32
                and params.internal_distance_dtype == torch.float32
                and gk.fused_pq_fits(index.pq_dim, index.pq_len, k)):
            return SearchPlan("pallas_lut", dreason,
                              {"memory_model": "lut",
                               "unfused_ivf_scan": False})
        lut_unsupported = True
    mode = memory_mode if fused else requested
    if not fused:
        reason = "forced"
    elif ineligible is not None:
        reason = ineligible
    elif lut_unsupported:
        reason = "lut_params_unsupported"
    else:
        reason = dreason  # the measured verdict kept auto off the kernel
    if mode == "cache":
        q_tile = plan_cache_tiles(n_probes, list_pad, index.rot_dim,
                                  res.workspace_limit_bytes)
        return SearchPlan("cache", reason, {
            "memory_model": "cache", "memory_auto": fused, "q_tile": q_tile,
            "unfused_ivf_scan": ivf_scan_routed(requested, index.device),
            "predicted_workspace_bytes": q_tile * cache_bytes_per_query(
                n_probes, list_pad, index.rot_dim)})
    lut_b = params.lut_dtype.itemsize
    dist_b = params.internal_distance_dtype.itemsize
    q_tile, probe_tile = plan_lut_tiles(n_probes, list_pad, index.pq_dim,
                                        index.pq_bits,
                                        res.workspace_limit_bytes, lut_b,
                                        dist_b)
    return SearchPlan("lut", reason, {
        "memory_model": "lut", "memory_auto": fused, "q_tile": q_tile,
        "unfused_ivf_scan": False,
        "probe_tile": probe_tile,
        "predicted_workspace_bytes": q_tile * probe_tile
        * lut_bytes_per_query_probe(list_pad, index.pq_dim, index.pq_bits,
                                    lut_b, dist_b)})


@tracing.range("ivf_pq.search")
def search(index: Index, queries, k: int,
           params: Optional[SearchParams] = None,
           filter: Optional[Bitset] = None,
           res: Optional[Resources] = None, explain: bool = False,
           memory_mode: Optional[str] = None):
    """Search → ``(distances [nq, k] f32, ids [nq, k] i32)``: ADC distances
    (squared for L2Expanded, square-rooted for L2SqrtExpanded, scores for
    InnerProduct), source row ids, -1 where fewer than k candidates were
    probed. Runs on the index's device; ``plan_search`` says which engine
    it takes. ``memory_mode`` (``"cache"`` or ``"lut"``) states the memory
    regime, as a sharded index built for one regime does. ``explain=True``
    returns a third element, the search's ``ExplainRecord`` (the engine
    and reason of ``plan_search``).

    Spans inside ``ivf_pq.search``: ``.plan`` (checks, ``plan_search``, the
    explain record), ``.wait`` (inside ``.plan``, where staging host
    queries or a host filter onto the card blocks the host), ``.coarse``
    (the rotation, the coarse product and the probes' selection),
    ``.scan`` and ``.overflow``."""
    with contextlib.ExitStack() as stack:
        cap = stack.enter_context(obs_explain.capture()) if explain else None
        with tracing.span("ivf_pq.search.plan"):
            params = params or SearchParams()
            if index.list_codes is None:
                raise ValueError("index has no data; call extend() first")
            res = ensure_resources(res, index.device)
            with host_wait("ivf_pq", "queries", queries, index.device):
                queries = as_query_array(queries, index.device, torch.float32)
            if queries.shape[1] != index.dim:
                raise ValueError(
                    f"query dim {queries.shape[1]} != index dim {index.dim}")
            words = None
            if filter is not None:
                with host_wait("ivf_pq", "filter", filter.words,
                               index.device):
                    words = filter.words.to(index.device)
            k = int(k)
            plan = plan_search(index, k, params, filter is not None, res,
                               memory_mode=memory_mode)
            n_probes = int(min(params.n_probes, index.n_lists))
            nq = queries.shape[0]
            ex_params = {"k": k, "nq": nq, "bucket": query_bucket(nq),
                         "n_probes": n_probes, "n_lists": index.n_lists,
                         "list_pad": index.list_codes.shape[1],
                         "pq_dim": index.pq_dim, "pq_bits": index.pq_bits,
                         "metric": index.metric.name}
            ex_plan = dict(plan.plan)
            kernel = {"pallas_cache": "fused_ivf_topk",
                      "pallas_lut": "fused_pq_topk",
                      "cache": ("ivf_scan" if plan.plan["unfused_ivf_scan"]
                                else None),
                      "lut": None}[plan.engine]
            if kernel is not None:
                ex_plan.update(kernel_plan(index.device, kernel))
            obs_explain.record_dispatch("ivf_pq", params.scan_mode,
                                        plan.engine, plan.reason,
                                        params=ex_params, plan=ex_plan)
        out = _search_engine(queries, index, words, k, n_probes, params,
                             plan, res)
    return explained(out, cap, explain)


def _search_engine(queries, index: Index, words: Optional[torch.Tensor],
                   k: int, n_probes: int, params: SearchParams,
                   plan: SearchPlan, res: Resources):
    """Run the engine ``plan`` resolved (``words``: the filter's bitset
    words on the index's device, or None)."""
    if index.overflow_codes.shape[0] > 0:
        ensure_overflow_decoded(index, params.scan_cache_dtype)
    if plan.engine == "pallas_cache":
        ensure_scan_cache(index, params.scan_cache_dtype)
        q_rot, centers_rot, probes = _coarse_probes_rot(queries, index,
                                                        n_probes)
        return _search_fused_cache_core(
            q_rot, centers_rot, probes, probes, index.list_decoded,
            index.decoded_norms, index.safe_ids(), index, k,
            fused_cache_q_chunk(n_probes, index.rot_dim,
                                res.workspace_limit_bytes))
    if plan.engine == "pallas_lut":
        return _search_fused_lut_core(queries, index, k, n_probes)
    if plan.engine == "cache":
        ensure_scan_cache(index, params.scan_cache_dtype)
        return _search_cache_core(queries, index, words, k, n_probes,
                                  plan.plan["q_tile"],
                                  float(params.select_recall),
                                  plan.plan["unfused_ivf_scan"])
    return _search_lut_core(queries, index, words, k, n_probes,
                            plan.plan["q_tile"], params.lut_dtype,
                            params.internal_distance_dtype,
                            float(params.select_recall),
                            plan.plan["probe_tile"])


_SERIAL_VERSION = 2  # v2: + list_pad_expansion, overflow block


def serialize(index: Index, file) -> None:
    """Write the index to a path (atomically) or a binary stream, in the
    JAX package's format (v2, crc-framed records): the build parameters,
    centers, rotation, codebooks, the packed list codes with their ids and
    sizes, and the overflow block's codes, coarse lists and ids. The
    decoded scan cache is not written: a restored index decodes it again
    when a search in the cache regime needs it."""
    if index.list_codes is None:
        raise ValueError("index has no data; call extend() before serialize()")
    if index.overflow_decoded_only or index.lists_decoded_only:
        raise ValueError("this index came decoded without its codes, so it "
                         "cannot be written in the single-index format")
    with ser.writer_for(file) as stream:
        w = ser.IndexWriter(stream, "ivf_pq", _SERIAL_VERSION)
        w.scalar(int(index.metric), "<i4")
        w.scalar(index.params.n_lists, "<i8")
        w.scalar(index.params.kmeans_n_iters, "<i4")
        w.scalar(index.params.kmeans_trainset_fraction, "<f8")
        w.scalar(index.params.pq_bits, "<i4")
        w.scalar(index.pq_dim, "<i4")
        w.scalar(int(index.params.codebook_kind), "<i4")
        w.scalar(1 if index.params.force_random_rotation else 0, "<i4")
        w.scalar(index.params.list_pad_expansion, "<f8")
        w.scalar(index.n_rows, "<i8")
        for a in (index.centers, index.rotation, index.codebooks,
                  index.list_codes, index.list_indices, index.list_sizes,
                  index.overflow_codes, index.overflow_labels,
                  index.overflow_indices):
            w.array(a)
        w.finish()


def deserialize(file, res: Optional[Resources] = None, device=None) -> Index:
    """Read an index written by :func:`serialize` or the JAX package (v1 or
    v2) onto ``res``'s device (CUDA unless the caller asks for the CPU);
    either memory regime can search it."""
    res = ensure_resources(res, device)
    dev = res.device
    with ser.reader_for(file) as stream:
        r = ser.IndexReader(stream, "ivf_pq", _SERIAL_VERSION)
        metric = DistanceType(r.scalar())
        n_lists = r.scalar()
        kmeans_n_iters = r.scalar()
        frac = r.scalar()
        pq_bits = r.scalar()
        pq_dim = r.scalar()
        kind = CodebookGen(r.scalar())
        force_rot = bool(r.scalar())
        # v1 files predate the capped pad: max-driven layout, no spill
        expansion = r.scalar() if r.version >= 2 else 1e30
        params = IndexParams(
            n_lists=n_lists, metric=metric, kmeans_n_iters=kmeans_n_iters,
            kmeans_trainset_fraction=frac, pq_bits=pq_bits, pq_dim=pq_dim,
            codebook_kind=kind, force_random_rotation=force_rot,
            list_pad_expansion=expansion)
        n_rows = r.scalar()
        arrays = [ser.to_tensor(r.array(), dev) for _ in range(6)]
        over = ([ser.to_tensor(r.array(), dev) for _ in range(3)]
                if r.version >= 2 else [None] * 3)
        r.finish()
    return Index(params, pq_dim, *arrays, n_rows, *over)


class helpers:
    """One list's codes (the JAX package's ``ivf_pq.helpers``): unpacked
    and packed again, and the rows they approximate. Results are host
    arrays; ``pack_list_codes`` returns a new index on the old one's
    device."""

    @staticmethod
    def unpack_list_codes(index: Index, label: int) -> np.ndarray:
        """The codes of list ``label``'s rows, [size, pq_dim] uint8."""
        size = int(index.list_sizes[label])
        return _unpack_codes(index.list_codes[label, :size], index.pq_dim,
                             index.pq_bits).to(torch.uint8).cpu().numpy()

    @staticmethod
    def pack_list_codes(index: Index, label: int, codes,
                        ids=None) -> Index:
        """A new index whose list ``label`` holds the unpacked ``codes``
        [n, pq_dim] and ``ids`` (kept from the old list where None), with
        the slots after them cleared (codes 0, ids -1); the overflow block
        is kept."""
        packed = _pack_codes_np(np.asarray(codes, np.uint8), index.pq_bits)
        pad = index.list_codes.shape[1]
        if len(packed) > pad:
            raise ValueError(f"{len(packed)} codes exceed list capacity {pad}")
        dev = index.device
        data = index.list_codes.clone()
        idxs = index.list_indices.clone()
        sizes = index.list_sizes.clone()
        data[label, :len(packed)] = torch.from_numpy(packed).to(dev)
        data[label, len(packed):] = 0
        if ids is not None:
            idxs[label, :len(packed)] = torch.as_tensor(
                np.asarray(ids, np.int32)).to(dev)
        idxs[label, len(packed):] = -1
        old = int(sizes[label])
        sizes[label] = len(packed)
        return Index(index.params, index.pq_dim, index.centers,
                     index.rotation, index.codebooks, data, idxs, sizes,
                     index.n_rows - old + len(packed), index.overflow_codes,
                     index.overflow_labels, index.overflow_indices)

    @staticmethod
    def reconstruct_list_data(index: Index, label: int) -> np.ndarray:
        """The rows list ``label``'s codes approximate, [size, dim] fp32:
        the center plus the decoded residual rotated back."""
        codes = torch.from_numpy(
            helpers.unpack_list_codes(index, label)).long()
        cbs = index.codebooks.cpu()
        if index.params.codebook_kind == CodebookGen.PER_CLUSTER:
            dec = cbs[label][codes.reshape(-1)]
        else:
            flat = cbs.reshape(index.pq_dim * index.pq_book_size,
                               index.pq_len)
            offs = codes + torch.arange(index.pq_dim)[None, :] \
                * index.pq_book_size
            dec = flat[offs.reshape(-1)]
        dec = dec.reshape(len(codes), index.rot_dim)
        center = index.centers[label].cpu()
        return (center[None, :] + dec @ index.rotation.cpu()).numpy()
