"""Out-of-core (streamed) index builds from on-disk fbin datasets.

Counterpart of ``raft_tpu.neighbors.ooc``: a dataset larger than host or
device memory is built in two passes over the file, read through the
native IO layer (``native.read_bin``, ``iter_bin_batches_prefetch``):

1. **Train** on a strided row sample (the full dataset never in memory).
2. **Pass A** streams batches through the coarse quantizer on the device
   (``kmeans_balanced.predict``: a matrix product and argmin) for the
   labels; the list sizes are counted on the host. **Pass B** allocates the
   padded list storage once and scatters each batch into place (encoding
   it on the device for IVF-PQ), so no repeated ``extend`` repacks it.

``row_range=(lo, hi)`` builds over that span only, with file-absolute row
ids. The index lands on ``res``'s device (CUDA unless asked for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.neighbors import list_packing

__all__ = ["build_ivf_flat_from_file", "build_ivf_pq_from_file",
           "sample_rows_from_file"]


def sample_rows_from_file(path: str, n_sample: int, seed: int = 0,
                          dtype=None, batch_rows: int = 1 << 18,
                          row_range=None) -> np.ndarray:
    """An evenly spread row sample without loading the file: contiguous
    chunks are read and a seeded subset of each kept (the same rows as the
    JAX package's for the same seed)."""
    total, dim = native.read_bin_header(path)
    lo, hi = (0, total) if row_range is None else row_range
    lo, hi = int(lo), int(min(hi, total))
    n = hi - lo
    n_sample = min(int(n_sample), n)
    out = []
    taken = 0
    rng = np.random.default_rng(seed)
    for start in range(lo, hi, batch_rows):
        rows = min(batch_rows, hi - start)
        want = int(round(n_sample * (start + rows - lo) / n)) - taken
        if want <= 0:
            continue
        batch = native.read_bin(path, start, rows, dtype=dtype)
        if want >= rows:
            sel = batch
        else:
            pick = rng.choice(rows, size=want, replace=False)
            pick.sort()
            sel = batch[pick]
        out.append(np.ascontiguousarray(sel))
        taken += len(sel)
    return np.concatenate(out, axis=0)


def _labels_pass(path: str, centers: torch.Tensor, metric, batch_rows: int,
                 dtype, row_range=None) -> np.ndarray:
    """Pass A: every row's coarse list, batch by batch on the centres'
    device → labels [hi - lo] (offsets local to the range)."""
    total, _ = native.read_bin_header(path)
    lo, hi = (0, total) if row_range is None else row_range
    km = KMeansBalancedParams(metric=metric)
    labels = np.empty(int(hi) - int(lo), np.int32)
    for start, batch in native.iter_bin_batches_prefetch(
            path, batch_rows, dtype, row_range=row_range):
        s = start - int(lo)
        x = torch.from_numpy(batch).to(centers.device).to(torch.float32)
        lb = kmeans_balanced.predict(centers, x, km)
        labels[s:s + len(batch)] = lb.cpu().numpy().astype(np.int32)
    return labels


def _scatter_positions(lb: np.ndarray, offsets: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Slot of every batch row from the running per-list offsets; returns
    (positions, the batch's counts per list)."""
    order = np.argsort(lb, kind="stable")
    sorted_lb = lb[order]
    cc = np.arange(len(lb), dtype=np.int64)
    if len(lb):
        starts = np.r_[0, np.flatnonzero(np.diff(sorted_lb)) + 1]
        group_len = np.diff(np.r_[starts, len(lb)])
        cc -= np.repeat(cc[starts], group_len)
    pos = np.empty(len(lb), np.int64)
    pos[order] = offsets[sorted_lb] + cc
    return pos, np.bincount(lb, minlength=len(offsets))


def _gather_overflow(chunks, id_chunks, empty_shape, dtype):
    """Spilled rows in one 8-aligned overflow block."""
    if not chunks:
        return np.zeros(empty_shape, dtype), np.zeros((0,), np.int32)
    return list_packing.pad_overflow_block(np.concatenate(chunks, axis=0),
                                           np.concatenate(id_chunks))


def build_ivf_flat_from_file(path: str, params=None,
                             res: Optional[Resources] = None,
                             batch_rows: int = 1 << 18, dtype=None,
                             max_train_rows: Optional[int] = None,
                             row_range=None, device=None):
    """Streamed IVF-Flat build from an fbin file → ``ivf_flat.Index``: the
    file read twice (labels, then fill) in ``batch_rows`` chunks; the host
    holds the padded lists and one batch."""
    from raft_tpu_torch.neighbors import ivf_flat

    params = params or ivf_flat.IndexParams()
    res = ensure_resources(res, device)
    dev = res.device
    total, dim = native.read_bin_header(path)
    lo, hi = (0, total) if row_range is None else row_range
    lo, hi = int(lo), int(min(hi, total))
    n = hi - lo
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > n_rows={n}")

    n_train = max(int(n * params.kmeans_trainset_fraction), params.n_lists)
    if max_train_rows is not None:
        n_train = min(n_train, int(max_train_rows))
    trainset = sample_rows_from_file(path, n_train, seed=0, dtype=dtype,
                                     batch_rows=batch_rows,
                                     row_range=(lo, hi))
    km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                              metric=params.metric)
    centers = kmeans_balanced.fit(
        res.generator, torch.from_numpy(trainset).to(dev).to(torch.float32),
        params.n_lists, km)
    del trainset

    labels = _labels_pass(path, centers, params.metric, batch_rows, dtype,
                          row_range=(lo, hi))
    sizes = np.bincount(labels, minlength=params.n_lists).astype(np.int32)
    pad = list_packing.choose_list_pad(sizes, params.list_pad_expansion)

    first = native.read_bin(path, 0, 1, dtype=dtype)
    data = np.zeros((params.n_lists, pad, dim), first.dtype)
    idxs = np.full((params.n_lists, pad), -1, np.int32)
    offsets = np.zeros(params.n_lists, np.int64)
    over_rows, over_ids = [], []
    for start, batch in native.iter_bin_batches_prefetch(
            path, batch_rows, dtype, row_range=(lo, hi)):
        rows = len(batch)
        lb = labels[start - lo:start - lo + rows]
        row_ids = np.arange(start, start + rows, dtype=np.int32)
        pos, cnt = _scatter_positions(lb, offsets)
        fits = pos < pad  # rows past a hot list's cap spill to overflow
        data[lb[fits], pos[fits]] = batch[fits]
        idxs[lb[fits], pos[fits]] = row_ids[fits]
        if not fits.all():
            over_rows.append(np.ascontiguousarray(batch[~fits]))
            over_ids.append(row_ids[~fits])
        offsets += cnt

    o_rows, o_ids = _gather_overflow(over_rows, over_ids, (0, dim),
                                     first.dtype)
    return ivf_flat.Index(
        params, centers, torch.from_numpy(data).to(dev),
        torch.from_numpy(idxs).to(dev),
        torch.from_numpy(np.minimum(sizes, pad)).to(dev), n,
        torch.from_numpy(o_rows).to(dev), torch.from_numpy(o_ids).to(dev))


def build_ivf_pq_from_file(path: str, params=None,
                           res: Optional[Resources] = None,
                           batch_rows: int = 1 << 18, dtype=None,
                           max_train_rows: Optional[int] = None,
                           row_range=None, trained_index=None, device=None):
    """Streamed IVF-PQ build from an fbin file → ``ivf_pq.Index``: centres,
    rotation and codebooks trained by ``ivf_pq.build`` on a row sample, then
    every batch encoded on the device into the packed-code storage.
    ``trained_index`` (a dataless index with centres, rotation and
    codebooks) skips the training."""
    from raft_tpu_torch.neighbors import ivf_pq

    params = params or ivf_pq.IndexParams()
    res = ensure_resources(res, device)
    dev = res.device
    total, dim = native.read_bin_header(path)
    lo, hi = (0, total) if row_range is None else row_range
    lo, hi = int(lo), int(min(hi, total))
    n = hi - lo
    if trained_index is not None:
        if trained_index.n_lists != params.n_lists:
            raise ValueError(
                f"trained_index has n_lists={trained_index.n_lists}, "
                f"params ask for {params.n_lists}")
        index = trained_index
    else:
        if params.n_lists > n:
            raise ValueError(f"n_lists={params.n_lists} > n_rows={n}")
        n_train = max(int(n * params.kmeans_trainset_fraction),
                      params.n_lists)
        if max_train_rows is not None:
            n_train = min(n_train, int(max_train_rows))
        trainset = sample_rows_from_file(path, n_train, seed=0, dtype=dtype,
                                         batch_rows=batch_rows,
                                         row_range=(lo, hi))
        train_params = dataclasses.replace(params,
                                           kmeans_trainset_fraction=1.0,
                                           add_data_on_build=False)
        index = ivf_pq.build(np.asarray(trainset, np.float32), train_params,
                             res=res)
        del trainset

    labels = _labels_pass(path, index.centers, params.metric, batch_rows,
                          dtype, row_range=(lo, hi))
    sizes = np.bincount(labels, minlength=params.n_lists).astype(np.int32)
    pad = list_packing.choose_list_pad(sizes, params.list_pad_expansion)
    packed_width = index.pq_dim * index.pq_bits // 8

    codes = np.zeros((params.n_lists, pad, packed_width), np.uint8)
    idxs = np.full((params.n_lists, pad), -1, np.int32)
    offsets = np.zeros(params.n_lists, np.int64)
    over_codes, over_labels, over_ids = [], [], []
    for start, batch in native.iter_bin_batches_prefetch(
            path, batch_rows, dtype, row_range=(lo, hi)):
        rows = len(batch)
        lb = labels[start - lo:start - lo + rows]
        packed = ivf_pq.encode_batch(index, batch, lb, res).cpu().numpy()
        row_ids = np.arange(start, start + rows, dtype=np.int32)
        pos, cnt = _scatter_positions(lb, offsets)
        fits = pos < pad
        codes[lb[fits], pos[fits]] = packed[fits]
        idxs[lb[fits], pos[fits]] = row_ids[fits]
        if not fits.all():
            over_codes.append(np.ascontiguousarray(packed[~fits]))
            over_labels.append(lb[~fits])
            over_ids.append(row_ids[~fits])
        offsets += cnt

    o_codes, o_ids = _gather_overflow(over_codes, over_ids,
                                      (0, packed_width), np.uint8)
    o_labels = np.zeros((len(o_ids),), np.int32)
    if over_labels:
        lab = np.concatenate(over_labels)
        o_labels[:len(lab)] = lab

    def t(a):
        return torch.from_numpy(a).to(dev)

    return ivf_pq.Index(params, index.pq_dim, index.centers, index.rotation,
                        index.codebooks, t(codes), t(idxs),
                        t(np.minimum(sizes, pad).astype(np.int32)), n,
                        t(o_codes), t(o_labels), t(o_ids))
