"""Carry the JAX package's index contents over to the port.

The functions take what a raft_tpu index holds, as numpy arrays, and
return the port's index on ``device`` (a sharded index: on the ranks of a
communicator), so that one build can be searched by both packages on
identical state."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device
from raft_tpu_torch.neighbors import (ball_cover, brute_force, cagra,
                                      ivf_flat, ivf_pq)
from raft_tpu_torch.ops.distance import resolve_metric
from raft_tpu_torch.parallel import sharded
from raft_tpu_torch.parallel.comms import Comms
from raft_tpu_torch.sparse.types import (COO, CSR, coo_from_arrays,
                                         csr_from_scipy_like)


def _t(a, device) -> torch.Tensor:
    """A device tensor from a host array (copied, so read-only views are
    fine); bfloat16 arrays travel as their int16 bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def brute_force_index_from_numpy(dataset, metric, norms=None,
                                 metric_arg: float = 2.0,
                                 device=None) -> brute_force.Index:
    """A brute-force index over ``dataset`` [n, dim] with the given cached
    squared norms [n] (None for inner product)."""
    dev = resolve_device(device)
    return brute_force.Index(_t(dataset, dev), resolve_metric(metric),
                             float(metric_arg),
                             None if norms is None else _t(norms, dev))


def ivf_flat_index_from_numpy(params: ivf_flat.IndexParams, centers,
                              list_data, list_indices, list_sizes,
                              n_rows: int, overflow_data, overflow_indices,
                              device=None) -> ivf_flat.Index:
    """An IVF-Flat index from centers [L, dim], list_data [L, pad, dim],
    list_indices [L, pad] (-1 padded), list_sizes [L] and the overflow block
    ([O, dim], [O])."""
    dev = resolve_device(device)
    return ivf_flat.Index(
        params, _t(np.asarray(centers, np.float32), dev), _t(list_data, dev),
        _t(np.asarray(list_indices, np.int32), dev),
        _t(np.asarray(list_sizes, np.int32), dev), int(n_rows),
        _t(overflow_data, dev), _t(np.asarray(overflow_indices, np.int32), dev))


def ivf_pq_index_from_numpy(params: ivf_pq.IndexParams, pq_dim: int, centers,
                            rotation, codebooks, list_codes, list_indices,
                            list_sizes, n_rows: int, overflow_codes,
                            overflow_labels, overflow_indices,
                            device=None) -> ivf_pq.Index:
    """An IVF-PQ index from centers [L, dim], rotation [rot_dim, dim],
    codebooks ([pq_dim, book, pq_len] or [L, book, pq_len]), packed
    list_codes [L, pad, n_code_bytes] uint8, list_indices [L, pad] (-1
    padded), list_sizes [L] and the overflow block (codes [O, n_code_bytes],
    coarse labels [O], ids [O])."""
    dev = resolve_device(device)

    def f32(a):
        return _t(np.asarray(a, np.float32), dev)

    def i32(a):
        return _t(np.asarray(a, np.int32), dev)

    def u8(a):
        return _t(np.asarray(a, np.uint8), dev)

    return ivf_pq.Index(
        params, int(pq_dim), f32(centers), f32(rotation), f32(codebooks),
        u8(list_codes), i32(list_indices), i32(list_sizes), int(n_rows),
        u8(overflow_codes), i32(overflow_labels), i32(overflow_indices))


def cagra_index_from_numpy(params: cagra.IndexParams, dataset, graph,
                           device=None) -> cagra.Index:
    """A CAGRA index from dataset [n, dim] and graph [n, graph_degree]
    (int32, -1 for an invalid edge)."""
    dev = resolve_device(device)
    return cagra.Index(params, _t(dataset, dev),
                       _t(np.asarray(graph, np.int32), dev))


def ball_cover_index_from_numpy(landmarks, list_data, list_indices,
                                list_sizes, radii, metric, n_rows: int,
                                device=None) -> ball_cover.BallCoverIndex:
    """A random ball cover index from landmarks [L, dim], list_data [L, pad,
    dim], list_indices [L, pad], list_sizes [L] and radii [L]."""
    dev = resolve_device(device)
    return ball_cover.BallCoverIndex(
        _t(landmarks, dev), _t(list_data, dev),
        _t(np.asarray(list_indices, np.int32), dev),
        _t(np.asarray(list_sizes, np.int32), dev),
        _t(np.asarray(radii, np.float32), dev), resolve_metric(metric),
        int(n_rows))


def csr_from_numpy(indptr, indices, data, shape, device=None) -> CSR:
    """A CSR from a JAX ``CSR``'s arrays (indptr, indices, data, shape)."""
    dev = resolve_device(device)
    return csr_from_scipy_like(_t(indptr, dev), _t(indices, dev),
                               _t(data, dev), shape)


def coo_from_numpy(rows, cols, data, shape, device=None) -> COO:
    """A COO from a JAX ``COO``'s arrays (rows, cols, data, shape)."""
    dev = resolve_device(device)
    return coo_from_arrays(_t(rows, dev), _t(cols, dev), _t(data, dev), shape)


def _rank_rows(bounds) -> np.ndarray:
    return np.diff(np.asarray(bounds, np.int64))


def sharded_ivf_flat_from_numpy(comms: Comms, params: ivf_flat.IndexParams,
                                centers, list_data, list_indices, list_sizes,
                                bounds, overflow_data=None,
                                overflow_indices=None
                                ) -> sharded.ShardedIvfFlat:
    """A sharded IVF-Flat index from a JAX ``ShardedIvfFlat``'s stacked
    arrays: centers [S, L, dim], list_data [S, L, pad, dim], list_indices
    [S, L, pad] (global ids, -1 padded), list_sizes [S, L], the row offsets
    ``bounds`` [S+1] and the overflow blocks ([S, O, dim], [S, O], -1
    padded) or None. Rank r's index lands on ``comms.devices[r]``."""
    rows = _rank_rows(bounds)
    list_data = np.asarray(list_data)
    indexes = []
    for r, dev in enumerate(comms.devices):
        if overflow_data is None:
            over_d = np.zeros((0, list_data.shape[-1]), list_data.dtype)
            over_i = np.zeros((0,), np.int32)
        else:
            over_d, over_i = overflow_data[r], overflow_indices[r]
        indexes.append(ivf_flat_index_from_numpy(
            params, centers[r], list_data[r], list_indices[r], list_sizes[r],
            int(rows[r]), over_d, over_i, device=dev))
    return sharded.ShardedIvfFlat(comms, indexes, params.metric,
                                  int(rows.sum()), bounds)


def sharded_ivf_pq_from_numpy(comms: Comms, params: ivf_pq.IndexParams,
                              pq_dim: int, centers, rotation, codebooks,
                              list_codes, list_indices, list_sizes, bounds,
                              scan_mode: str = "lut", list_decoded=None,
                              decoded_norms=None, overflow_decoded=None,
                              overflow_norms=None, overflow_indices=None
                              ) -> sharded.ShardedIvfPq:
    """A sharded IVF-PQ index from a JAX ``ShardedIvfPq``'s stacked arrays:
    centers [S, L, dim], rotation [S, rot, dim], codebooks and packed
    list_codes [S, L, pad, n_code_bytes] (from a ``scan_mode="lut"`` build),
    list_indices [S, L, pad] (global ids), list_sizes [S, L], the row
    offsets ``bounds`` [S+1]; with ``scan_mode="cache"`` also the decoded
    cache (list_decoded [S, L, pad, rot], decoded_norms [S, L, pad]). The
    JAX index keeps its overflow rows decoded only ([S, O, rot], [S, O],
    ids [S, O]): each rank's index takes them as its decoded overflow block
    and is marked ``overflow_decoded_only`` (``ivf_pq.index_from_parts``),
    so a search with another ``scan_cache_dtype`` than the one they were
    decoded in raises, and so does ``extend``."""
    rows = _rank_rows(bounds)
    indexes = []
    for r, dev in enumerate(comms.devices):
        def t(a, dtype=None):
            return None if a is None else _t(
                a[r] if dtype is None else np.asarray(a[r], dtype), dev)

        has_over = overflow_indices is not None and len(overflow_indices[r])
        over = (dict(overflow_decoded=t(overflow_decoded),
                     overflow_norms=t(overflow_norms, np.float32),
                     overflow_indices=t(overflow_indices, np.int32))
                if has_over else {})
        indexes.append(ivf_pq.index_from_parts(
            params, int(pq_dim), t(centers, np.float32),
            t(rotation, np.float32), t(list_indices, np.int32),
            t(list_sizes, np.int32), int(rows[r]),
            codebooks=t(codebooks, np.float32),
            list_codes=t(list_codes, np.uint8),
            list_decoded=t(list_decoded),
            decoded_norms=t(decoded_norms, np.float32), **over))
    return sharded.ShardedIvfPq(comms, indexes, params.metric,
                                int(rows.sum()), bounds, scan_mode)


def sharded_cagra_from_numpy(comms: Comms, params: cagra.IndexParams,
                             datasets, graphs, bounds, n_rows: int
                             ) -> sharded.ShardedCagra:
    """A sharded CAGRA index from a JAX ``ShardedCagra``'s stacked arrays:
    datasets [S, shard_pad, dim] and graphs [S, shard_pad, degree] (local
    ids), padded to the largest rank, and the row offsets ``bounds`` [S+1].
    Each rank is cut to its own rows (the padding rows are never seeded
    nor linked) and lands on ``comms.devices[r]``."""
    rows = _rank_rows(bounds)
    datasets, graphs = np.asarray(datasets), np.asarray(graphs)
    indexes = [cagra_index_from_numpy(params, datasets[r, :rows[r]],
                                      graphs[r, :rows[r]], device=dev)
               for r, dev in enumerate(comms.devices)]
    return sharded.ShardedCagra(comms, indexes, params.metric, int(n_rows),
                                bounds)
