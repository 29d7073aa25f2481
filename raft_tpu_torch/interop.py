"""Carry the JAX package's index contents over to the port.

The functions take what a raft_tpu index holds, as numpy arrays, and
return the port's index on ``device`` (a sharded index: on the ranks of a
communicator), so that one build can be searched by both packages on
identical state."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.ops.distance import resolve_metric
from raft_tpu_torch.parallel import sharded
from raft_tpu_torch.parallel.comms import Comms


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
    and is marked ``overflow_decoded_only`` (its overflow codes are zero
    placeholders), so a search with another ``scan_cache_dtype`` than the
    one they were decoded in raises, and so does ``extend``."""
    rows = _rank_rows(bounds)
    n_bytes = np.asarray(list_codes).shape[-1]
    indexes = []
    for r, dev in enumerate(comms.devices):
        n_over = 0 if overflow_indices is None else len(overflow_indices[r])
        idx = ivf_pq_index_from_numpy(
            params, pq_dim, centers[r], rotation[r], codebooks[r],
            list_codes[r], list_indices[r], list_sizes[r], int(rows[r]),
            np.zeros((n_over, n_bytes), np.uint8),
            np.zeros((n_over,), np.int32),
            np.zeros((0,), np.int32) if n_over == 0 else overflow_indices[r],
            device=dev)
        if n_over:
            idx.overflow_decoded = _t(overflow_decoded[r], dev)
            idx.overflow_norms = _t(np.asarray(overflow_norms[r], np.float32),
                                    dev)
            idx.overflow_decoded_only = True
        if list_decoded is not None:
            idx.list_decoded = _t(list_decoded[r], dev)
            idx.decoded_norms = _t(np.asarray(decoded_norms[r], np.float32),
                                   dev)
        indexes.append(idx)
    return sharded.ShardedIvfPq(comms, indexes, params.metric,
                                int(rows.sum()), bounds, scan_mode)
