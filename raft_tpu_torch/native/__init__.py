"""Host-side list packing (the numpy half of ``raft_tpu.native.pack_lists``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def pack_lists(rows: np.ndarray, labels: np.ndarray, n_lists: int,
               list_pad: int, ids: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack rows into padded per-list storage in row order within each list.
    Returns (data [L, pad, ...] zero-padded, ids [L, pad] int32 with -1 at
    unfilled slots, sizes [L] int32)."""
    rows = np.ascontiguousarray(rows)
    labels = np.ascontiguousarray(labels, np.int32)
    n = len(rows)
    out = np.zeros((n_lists, list_pad) + rows.shape[1:], rows.dtype)
    out_ids = np.full((n_lists, list_pad), -1, np.int32)
    src_ids = ids if ids is not None else np.arange(n, dtype=np.int32)
    order = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=n_lists).astype(np.int32)
    if sizes.max(initial=0) > list_pad:
        raise ValueError("list_pad too small")
    starts = np.zeros(n_lists + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    rs = rows[order]
    si = np.asarray(src_ids)[order]
    for l in range(n_lists):
        s, e = starts[l], starts[l + 1]
        out[l, : e - s] = rs[s:e]
        out_ids[l, : e - s] = si[s:e]
    return out, out_ids, sizes
