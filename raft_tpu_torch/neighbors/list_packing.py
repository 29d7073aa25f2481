"""IVF list placement (counterpart of ``raft_tpu.neighbors.list_packing``).

The capacity and spill rules are host-side numpy, as in the JAX package; the
append of a new batch into existing lists runs on the lists' device as a
segment scatter (stable sort by label, rank within the label, one indexed
write)."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.utils.shape import round_up_to


def choose_list_pad(sizes, max_expansion: float = 1.5,
                    align: int = 8) -> int:
    """Per-list capacity bounding padded storage: the largest ``align``-ed
    capacity whose ``n_lists·pad`` slots plus the overflow block of rows
    spilled from longer lists stay within ``max_expansion ×`` the row count.
    The max-driven pad is returned unchanged when it already fits."""
    sizes = np.asarray(sizes, np.int64)
    n = int(sizes.sum())
    n_lists = len(sizes)
    max_pad = max(round_up_to(int(sizes.max() if n_lists else 1), align),
                  align)
    budget = max_expansion * max(n, 1)
    if n_lists * max_pad <= budget:
        return max_pad
    s_desc = np.sort(sizes)[::-1]
    csum = np.concatenate([[0], np.cumsum(s_desc)])
    caps = np.arange(max_pad - align, 0, -align, dtype=np.int64)
    m = np.searchsorted(-s_desc, -caps, side="left")  # lists longer than cap
    overflow = csum[m] - caps * m
    over_pad = np.where(overflow > 0, (-(-overflow // align)) * align, 0)
    storage = n_lists * caps + over_pad
    ok = np.flatnonzero(storage <= budget)
    return int(caps[ok[0]]) if len(ok) else align


def fit_mask(labels: np.ndarray, n_lists: int, cap, sizes=None) -> np.ndarray:
    """True for rows that fit their list's remaining capacity in batch
    order, False for rows that spill to the overflow block. ``sizes`` is
    each list's occupancy before the batch (default 0)."""
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    sl = labels[order]
    starts = np.searchsorted(sl, np.arange(n_lists))
    rank = np.arange(len(sl), dtype=np.int64) - starts[sl]
    room = np.broadcast_to(np.asarray(cap, np.int64), (n_lists,)).copy()
    if sizes is not None:
        room = np.maximum(room - np.asarray(sizes, np.int64), 0)
    keep = np.empty(len(labels), bool)
    keep[order] = rank < room[sl]
    return keep


def pad_overflow_block(rows: np.ndarray, ids: np.ndarray, align: int = 8):
    """Pad spilled rows/ids up to ``align`` (ids -1-filled); a zero-row
    block stays shape [0]."""
    n = len(rows)
    if n == 0:
        return rows, np.zeros((0,), np.int32)
    pad = max(round_up_to(n, align), align)
    out = np.zeros((pad,) + rows.shape[1:], rows.dtype)
    out[:n] = rows
    out_ids = np.full((pad,), -1, np.int32)
    out_ids[:n] = ids
    return out, out_ids


def grow_pad(data: torch.Tensor, idxs: torch.Tensor, new_max: int):
    """Grow list storage to hold ``new_max`` rows per list (8-aligned):
    zero rows for ``data``, -1 for ``idxs``. No-op if it already fits."""
    new_pad = max(-(-max(int(new_max), 1) // 8) * 8, 8)
    old_pad = data.shape[1]
    if new_pad <= old_pad:
        return data, idxs
    grow = new_pad - old_pad
    data = torch.cat([data, data.new_zeros((data.shape[0], grow,
                                            *data.shape[2:]))], dim=1)
    idxs = torch.cat([idxs, idxs.new_full((idxs.shape[0], grow), -1)], dim=1)
    return data, idxs


def label_slots(labels: torch.Tensor, sizes: torch.Tensor, n_lists: int):
    """For each new row, (order, list, slot): the slot follows the list's
    current tail, in batch order within a list."""
    order = torch.argsort(labels, stable=True)
    sl = labels[order].to(torch.int64)
    starts = torch.searchsorted(sl, torch.arange(n_lists, device=sl.device))
    rank = torch.arange(sl.shape[0], device=sl.device) - starts[sl]
    slot = sizes.to(torch.int64)[sl] + rank
    return order, sl, slot


def append_lists(data, idxs, sizes, new_rows, new_ids, labels, n_lists: int):
    """Write a new batch after each list's tail in (already grown) storage.
    Returns new (data, idxs, sizes); the inputs are left as they were. Rows
    past a list's capacity are dropped, as the JAX package's scatter drops
    them."""
    order, sl, slot = label_slots(labels, sizes, n_lists)
    keep = slot < data.shape[1]
    data = data.clone()
    idxs = idxs.clone()
    data[sl[keep], slot[keep]] = new_rows[order][keep].to(data.dtype)
    idxs[sl[keep], slot[keep]] = new_ids[order][keep].to(idxs.dtype)
    counts = torch.bincount(labels.to(torch.int64), minlength=n_lists)
    return data, idxs, sizes + counts.to(sizes.dtype)
