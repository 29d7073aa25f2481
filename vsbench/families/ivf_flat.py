"""IVF-Flat through the port's entry points: build, search, and the index's
state as raw tensors for the reference.

A configuration of this family gives ``index`` (``n_lists``,
``kmeans_n_iters``) and ``search`` (``n_probes``, ``scan_mode``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat

from vsbench import roofline


def build(rows: torch.Tensor, config: dict, seed: int):
    params = ivf_flat.IndexParams(**config["index"])
    return ivf_flat.build(rows, params, res=Resources(rows.device, seed=seed))


def searcher(index, config: dict, k: int,
             keep: Optional[torch.Tensor]) -> Callable:
    """The call the window times: queries → (distances, ids) on the card."""
    params = ivf_flat.SearchParams(**config["search"])
    filt = Bitset.from_mask(keep) if keep is not None else None
    return lambda q: ivf_flat.search(index, q, k, params, filter=filt)


def state(index) -> Dict[str, torch.Tensor]:
    """Copies of what the reference reads, so that the index can go."""
    return {"centers": index.centers.clone(),
            "list_ids": index.list_indices.clone(),
            "list_sizes": index.list_sizes.clone(),
            "overflow_ids": index.overflow_indices.clone(),
            "elem_bytes": index.list_data.element_size()}


def work(kernel: str, st: dict, queries: torch.Tensor, config: dict,
         k: int) -> Optional[Tuple[int, int]]:
    """(bytes, operations) of ``kernel`` over one batch of ``queries``."""
    n_probes = config["search"]["n_probes"]
    probes = roofline.coarse_probes(queries, st["centers"], n_probes)
    rows_probed, rows_scanned = roofline.probed_rows(st["list_sizes"], probes)
    nq, dim = queries.shape
    if kernel == "fused_ivf_topk":
        return roofline.ivf_topk_work(nq, n_probes, dim, st["elem_bytes"], k,
                                      rows_probed, rows_scanned)
    if kernel == "ivf_scan":
        return roofline.ivf_scan_work(nq, n_probes, dim, st["elem_bytes"],
                                      rows_probed, rows_scanned)
    return None
