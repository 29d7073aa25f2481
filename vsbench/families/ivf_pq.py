"""IVF-PQ through the port's entry points: build, search in the memory
regime the configuration states, and the index's state as raw tensors for
the reference.

A configuration of this family gives ``index`` (``n_lists``, ``pq_dim``,
``pq_bits``, ``kmeans_n_iters``), ``search`` (``n_probes``, ``lut_dtype``,
``internal_distance_dtype``, ``scan_mode``), ``memory_mode`` and, for its
control, ``control_search``: the program's own lower-precision search."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_pq

from vsbench import roofline


def build(rows: torch.Tensor, config: dict, seed: int):
    params = ivf_pq.IndexParams(**config["index"])
    return ivf_pq.build(rows, params, res=Resources(rows.device, seed=seed))


def searcher(index, config: dict, k: int, keep: Optional[torch.Tensor],
             control: bool = False) -> Callable:
    """The call the window times (``control``: the program's own
    lower-precision search, which the control readings take)."""
    params = ivf_pq.SearchParams(**{**config["search"],
                                    **(config["control_search"] if control
                                       else {})})
    filt = Bitset.from_mask(keep) if keep is not None else None
    mode = config["memory_mode"]
    return lambda q: ivf_pq.search(index, q, k, params, filter=filt,
                                   memory_mode=mode)


def state(index) -> Dict[str, torch.Tensor]:
    """Copies of what the reference reads, so that the index can go."""
    return {"centers": index.centers.clone(),
            "rotation": index.rotation.clone(),
            "codebooks": index.codebooks.clone(),
            "list_ids": index.list_indices.clone(),
            "list_sizes": index.list_sizes.clone(),
            "list_codes": index.list_codes.clone(),
            "overflow_ids": index.overflow_indices.clone(),
            "overflow_codes": index.overflow_codes.clone(),
            "overflow_labels": index.overflow_labels.clone(),
            "pq_bits": index.pq_bits}


def work(kernel: str, st: dict, queries: torch.Tensor, config: dict,
         k: int) -> Optional[Tuple[int, int]]:
    """(bytes, operations) of ``kernel`` over one batch of ``queries``."""
    if kernel != "fused_pq_topk":
        return None
    n_probes = config["search"]["n_probes"]
    probes = roofline.coarse_probes(queries, st["centers"], n_probes)
    rows_probed, rows_scanned = roofline.probed_rows(st["list_sizes"], probes)
    pq_dim, book, pq_len = st["codebooks"].shape
    return roofline.pq_topk_work(
        queries.shape[0], n_probes, st["rotation"].shape[0],
        st["centers"].shape[0], pq_dim, pq_len, book,
        pq_dim * st["pq_bits"] // 8, k, rows_probed, rows_scanned)
