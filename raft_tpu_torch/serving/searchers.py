"""Per-family searcher handles: one uniform, serving-shaped facade over
the four index families' public ``search()`` wrappers.

Counterpart of ``raft_tpu.serving.searchers``. A handle owns (a) the
index, whose tensors :meth:`Searcher.place` keeps on the index's own
device (``.to(index.device)`` per tensor attribute — never a silent CPU
default), and (b) a closed-over search callable taking a batch
``[n, dim]`` already staged on that device (:meth:`Searcher.to_device`)
and returning the public wrapper's ``(distances, indices)`` tensors for
exactly those ``n`` rows.

The handles call the PUBLIC wrappers, so serving inherits every engine
choice, workspace tile and explain record of ``search`` instead of
re-deriving them. The CAGRA handle keeps one thing of its own: the seed
table of each (bucket, k) of its params, drawn once — at warm time — and
reused
(``cagra.search(..., seeds=...)``); the rows are bitwise those of a search
that draws them per call, and the host draw leaves the hot path.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["Searcher", "make_searcher", "brute_force_searcher",
           "ivf_flat_searcher", "ivf_pq_searcher", "cagra_searcher",
           "elastic_searcher", "tiered_ivf_pq_searcher",
           "mutable_ivf_searcher"]


@dataclasses.dataclass
class Searcher:
    """Uniform serving handle for one built index."""

    family: str
    dim: int
    index: object
    #: (queries [n, dim] on the index's device, k) -> (distances, indices)
    #: tensors [n, k] on that device
    search: Callable[[torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]
    query_dtype: np.dtype = np.dtype(np.float32)

    @property
    def device(self) -> torch.device:
        """The index's own device: where batches are staged and searched."""
        return self.index.device

    def place(self) -> int:
        """Keep every tensor attribute of the index on the index's device
        (idempotent). Returns the number of tensors placed."""
        dev = self.device
        n = 0
        for name, value in list(vars(self.index).items()):
            if isinstance(value, torch.Tensor):
                setattr(self.index, name, value.to(dev))
                n += 1
        return n

    def to_device(self, batch: np.ndarray) -> torch.Tensor:
        """A host batch as a tensor on the index's device. On CUDA the copy
        goes from pinned memory without blocking, so staging a batch never
        waits for the batch before it: a blocking copy from pageable
        memory synchronises the stream first."""
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    @property
    def coverage(self) -> float:
        """Fraction of indexed rows this handle can search: 1.0 for a full
        index, < 1 for a degraded elastic restore
        (``allow_partial=True``). The engine reports it in ``health()`` and
        its stats, and records its transitions across
        :meth:`Engine.swap_index`."""
        return float(getattr(self.index, "coverage", 1.0))


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type of a batch for rows of ``dtype``: the narrow types
    as they are, float32 for the rest (numpy has no bfloat16)."""
    narrow = {torch.float16: np.float16, torch.int8: np.int8,
              torch.uint8: np.uint8}
    return np.dtype(narrow.get(dtype, np.float32))


def brute_force_searcher(index, res=None, scan_dtype=None,
                         refine_ratio: float = 4.0,
                         select_recall: float = 1.0) -> Searcher:
    """Brute-force handle; ``scan_dtype`` (the bf16 fast scan),
    ``refine_ratio`` and ``select_recall`` flow to ``brute_force.search``.
    Batches travel in the dataset's type, as the search casts them."""
    from raft_tpu_torch.neighbors import brute_force

    def search(queries, k: int):
        return brute_force.search(index, queries, k, res=res,
                                  scan_dtype=scan_dtype,
                                  refine_ratio=refine_ratio,
                                  select_recall=select_recall)

    return Searcher("brute_force", int(index.dim), index, search,
                    _host_dtype(index.dataset.dtype))


def ivf_flat_searcher(index, params=None, res=None) -> Searcher:
    """IVF-Flat handle; ``params`` (the fast scan's ``scan_dtype`` and
    ``refine_ratio`` too) flow to ``ivf_flat.search``. Batches travel in
    float32 whatever the lists' row type, as in the JAX package: the search
    keeps the queries' type, and the kernel is chosen by the row type."""
    from raft_tpu_torch.neighbors import ivf_flat

    params = params or ivf_flat.SearchParams()

    def search(queries, k: int):
        return ivf_flat.search(index, queries, k, params, res=res)

    return Searcher("ivf_flat", int(index.dim), index, search)


def ivf_pq_searcher(index, params=None, res=None) -> Searcher:
    from raft_tpu_torch.neighbors import ivf_pq

    params = params or ivf_pq.SearchParams()

    def search(queries, k: int):
        return ivf_pq.search(index, queries, k, params, res=res)

    return Searcher("ivf_pq", int(index.dim), index, search)


def cagra_searcher(index, params=None, res=None) -> Searcher:
    """CAGRA handle with a seed table per (bucket, k): drawn on the first
    search of that shape (the engine's warm-up) and reused. ``params``
    (the fast scan's ``scan_dtype`` too) flow to ``cagra.search``."""
    from raft_tpu_torch.neighbors import cagra

    params = params or cagra.SearchParams()
    lock = threading.Lock()
    tables: Dict[Tuple[int, int], torch.Tensor] = {}  # guarded_by: lock

    def search(queries, k: int):
        n_seeds = cagra.resolve_search_plan(params, k, index.size)[3]
        key = (queries.shape[0], n_seeds)
        with lock:
            seeds = tables.get(key)
            if seeds is None:
                seeds = tables[key] = cagra.seed_table(
                    params, key[0], index.size, n_seeds, index.device)
        return cagra.search(index, queries, k, params, res=res, seeds=seeds)

    return Searcher("cagra", int(index.dim), index, search)


def elastic_searcher(index, params=None, res=None) -> Searcher:
    """Handle over an elastic restore (``parallel.sharded.ElasticIvfFlat``
    or ``ElasticIvfPq``), the degraded-serving path: a checkpoint restored
    with ``allow_partial=True`` serves its surviving ranks here with
    ``searcher.coverage`` < 1, and a later full restore takes its place
    through :meth:`Engine.swap_index`."""
    from raft_tpu_torch.parallel import sharded

    if isinstance(index, sharded.ElasticIvfPq):
        family = "elastic_ivf_pq"
    elif isinstance(index, sharded.ElasticIvfFlat):
        family = "elastic_ivf_flat"
    else:
        raise TypeError(
            f"elastic_searcher wants ElasticIvfPq/ElasticIvfFlat, got "
            f"{type(index).__name__}")

    def search(queries, k: int):
        r = index.search(queries, k, params, res=res)
        return r.distances, r.indices

    return Searcher(family, int(index.dim), index, search)


def _deferred(name: str, item: str):
    def raise_deferred(index, params=None, res=None) -> Searcher:
        raise NotImplementedError(
            f"serving.{name} is not ported yet (ROADMAP Queue A {item})")
    raise_deferred.__name__ = name
    return raise_deferred


tiered_ivf_pq_searcher = _deferred("tiered_ivf_pq_searcher",
                                   "item 11: the tiered index")
mutable_ivf_searcher = _deferred("mutable_ivf_searcher",
                                 "item 11: the write path")

_FACTORIES = {
    "brute_force": brute_force_searcher,
    "ivf_flat": ivf_flat_searcher,
    "ivf_pq": ivf_pq_searcher,
    "cagra": cagra_searcher,
    "elastic": elastic_searcher,
    "tiered_ivf_pq": tiered_ivf_pq_searcher,
    "mutable_ivf": mutable_ivf_searcher,
}


def make_searcher(family: str, index, **kwargs) -> Searcher:
    """Factory by family name (``brute_force``/``ivf_flat``/``ivf_pq``/
    ``cagra``); keyword arguments flow to the family constructor."""
    try:
        factory = _FACTORIES[family]
    except KeyError:
        raise ValueError(
            f"unknown family {family!r}; expected one of "
            f"{sorted(_FACTORIES)}") from None
    return factory(index, **kwargs)
