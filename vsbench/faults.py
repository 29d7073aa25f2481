"""Faults planted in the program's build, for the readings that a limit's
upper end is set from and for the CPU tests that see ``correct`` false.

    python3 -m vsbench.control --workload <cell> --seeds <n> ... \
        --fault <name>

Each fault replaces one function of the program for as long as its
context lasts:

- ``coarse_untrained``: the coarse k-means returns its start, distinct
  random rows of the trainset, and never iterates;
- ``codebooks_untrained``: IVF-PQ's codebooks keep their start, random
  subvectors of the trainset, and never iterate.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator

import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.neighbors import ivf_pq


def _coarse_untrained(fit: Callable) -> Callable:
    def call(generator, x, n_clusters, params=None):
        pick = torch.randperm(x.shape[0], generator=generator,
                              device=x.device)[:n_clusters]
        return x[pick].to(torch.float32).clone()
    return call


def _codebooks_untrained(train: Callable) -> Callable:
    def call(generator, subvecs, weights, book_size, n_iters, *a, **kw):
        return train(generator, subvecs, weights, book_size, 0, *a, **kw)
    return call


#: fault name → (module, attribute, wrapper of the original)
FAULTS: Dict[str, tuple] = {
    "coarse_untrained": (kmeans_balanced, "fit", _coarse_untrained),
    "codebooks_untrained": (ivf_pq, "_train_codebooks",
                            _codebooks_untrained),
}


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    """The program with the fault ``name`` in place."""
    module, attr, wrap = FAULTS[name]
    original = getattr(module, attr)
    setattr(module, attr, wrap(original))
    try:
        yield
    finally:
        setattr(module, attr, original)
