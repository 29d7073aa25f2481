"""Synthetic ANN data (a copy of ``raft_tpu.bench.datagen.low_rank_clusters``).

Real embedding sets share two properties a generator must keep, or the
numbers measure the generator and not the index: a low intrinsic dimension,
and one connected neighbourhood manifold."""

from __future__ import annotations

import numpy as np


def low_rank_clusters(rng: np.random.Generator, n: int, dim: int,
                      n_centers: int = 96, intrinsic: int = 16,
                      spread: float = 1.5) -> np.ndarray:
    """[n, dim] float32: gaussian clusters in an ``intrinsic``-dim latent
    space (unit cluster std, centers ~ N(0, spread²)), embedded in ``dim``
    ambient dims by one shared random projection."""
    proj = rng.standard_normal((intrinsic, dim)).astype(np.float32)
    centers = rng.standard_normal((n_centers, intrinsic)) * spread
    z = (centers[rng.integers(0, n_centers, n)]
         + rng.standard_normal((n, intrinsic)))
    return z.astype(np.float32) @ proj


def low_rank_cluster_ids(rng: np.random.Generator, n: int, dim: int,
                         n_centers: int = 96, intrinsic: int = 16
                         ) -> np.ndarray:
    """The cluster id [n] int64 of each row that :func:`low_rank_clusters`
    makes from a generator in the same state with the same arguments (its
    draws replayed up to the ids, without the rows)."""
    rng.standard_normal((intrinsic, dim))
    rng.standard_normal((n_centers, intrinsic))
    return rng.integers(0, n_centers, n)
