"""Nearest-neighbour search: exact (brute_force), IVF-Flat, IVF-PQ with
refine, CAGRA with NN-descent, the hnswlib export of a CAGRA graph, the
crash-consistent mutable write path (mutable), the tiered IVF-PQ index over
pinned host memory (tiered) and the streamed builds from files (ooc)."""

from raft_tpu_torch.neighbors import (brute_force, cagra, hnsw, ivf_flat,
                                      ivf_pq, mutable, nn_descent, ooc, refine,
                                      tiered)

__all__ = ["brute_force", "cagra", "hnsw", "ivf_flat", "ivf_pq", "mutable",
           "nn_descent", "ooc", "refine", "tiered"]
