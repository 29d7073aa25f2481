"""Nearest-neighbour search: exact (brute_force), IVF-Flat, IVF-PQ with
refine, CAGRA with NN-descent, and the hnswlib export of a CAGRA graph."""

from raft_tpu_torch.neighbors import (brute_force, cagra, hnsw, ivf_flat,
                                      ivf_pq, nn_descent, refine)

__all__ = ["brute_force", "cagra", "hnsw", "ivf_flat", "ivf_pq",
           "nn_descent", "refine"]
