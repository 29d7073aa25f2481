"""Nearest-neighbour search: exact (brute_force), IVF-Flat, IVF-PQ with
refine, CAGRA with NN-descent, the hnswlib export of a CAGRA graph, the
crash-consistent mutable write path (mutable), the tiered IVF-PQ index over
pinned host memory (tiered), the streamed builds from files (ooc), the
random ball cover (ball_cover, alias rbc), the epsilon neighbourhood and the
scalar quantizer (quantize)."""

from raft_tpu_torch.neighbors import (ball_cover, brute_force, cagra,
                                      epsilon_neighborhood, hnsw, ivf_flat,
                                      ivf_pq, mutable, nn_descent, ooc,
                                      quantize, rbc, refine, tiered)

__all__ = ["ball_cover", "brute_force", "cagra", "epsilon_neighborhood",
           "hnsw", "ivf_flat", "ivf_pq", "mutable", "nn_descent", "ooc",
           "quantize", "rbc", "refine", "tiered"]
