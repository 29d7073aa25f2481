"""Sparse neighbours: CSR brute-force kNN and the cross-component 1-NN
(counterpart of ``raft_tpu.sparse.neighbors``; RAFT's
sparse/neighbors/knn.cuh and cross_component_nn.cuh).

``cross_component_nn`` finds, for each row, the nearest row of another
colour (connected component): the step that lets single linkage and
HDBSCAN join the fragments of a kNN graph. It walks the rows in tiles of
``tile`` against all rows, as the JAX package does: an fp32 product (TF32
refused on the card), the squared distances clamped at 0, the pairs of one
colour (and rows of a negative colour) masked to +inf, then each row's
minimum and the first column that holds it (``torch.min`` over a row, as
``jnp.argmin``; a row whose entries are all +inf gets column 0). This is
glue: neither package has a kernel for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, as_tensors
from raft_tpu_torch.ops.distance import DistanceType, _check_fp32_products
from raft_tpu_torch.sparse import distance as sparse_distance
from raft_tpu_torch.sparse.types import CSR


def brute_force_knn(database: CSR, queries: CSR, k: int,
                    metric: DistanceType = DistanceType.L2Expanded,
                    res: Optional[Resources] = None, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN between CSR rows → ``(distances [n_q, k], indices [n_q,
    k])``, on ``res``'s device (CUDA unless the caller asks for the CPU)."""
    return sparse_distance.knn(queries, database, k, metric=metric, res=res,
                               device=device)


def cross_component_nn(x, colors, tile: int = 1024, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``x`` [n, d], the squared-L2 nearest row with a
    different ``colors`` label → ``(min_sq_dist [n] f32, argmin [n]
    int32)``; a row with no row of another colour gets +inf. Tensors stay
    on their device; host arrays go to ``device`` (CUDA unless the caller
    asks for the CPU)."""
    x, colors = as_tensors(x, colors, device=device)
    x = x.to(torch.float32).contiguous()
    colors = colors.to(torch.int32)
    _check_fp32_products(x)
    n = x.shape[0]
    tile = max(int(min(tile, n)), 1)
    xn = torch.sum(x * x, -1)
    vals, idxs = [], []
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        # |b|² - 2·a·b from one product with the norms as its bias (-2·a is
        # exact), then + |a|², in place: the tile is [tile, n]
        d = torch.addmm(xn, x[lo:hi] * -2.0, x.T).add_(xn[lo:hi, None])
        ct = colors[lo:hi, None]
        d.clamp_min_(0.0).masked_fill_((ct == colors[None, :]) | (ct < 0),
                                       torch.inf)
        v, i = torch.min(d, dim=1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
        del d
    return torch.cat(vals), torch.cat(idxs)


def connect_components_edges(x, colors, device=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Candidate cross-component edges, one per source row: ``(rows, cols,
    sq_dists)``. With the kNN graph they make a connected graph for the
    MST (cross_component_nn.cuh:22-60, connect_components)."""
    d, j = cross_component_nn(x, colors, device=device)
    i = torch.arange(d.shape[0], dtype=torch.int32, device=d.device)
    return i, j, d
