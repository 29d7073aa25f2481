"""Spectral partitioning and embedding (counterpart of
``raft_tpu.sparse.spectral``; RAFT's spectral/partition.cuh and
modularity_maximization.cuh).

``partition``: the smallest non-trivial eigenvectors of the normalised
Laplacian (the dense [n, n] ``sparse.linalg.laplacian``, its matvec an fp32
product with TF32 refused on the card), by ``ops.linalg.lanczos`` with
``ncv = min(n, max(4(k+1), 32))``, rows normalised, then Lloyd k-means
(``cluster.kmeans.fit_predict``, whose E-step on the card is the
``fused_l2_argmin`` kernel). ``modularity_maximization``: the largest
eigenvectors of B = A - d·dᵀ/2m, then k-means. A ``torch.Generator`` takes
the place of the JAX package's key; without one, the resources' generator
draws the start vector (``res.next_key()`` in the JAX package).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import (Resources, as_tensors,
                                           ensure_resources)
from raft_tpu_torch.ops import linalg as tlinalg
from raft_tpu_torch.ops.distance import _check_fp32_products
from raft_tpu_torch.sparse.convert import csr_to_dense
from raft_tpu_torch.sparse.distance import placed
from raft_tpu_torch.sparse.linalg import laplacian as make_laplacian
from raft_tpu_torch.sparse.types import CSR


def _row_normalized(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1,
                                                        keepdim=True), 1e-12)


def fit_embedding(adj: CSR, n_components: int, normalized: bool = True,
                  generator: Optional[torch.Generator] = None,
                  res: Optional[Resources] = None, device=None
                  ) -> torch.Tensor:
    """The ``n_components`` smallest non-trivial Laplacian eigenvectors
    [n, k] (partition.cuh's eigensolver stage), on ``res``'s device (CUDA
    unless the caller asks for the CPU)."""
    res = ensure_resources(res, device)
    generator = res.generator if generator is None else generator
    lap = make_laplacian(placed(adj, res.device), normalized=normalized)
    _check_fp32_products(lap)
    n = lap.shape[0]
    # k+1 smallest: the first is the trivial (constant) eigenvector
    _, vecs = tlinalg.lanczos(lambda v: torch.matmul(lap, v), n,
                              n_components + 1, generator=generator,
                              ncv=min(n, max(4 * (n_components + 1), 32)))
    return vecs[:, 1:n_components + 1]


def partition(adj: CSR, n_clusters: int, n_eig_vects: Optional[int] = None,
              kmeans_iters: int = 25,
              generator: Optional[torch.Generator] = None,
              res: Optional[Resources] = None, device=None
              ) -> Tuple[np.ndarray, torch.Tensor]:
    """Spectral partition (spectral::partition): Laplacian eigenvectors,
    then k-means on the row-normalised embedding → ``(labels [n] numpy,
    embedding [n, k])``."""
    from raft_tpu_torch.cluster import kmeans

    res = ensure_resources(res, device)
    k_eig = n_eig_vects or n_clusters
    emb = fit_embedding(adj, k_eig, normalized=True, generator=generator,
                        res=res)
    params = kmeans.KMeansParams(n_clusters=n_clusters, max_iter=kmeans_iters)
    _, labels = kmeans.fit_predict(_row_normalized(emb), params, res=res)
    return labels.cpu().numpy(), emb


def analyze_partition(adj: CSR, labels) -> Tuple[float, float]:
    """Edge cut and ratio cut (partition.cuh analyzePartition) →
    ``(edge_cut, Σ_c cut_c / |c|)``, on the adjacency's device. Each row's
    cut is summed once, then the rows of each label in row order (a stable
    sort and ``segment_reduce``), in float64."""
    a = csr_to_dense(adj)
    a = torch.maximum(a, a.T)
    labels, = as_tensors(labels, device=a.device)
    labels = labels.to(torch.int64)
    row_cut = torch.where(labels[:, None] != labels[None, :], a, 0.0).sum(1)
    uniq, inv, counts = torch.unique(labels, return_inverse=True,
                                     return_counts=True)
    order = torch.argsort(inv, stable=True)
    cut_c = torch.segment_reduce(row_cut[order].to(torch.float64), "sum",
                                 lengths=counts)
    edge_cut = float(row_cut.to(torch.float64).sum() / 2.0)
    ratio = 0.0
    for c, size in zip(cut_c.tolist(), counts.tolist()):
        ratio += c / float(size)
    return edge_cut, float(ratio)


def modularity_maximization(adj: CSR, n_clusters: int,
                            generator: Optional[torch.Generator] = None,
                            res: Optional[Resources] = None, device=None
                            ) -> Tuple[np.ndarray, torch.Tensor]:
    """Modularity-matrix spectral clustering (modularity_maximization.cuh):
    the largest eigenvectors of B = A - d·dᵀ/2m, then k-means →
    ``(labels [n] numpy, eigenvectors [n, k])``."""
    from raft_tpu_torch.cluster import kmeans

    res = ensure_resources(res, device)
    generator = res.generator if generator is None else generator
    a = csr_to_dense(placed(adj, res.device))
    a = torch.maximum(a, a.T)
    _check_fp32_products(a)
    d = torch.sum(a, dim=1)
    two_m = torch.clamp_min(torch.sum(d), 1e-20)
    n = a.shape[0]

    def matvec(v):
        return torch.matmul(a, v) - d * (torch.dot(d, v) / two_m)

    _, vecs = tlinalg.lanczos(matvec, n, n_clusters, generator=generator,
                              which="largest",
                              ncv=min(n, max(4 * n_clusters, 32)))
    params = kmeans.KMeansParams(n_clusters=n_clusters, max_iter=25)
    _, labels = kmeans.fit_predict(_row_normalized(vecs), params, res=res)
    return labels.cpu().numpy(), vecs
