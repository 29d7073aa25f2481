"""Spectral partitioning of phase 6j's planted clusters in both packages,
on the CPU, at a row count the CPU can hold densely.

The graph is ``bench.graph.spectral_adjacency`` of ``datagen``'s 10
well-separated clusters (spread 4, 128 wide), as phase 6j builds it on the
card. For each seed it prints one JSON line:

- ``raft_tpu`` and ``port``: the contingency of ``partition(adj, 10)``,
  ``partition(adj, 10, n_eig_vects=24)`` and ``modularity_maximization(adj,
  10)`` against the planted clusters, each package with its own draws
  (``jax.random.key(seed)``; a ``torch.Generator`` seeded with ``seed``);
- ``same_start``: both packages' ``fit_embedding(adj, 10)`` and the
  eigenvectors of ``modularity_maximization(adj, 10)`` from the JAX
  package's start vector (the largest difference up to a sign per column)
  and the port's fp32 Lanczos against ``bench.graph.lanczos64`` from that
  vector (the largest Ritz value difference, the sine of the largest
  principal angle between the returned eigenvector spans).

Run from the repository's root::

    JAX_PLATFORMS=cpu python3 tests/_torch_spectral_reference.py \\
        [--rows 5000] [--seeds 0 1 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from raft_tpu.core.resources import Resources as JResources  # noqa: E402
from raft_tpu.sparse import spectral as jspec  # noqa: E402
from raft_tpu.sparse import types as jtypes  # noqa: E402
from raft_tpu_torch.bench import graph  # noqa: E402
from raft_tpu_torch.bench.datagen import (low_rank_cluster_ids,  # noqa: E402
                                          low_rank_clusters)
from raft_tpu_torch.core.resources import Resources  # noqa: E402
from raft_tpu_torch.ops import linalg as tlin  # noqa: E402
from raft_tpu_torch.sparse import spectral as tspec  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=5000)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    opts = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k = opts.rows, graph.SPEC_CLUSTERS
    rng = np.random.default_rng(8)
    xs = low_rank_clusters(rng, n, graph.DIM, n_centers=k,
                           spread=graph.SPEC_SPREAD)
    truth = low_rank_cluster_ids(np.random.default_rng(8), n, graph.DIM,
                                 n_centers=k)
    res = Resources(device="cpu", seed=0)
    adj, n_comp = graph.spectral_adjacency(torch.from_numpy(xs),
                                           graph.SPEC_K, res)
    jadj = jtypes.csr_from_scipy_like(adj.indptr.numpy(),
                                      adj.indices.numpy(), adj.data.numpy(),
                                      adj.shape)
    print(json.dumps({"rows": n, "clusters": k, "knn_k": graph.SPEC_K,
                      "knn_components": n_comp, "nnz": adj.nnz}), flush=True)
    real_start = tlin._start_vector
    for seed in opts.seeds:
        out = {"seed": seed}
        for name, kw in (("partition", {}),
                         ("partition_n_eig_24", {"n_eig_vects": 24}),
                         ("modularity_maximization", None)):
            jres = JResources(seed=seed)
            gen = torch.Generator().manual_seed(seed)
            tres = Resources(device="cpu", seed=seed)
            if kw is None:
                jl, _ = jspec.modularity_maximization(
                    jadj, k, key=jax.random.key(seed), res=jres)
                tl, _ = tspec.modularity_maximization(adj, k, generator=gen,
                                                      res=tres)
            else:
                jl, _ = jspec.partition(jadj, k, key=jax.random.key(seed),
                                        res=jres, **kw)
                tl, _ = tspec.partition(adj, k, generator=gen, res=tres,
                                        **kw)
            out[name] = {"raft_tpu": graph._contingency(truth, np.asarray(jl),
                                                        k),
                         "port": graph._contingency(truth, tl, k)}
        key = jax.random.key(seed)
        v0 = np.array(jax.random.normal(key, (n,), jnp.float32))
        tlin._start_vector = lambda g, n_: torch.from_numpy(v0)
        try:
            want = np.asarray(jspec.fit_embedding(jadj, k, key=key))
            got = tspec.fit_embedding(adj, k, device="cpu").numpy()
            _, want_m = jspec.modularity_maximization(
                jadj, k, key=key, res=JResources(seed=seed))
            _, got_m = tspec.modularity_maximization(
                adj, k, res=Resources(device="cpu", seed=seed))
        finally:
            tlin._start_vector = real_start
        out["same_start"] = {
            "embedding_max_abs_diff": _diff_up_to_sign(got, want),
            "modularity_vectors_max_abs_diff": _diff_up_to_sign(
                got_m.numpy(), np.asarray(want_m))}
        out["same_start"].update(fp32_against_float64(adj, v0, k))
        print(json.dumps(out), flush=True)
    return 0


def _diff_up_to_sign(got: np.ndarray, want: np.ndarray) -> float:
    sign = np.sign((got * want).sum(0))
    sign[sign == 0] = 1
    return float(np.abs(got * sign - want).max())


def fp32_against_float64(adj, v0: np.ndarray, k: int) -> dict:
    """The port's Lanczos of the normalised Laplacian (fp32, the dense
    operator ``partition`` builds) against ``graph.lanczos64`` from the
    same start vector."""
    from raft_tpu_torch.sparse.linalg import laplacian

    n = adj.shape[0]
    ncv = min(n, max(4 * (k + 1), 32))
    lap = laplacian(adj, normalized=True)
    real_start = tlin._start_vector
    tlin._start_vector = lambda g, n_: torch.from_numpy(v0)
    try:
        theta, vecs = tlin.lanczos(lambda v: torch.matmul(lap, v), n, k + 1,
                                   ncv=ncv, device="cpu")
    finally:
        tlin._start_vector = real_start
    t64, v64, every = graph.lanczos64(graph.spectral_operator64(adj, False),
                                      v0, ncv, k + 1, "smallest")
    return {"ncv": ncv,
            "ritz_max_abs_diff": float(np.abs(theta.double().numpy()
                                              - t64).max()),
            "ritz_gap_after_k": float(np.sort(every)[k + 1]
                                      - np.sort(every)[k]),
            "subspace_sin": graph.subspace_sin(vecs.numpy(), v64)}


if __name__ == "__main__":
    sys.exit(main())
