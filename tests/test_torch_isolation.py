"""raft_tpu_torch stands alone: it never imports jax or raft_tpu (nor does
chip_smoke.py), and without a CUDA device its entry points raise unless the
caller asks for the CPU, instead of carrying on quietly on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch import interop
from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.neighbors import (ball_cover, brute_force, cagra,
                                      epsilon_neighborhood, ivf_flat, ivf_pq,
                                      mutable, nn_descent, ooc, tiered)
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.ops import linalg
from raft_tpu_torch.parallel import comms, sharded
from raft_tpu_torch.serving import replica_main
from raft_tpu_torch import solver, sparse, spectral, stats
from raft_tpu_torch.cluster import single_linkage
from raft_tpu_torch.core import resources_manager
from raft_tpu_torch.sparse import distance as sparse_distance
from raft_tpu_torch.sparse import neighbors as sparse_neighbors
from raft_tpu_torch.sparse.types import CSR

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import raft_tpu_torch
# importing the package pulls in serving, planner and bench: none of them
# may bring jax or raft_tpu along
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "raft_tpu"))
assert not bad, bad
import chip_smoke
from raft_tpu_torch import interop, testing
from raft_tpu_torch.bench import datagen
from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, list_packing
from raft_tpu_torch.neighbors import cagra, nn_descent, refine
from raft_tpu_torch.bench import breakdown
from raft_tpu_torch.ops import fused_l2_nn, gpu_kernels, rng, select_k
from raft_tpu_torch.ops import distance, select_k_filtered
from raft_tpu_torch.parallel import comms, sharded
from raft_tpu_torch import obs, serving
from raft_tpu_torch.bench import serve_load
from raft_tpu_torch.obs import (device, diagnostics, explain, httpd, metrics,
                                quality, slo, spans)
from raft_tpu_torch.serving import batcher, engine, searchers, stats
from raft_tpu_torch import native
from raft_tpu_torch.core import errors, logger, serialize, tracing
from raft_tpu_torch.neighbors import hnsw
from raft_tpu_torch.neighbors import mutable, ooc, tiered
from raft_tpu_torch.testing import faults, interleave
from raft_tpu_torch import planner
from raft_tpu_torch.planner import adaptive, sweep
from raft_tpu_torch.obs import costs
from raft_tpu_torch.bench import (export, prims, probe, runner, timing,
                                  write_tiers)
import raft_tpu_torch.bench.__main__
from raft_tpu_torch.parallel import host_p2p
from raft_tpu_torch.serving import (autoscaler, fleet, remote, replica_main,
                                    router)
from raft_tpu_torch.bench import fleet_load
import raft_tpu_torch.serving.replica_main
from raft_tpu_torch.core import interruptible
from raft_tpu_torch.ops import pairwise_distance, select_k as select_k_fn
from raft_tpu_torch.parallel import init_distributed
from raft_tpu_torch.parallel.sharded import (
    ShardedCagra, build_cagra, build_ivf_flat_from_file,
    build_ivf_pq_from_file, build_ivf_pq_from_file_pod, search_cagra)
from raft_tpu_torch.interop import sharded_cagra_from_numpy
from raft_tpu_torch.bench import sharded_rest
from raft_tpu_torch import matrix, sparse
from raft_tpu_torch.core import operators
from raft_tpu_torch.ops import kernels, linalg
from raft_tpu_torch.ops import matrix as ops_matrix
from raft_tpu_torch.sparse import convert, op, selection, types
from raft_tpu_torch.sparse import linalg as sparse_linalg
from raft_tpu_torch.stats import basic, cluster_metrics
from raft_tpu_torch.neighbors import (ball_cover, epsilon_neighborhood,
                                      quantize, rbc)
from raft_tpu_torch.interop import (ball_cover_index_from_numpy,
                                    coo_from_numpy, csr_from_numpy)
from raft_tpu_torch.bench import breadth
from raft_tpu_torch import (common, distance, label, random, solver, spatial,
                            spectral)
from raft_tpu_torch.sparse import distance as sparse_distance
from raft_tpu_torch.sparse import mst, neighbors as sparse_neighbors
from raft_tpu_torch.sparse import solver as sparse_solver
from raft_tpu_torch.sparse import spectral as sparse_spectral
from raft_tpu_torch.cluster import single_linkage
from raft_tpu_torch.core import resources_manager
from raft_tpu_torch.utils import compile_cache, debug
from raft_tpu_torch.bench import graph
assert callable(select_k_fn) and raft_tpu_torch.ops.select_k is select_k_fn
assert {"serving", "planner", "bench"} <= set(raft_tpu_torch.__all__)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "raft_tpu"))
# the native layer loads the port's own build, never the JAX package's
native.available()
with open("/proc/self/maps") as f:
    maps = f.read()
if "raft_tpu/native/" in maps:
    bad.append("raft_tpu/native library")
if native._lib is not None and "build/raft_tpu_torch/native/" not in str(
        native.library_path()):
    bad.append(str(native.library_path()))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_raft_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


@pytest.mark.parametrize("entry", ["brute_force.build", "brute_force.knn",
                                   "ivf_flat.build", "ivf_pq.build", "refine",
                                   "nn_descent.build", "cagra.build",
                                   "cagra.optimize", "cagra.search",
                                   "kmeans.fit", "Resources", "init_comms",
                                   "sharded.knn", "mutable.MutableIvf",
                                   "tiered.SlabArena",
                                   "ooc.build_ivf_flat_from_file",
                                   "replica_main.build_searcher",
                                   "ball_cover.build", "eps_neighbors",
                                   "linalg.gemm", "linalg.lanczos",
                                   "stats.trustworthiness_score",
                                   "sparse.csr_from_scipy_like",
                                   "single_linkage", "sparse.distance.knn",
                                   "cross_component_nn", "spectral.partition",
                                   "solver.solve",
                                   "resources_manager.get_resources"])
def test_entry_points_raise_without_cuda_unless_asked_for_cpu(entry,
                                                              tmp_path):
    _no_cuda()
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    # a CSR of host arrays: the entry point places it on its device
    host_csr = CSR(np.array([0, 1, 2], np.int32), np.array([0, 1], np.int32),
                   np.array([1.0, 1.0], np.float32), (2, 2))
    calls = {
        "brute_force.build": lambda: brute_force.build(db),
        "brute_force.knn": lambda: brute_force.knn(db[:4], db, 3),
        "ivf_flat.build": lambda: ivf_flat.build(
            db, ivf_flat.IndexParams(n_lists=4)),
        "ivf_pq.build": lambda: ivf_pq.build(
            db, ivf_pq.IndexParams(n_lists=4, pq_dim=4)),
        "refine": lambda: refine(db, db[:4], np.zeros((4, 5), np.int32), 3),
        "nn_descent.build": lambda: nn_descent.build(
            db, nn_descent.IndexParams(graph_degree=4,
                                       intermediate_graph_degree=8)),
        "cagra.build": lambda: cagra.build(
            db, cagra.IndexParams(intermediate_graph_degree=8,
                                  graph_degree=4)),
        "cagra.optimize": lambda: cagra.optimize(
            np.zeros((64, 8), np.int32), 4),
        # an index on the default device, then a search of it
        "cagra.search": lambda: cagra.search(interop.cagra_index_from_numpy(
            cagra.IndexParams(graph_degree=4), db,
            np.zeros((64, 4), np.int32)), db[:4], 3),
        "kmeans.fit": lambda: kmeans.fit(db, kmeans.KMeansParams(
            n_clusters=4)),
        "Resources": lambda: Resources(),
        # one rank per CUDA device, the default
        "init_comms": lambda: comms.init_comms(),
        "sharded.knn": lambda: sharded.knn(comms.init_comms(), db[:4], db, 3),
        "mutable.MutableIvf": lambda: mutable.MutableIvf(str(tmp_path),
                                                         dim=8),
        "tiered.SlabArena": lambda: tiered.SlabArena(4, 8, 8),
        "ooc.build_ivf_flat_from_file": lambda: ooc.build_ivf_flat_from_file(
            str(tmp_path / "none.fbin")),
        "replica_main.build_searcher": lambda: replica_main.build_searcher(
            {"family": "ivf_flat", "dim": 8, "rows": 64, "n_lists": 4}),
        "ball_cover.build": lambda: ball_cover.build(db[:, :3]),
        "eps_neighbors": lambda: epsilon_neighborhood.eps_neighbors(
            db, db, 1.0),
        # host arrays go to the default device
        "linalg.gemm": lambda: linalg.gemm(db, db.T),
        "linalg.lanczos": lambda: linalg.lanczos(lambda v: v, 64, 2),
        "stats.trustworthiness_score": lambda: stats.trustworthiness_score(
            db, db[:, :2]),
        "sparse.csr_from_scipy_like": lambda: sparse.csr_from_scipy_like(
            np.array([0, 1]), np.array([0]), np.array([1.0]), (1, 1)),
        "single_linkage": lambda: single_linkage.single_linkage(db),
        "sparse.distance.knn": lambda: sparse_distance.knn(host_csr, host_csr,
                                                           1),
        "cross_component_nn": lambda: sparse_neighbors.cross_component_nn(
            db, np.arange(64)),
        "spectral.partition": lambda: spectral.partition(host_csr, 2),
        "solver.solve": lambda: solver.solve(db[:8, :8]),
        "resources_manager.get_resources": lambda:
            resources_manager.get_resources(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    _no_cuda()
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:  # alone, without the package beside it
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
