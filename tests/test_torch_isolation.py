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
from raft_tpu_torch.neighbors import (brute_force, cagra, ivf_flat, ivf_pq,
                                      mutable, nn_descent, ooc, tiered)
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.parallel import comms, sharded

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import chip_smoke
import raft_tpu_torch
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
                                   "ooc.build_ivf_flat_from_file"])
def test_entry_points_raise_without_cuda_unless_asked_for_cpu(entry,
                                                              tmp_path):
    _no_cuda()
    db = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
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
