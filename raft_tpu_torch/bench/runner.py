"""End-to-end ANN benchmark runner.

Counterpart of ``raft_tpu.bench.runner``. Reference: ``raft-ann-bench``
(the ``run`` orchestrator feeding JSON configs to the C++ harness) and the
``ANN<T>`` plugin interface (build / search / set_search_param / save /
load).

One Python process drives the port's families on the card (the CUDA
events of the reference harness become ``bench.timing``'s synchronise
fences). Config files use raft-ann-bench's run/conf JSON shape and
parameter names (nlist/nprobe/pq_dim/itopk/…), so the JAX package's
configs (``bench/conf``, copied byte for byte) run unchanged; datasets are
fbin/ibin files read through ``native.read_bin``. Results are JSON lines
with QPS, recall and build time, the columns ``export`` and ``plot``
consume. The host libraries' rows (sklearn, scipy, the native C++ HNSW
walk) stay on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import torch

from raft_tpu_torch import native
from raft_tpu_torch.bench import timing
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.stats import neighborhood_recall


# ------------------------------------------------------------ algo registry


class AnnAlgo:
    """The ANN<T>-style plugin seam (ann_types.hpp:85-118): build / search /
    save / load with dict params."""

    name = "base"
    # Host-library algos (sklearn/scipy/hnswlib) consume numpy queries;
    # handing them the device copy would make every timed dispatch pay a
    # copy back to the host
    wants_host_queries = False

    def build(self, dataset: np.ndarray, build_param: Dict[str, Any],
              metric: str, res: Resources):
        raise NotImplementedError

    def search(self, index, queries: np.ndarray, k: int,
               search_param: Dict[str, Any], res: Resources):
        raise NotImplementedError

    def save(self, index, path: str):
        raise NotImplementedError

    def load(self, path: str, res: Resources):
        raise NotImplementedError


def _scan_dtype(search_param):
    """Map a config's scan_dtype string; raises on typos instead of silently
    benchmarking the fp32 path under a bf16 label."""
    v = search_param.get("scan_dtype")
    if v is None:
        return None
    if v in ("bf16", "bfloat16", "half"):
        return "bfloat16"
    raise ValueError(f"unknown scan_dtype {v!r}; use bf16/bfloat16/half")


def _lookup_dtype(search_param, key, table, default):
    """Validated dtype lookup for bench search params: raises a named
    ValueError listing the allowed spellings instead of a bare KeyError
    (mirrors the reference's explicit lut/internal dtype validation,
    ivf_pq_types.hpp:110-146)."""
    v = search_param.get(key, default)
    if v not in table:
        raise ValueError(
            f"unknown {key} {v!r}; allowed: {sorted(table)}")
    return table[v]


def _internal_distance_dtype(search_param):
    return _lookup_dtype(
        search_param, "internalDistanceDtype",
        {"float": torch.float32, "fp32": torch.float32,
         "half": torch.bfloat16, "fp16": torch.bfloat16,
         "bf16": torch.bfloat16}, "float")


def _lut_dtype(search_param):
    return _lookup_dtype(
        search_param, "smemLutDtype",
        {"float": torch.float32, "fp32": torch.float32,
         "half": torch.bfloat16, "fp16": torch.bfloat16,
         "bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}, "float")


class BruteForce(AnnAlgo):
    name = "raft_brute_force"

    def build(self, dataset, build_param, metric, res):
        from raft_tpu_torch.neighbors import brute_force

        return brute_force.build(dataset, metric=metric, res=res)

    def search(self, index, queries, k, search_param, res):
        from raft_tpu_torch.neighbors import brute_force

        return brute_force.search(
            index, queries, k, res=res,
            scan_dtype=_scan_dtype(search_param),
            refine_ratio=float(search_param.get("refine_ratio", 4.0)),
            select_recall=float(search_param.get("select_recall", 1.0)))

    def save(self, index, path):
        from raft_tpu_torch.neighbors import brute_force

        brute_force.serialize(index, path)

    def load(self, path, res):
        from raft_tpu_torch.neighbors import brute_force

        return brute_force.deserialize(path, res=res)


class IvfFlat(AnnAlgo):
    name = "raft_ivf_flat"

    def build(self, dataset, build_param, metric, res):
        from raft_tpu_torch.neighbors import ivf_flat

        params = ivf_flat.IndexParams(
            n_lists=int(build_param.get("nlist", 1024)),
            kmeans_n_iters=int(build_param.get("niter", 20)),
            kmeans_trainset_fraction=_ratio(build_param.get("ratio", 2)),
            metric=metric,
        )
        return ivf_flat.build(dataset, params, res=res)

    def search(self, index, queries, k, search_param, res):
        from raft_tpu_torch.neighbors import ivf_flat

        sp = ivf_flat.SearchParams(
            n_probes=int(search_param.get("nprobe", 20)),
            scan_dtype=_scan_dtype(search_param),
            refine_ratio=float(search_param.get("refine_ratio", 4.0)),
            select_recall=float(search_param.get("select_recall", 1.0)))
        return ivf_flat.search(index, queries, k, sp, res=res)

    def save(self, index, path):
        from raft_tpu_torch.neighbors import ivf_flat

        ivf_flat.serialize(index, path)

    def load(self, path, res):
        from raft_tpu_torch.neighbors import ivf_flat

        return ivf_flat.deserialize(path, res=res)


class IvfPq(AnnAlgo):
    name = "raft_ivf_pq"

    _dataset = None  # retained by build() for refine_ratio re-ranking

    def build(self, dataset, build_param, metric, res):
        from raft_tpu_torch.neighbors import ivf_pq

        self._dataset = dataset
        params = ivf_pq.IndexParams(
            n_lists=int(build_param.get("nlist", 1024)),
            pq_dim=int(build_param.get("pq_dim", 0)),
            pq_bits=int(build_param.get("pq_bits", 8)),
            kmeans_n_iters=int(build_param.get("niter", 20)),
            kmeans_trainset_fraction=_ratio(build_param.get("ratio", 2)),
            metric=metric,
        )
        return ivf_pq.build(dataset, params, res=res)

    def search(self, index, queries, k, search_param, res):
        from raft_tpu_torch.neighbors import ivf_pq
        from raft_tpu_torch.neighbors.refine import refine

        lut = _lut_dtype(search_param)
        scan_mode = search_param.get("scan_mode", "auto")
        if lut == torch.float8_e4m3fn and scan_mode != "lut":
            # fp8 LUTs only exist on the LUT engine; the cache engine would
            # silently benchmark fp32-cache numbers under an fp8 label
            scan_mode = "lut"
        sp = ivf_pq.SearchParams(
            n_probes=int(search_param.get("nprobe", 20)),
            lut_dtype=lut,
            internal_distance_dtype=_internal_distance_dtype(search_param),
            scan_mode=scan_mode,
            select_recall=float(search_param.get("select_recall", 1.0)),
        )
        rr = float(search_param.get("refine_ratio", 1.0))
        if rr > 1.0:
            if self._dataset is None:
                raise ValueError(
                    "refine_ratio needs the raw dataset; a loaded index "
                    "doesn't carry it — set algo.set_dataset(data) first")
            d, i = ivf_pq.search(index, queries,
                                 int(np.ceil(k * rr)), sp, res=res)
            return refine(self._dataset, queries, i, k,
                          metric=index.metric, res=res)
        return ivf_pq.search(index, queries, k, sp, res=res)

    def set_dataset(self, dataset):
        self._dataset = dataset

    def save(self, index, path):
        from raft_tpu_torch.neighbors import ivf_pq

        ivf_pq.serialize(index, path)

    def load(self, path, res):
        from raft_tpu_torch.neighbors import ivf_pq

        return ivf_pq.deserialize(path, res=res)


class Cagra(AnnAlgo):
    name = "raft_cagra"

    def build(self, dataset, build_param, metric, res):
        from raft_tpu_torch.neighbors import cagra

        algo = {"ivf_pq": cagra.BuildAlgo.IVF_PQ,
                "nn_descent": cagra.BuildAlgo.NN_DESCENT}[
            build_param.get("graph_build_algo", "nn_descent").lower()]
        params = cagra.IndexParams(
            graph_degree=int(build_param.get("graph_degree", 64)),
            intermediate_graph_degree=int(
                build_param.get("intermediate_graph_degree", 128)),
            build_algo=algo,
            nn_descent_niter=int(build_param.get("nn_descent_niter", 20)),
            metric=metric,
        )
        return cagra.build(dataset, params, res=res)

    def search(self, index, queries, k, search_param, res):
        from raft_tpu_torch.neighbors import cagra

        sp = cagra.SearchParams(
            itopk_size=int(search_param.get("itopk", 64)),
            search_width=int(search_param.get("search_width", 1)),
            max_iterations=int(search_param.get("max_iterations", 0)),
            scan_dtype=_scan_dtype(search_param),
        )
        return cagra.search(index, queries, k, sp, res=res)

    def save(self, index, path):
        from raft_tpu_torch.neighbors import cagra

        cagra.serialize(index, path)

    def load(self, path, res):
        from raft_tpu_torch.neighbors import cagra

        return cagra.deserialize(path, res=res)


# ---------------------------------------------------- competitor wrappers
# The reference bench ships faiss/hnswlib/ggnn wrappers behind the same
# ANN<T> seam so cross-library pareto plots come from one run. Without
# faiss or hnswlib wheels, the host baselines are sklearn's brute force, a
# KD-tree and the native C++ HNSW walk: enough to make the QPS-vs-recall
# plots comparative rather than self-referential.


class SklearnBruteForce(AnnAlgo):
    """Exact CPU baseline (the faiss_cpu/bruteforce comparison role)."""

    name = "sklearn_brute_force"
    wants_host_queries = True

    def build(self, dataset, build_param, metric, res):
        from sklearn.neighbors import NearestNeighbors

        m = {"sqeuclidean": "sqeuclidean", "euclidean": "sqeuclidean",
             "cosine": "cosine", "inner_product": None}.get(metric, metric)
        if m is None:
            raise ValueError(f"sklearn wrapper: unsupported metric {metric}")
        nn = NearestNeighbors(algorithm="brute", metric=m)
        nn.fit(np.asarray(dataset))
        return nn

    def search(self, index, queries, k, search_param, res):
        d, i = index.kneighbors(np.asarray(queries), n_neighbors=k)
        return d.astype(np.float32), i.astype(np.int32)


class ScipyKDTree(AnnAlgo):
    """cKDTree baseline (the hnswlib-CPU comparison role for low dims)."""

    name = "scipy_kdtree"
    wants_host_queries = True

    def build(self, dataset, build_param, metric, res):
        from scipy.spatial import cKDTree

        if metric not in ("sqeuclidean", "euclidean"):
            raise ValueError(f"kdtree wrapper: unsupported metric {metric}")
        return cKDTree(np.asarray(dataset),
                       leafsize=int(build_param.get("leafsize", 32)))

    def search(self, index, queries, k, search_param, res):
        # eps > 0 = approximate pruning (the ef/nprobe-style recall knob)
        d, i = index.query(np.asarray(queries), k=k,
                           eps=float(search_param.get("eps", 0.0)))
        if k == 1:
            d, i = d[:, None], i[:, None]
        return (d.astype(np.float32) ** 2), i.astype(np.int32)


class HnswCpu(AnnAlgo):
    """The hnswlib competitor row (the role of the reference's hnswlib
    wrapper, with no hnswlib wheel): a CAGRA graph built on the device and
    searched on the host by the native C++ ef-search, which is hnswlib's
    layer-0 searchBaseLayerST algorithm over the same on-disk format
    neighbors/hnsw.py exports. Rival pareto points come from a genuinely
    different (CPU, latency-oriented, sequential-walk) execution model.

    build_param: M (hnswlib meaning; graph_degree = 2*M like maxM0).
    search_param: ef.
    """

    name = "hnsw_cpu"
    wants_host_queries = True

    def build(self, dataset, build_param, metric, res):
        from raft_tpu_torch.neighbors import cagra

        if metric not in ("sqeuclidean", "euclidean"):
            raise ValueError(f"hnsw_cpu: unsupported metric {metric}")
        m = int(build_param.get("M", 16))
        idx = cagra.build(
            np.asarray(dataset),
            cagra.IndexParams(
                graph_degree=2 * m,
                intermediate_graph_degree=max(3 * m, 2 * m + 16)),
            res=res)
        return (idx.dataset.cpu().numpy(), idx.graph.cpu().numpy())

    def search(self, index, queries, k, search_param, res):
        from raft_tpu_torch import native

        data, graph = index
        d, i = native.graph_greedy_search(
            data, graph, np.asarray(queries), k,
            ef=int(search_param.get("ef", max(2 * k, 64))))
        return d, i

    def save(self, index, path):
        from raft_tpu_torch import native

        native.hnswlib_write(path, index[0], index[1])


ALGOS: Dict[str, Callable[[], AnnAlgo]] = {
    a.name: a for a in (BruteForce, IvfFlat, IvfPq, Cagra,
                        SklearnBruteForce, ScipyKDTree, HnswCpu)
}


def _ratio(r) -> float:
    """raft-ann-bench 'ratio' = subsample divisor (2 → half the data)."""
    r = float(r)
    return 1.0 / r if r >= 1.0 else r


_METRIC_MAP = {"euclidean": "sqeuclidean", "angular": "cosine",
               "inner_product": "inner_product", "ip": "inner_product",
               "sqeuclidean": "sqeuclidean", "cosine": "cosine"}


# ------------------------------------------------------------------- runner


@dataclasses.dataclass
class DatasetSpec:
    """Dataset block of a run config (run/conf/*.json 'dataset')."""

    name: str
    base_file: str
    query_file: str
    groundtruth_neighbors_file: Optional[str] = None
    distance: str = "euclidean"
    subset_size: Optional[int] = None

    def load(self):
        base = native.read_bin(self.base_file, 0, self.subset_size)
        queries = native.read_bin(self.query_file)
        gt = None
        if self.groundtruth_neighbors_file and os.path.exists(
                self.groundtruth_neighbors_file):
            gt = native.read_bin(self.groundtruth_neighbors_file,
                                 dtype=np.int32)
        return base, queries, gt


def generate_groundtruth(dataset: np.ndarray, queries: np.ndarray, k: int,
                         metric: str = "euclidean",
                         res: Optional[Resources] = None) -> np.ndarray:
    """Exact ground truth via brute force (the generate_groundtruth CLI,
    python/raft-ann-bench generate_groundtruth)."""
    from raft_tpu_torch.neighbors import brute_force

    _, idx = brute_force.knn(queries, dataset,
                             k=k, metric=_METRIC_MAP.get(metric, metric),
                             res=res)
    return idx.cpu().numpy()


def split_groundtruth(gt_path: str, out_neighbors: str,
                      out_distances: str) -> None:
    """Split a big-ann combined groundtruth file into the .ibin/.fbin pair
    the runner reads (the split_groundtruth CLI, python/raft-ann-bench
    split_groundtruth/split_groundtruth.pl). Layout: int32 header (n, k),
    then one block of n·k uint32 neighbor ids, then one block of n·k
    float32 distances."""
    n, k = native.read_bin_header(gt_path)
    with open(gt_path, "rb") as f:
        f.seek(8)
        neigh = np.fromfile(f, np.uint32, n * k)
        dist = np.fromfile(f, np.float32, n * k)
    if neigh.size != n * k or dist.size != n * k:
        raise IOError(
            f"{gt_path}: expected {n}*{k} ids + distances "
            "(big-ann block layout)")
    native.write_bin(out_neighbors, neigh.reshape(n, k).astype(np.int32))
    native.write_bin(out_distances, dist.reshape(n, k))


#: where ``scale_config`` writes its synthetic stand-ins (gitignored)
SCALED_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "bench_scaled")


def scale_config(config: Dict[str, Any], target_rows: int,
                 data_dir: str = SCALED_DATA_DIR) -> Dict[str, Any]:
    """Shrink a full-scale run config (e.g. deep-100M) to ``target_rows``
    so it runs on one card: cluster counts scale with the row factor
    (bounded below at 256), and when the config's dataset files don't
    exist locally (nothing is downloaded), a synthetic clustered stand-in
    of the right shape is generated and cached under ``data_dir``. Search/index param STRUCTURE is untouched — the point
    is to smoke the exact sweep the reference runs, at chip scale."""
    import copy

    from raft_tpu_torch import native
    from raft_tpu_torch.bench.datagen import low_rank_clusters

    conf = copy.deepcopy(config)
    ds = conf["dataset"]
    full_rows = int(ds.get("subset_size") or 0)
    if not full_rows:
        n, _ = native.read_bin_header(ds["base_file"])
        full_rows = n
    factor = target_rows / max(full_rows, 1)
    for entry in conf["index"]:
        bp = entry.get("build_param", {})
        if "nlist" in bp:
            bp["nlist"] = max(256, int(round(bp["nlist"] * factor)))
    if not os.path.exists(ds["base_file"]):
        # dataset dim: the real query file when present, else the
        # ann-benchmarks name convention ("sift-128-euclidean"), else 96
        if os.path.exists(ds.get("query_file", "")):
            _, dim = native.read_bin_header(ds["query_file"])
            dim = int(dim)
        else:
            digits = [int(t) for t in ds["name"].split("-") if t.isdigit()]
            dim = digits[0] if digits else 96
        os.makedirs(data_dir, exist_ok=True)
        base_path = os.path.join(data_dir,
                                 f"{ds['name']}-{target_rows}.fbin")
        q_path = os.path.join(data_dir, f"{ds['name']}-q.fbin")
        if not os.path.exists(base_path):
            rng = np.random.default_rng(0)
            native.write_bin(base_path,
                             low_rank_clusters(rng, target_rows, dim,
                                               n_centers=1024))
            qi = rng.integers(0, target_rows, 10_000)
            b = native.read_bin(base_path)
            native.write_bin(q_path,
                             b[qi] + rng.standard_normal(
                                 (10_000, dim)).astype(np.float32) * 0.01)
        ds["base_file"], ds["query_file"] = base_path, q_path
    # a full-scale groundtruth is wrong for ANY subset (its neighbor ids
    # point at rows outside the shrunk base) — always regenerate
    ds.pop("groundtruth_neighbors_file", None)
    ds["subset_size"] = target_rows
    ds["name"] = f"{ds['name']}-scaled-{target_rows}"
    return conf


def run_benchmark(
    config: Dict[str, Any],
    k: int = 10,
    batch_size: Optional[int] = None,
    search_iters: int = 3,
    out_path: Optional[str] = None,
    res: Optional[Resources] = None,
) -> List[Dict[str, Any]]:
    """Run every index/search-param combo in a raft-ann-bench-shaped config.

    ``config``: {"dataset": {...}, "index": [{"name", "algo",
    "build_param", "search_params": [...]}]}. Returns result rows
    (one per search param set): name, algo, build_time, qps, recall, k…
    """
    res = res or Resources()
    ds = DatasetSpec(**config["dataset"])
    base, queries, gt = ds.load()
    metric = _METRIC_MAP.get(ds.distance, ds.distance)
    if gt is None:
        gt = generate_groundtruth(base, queries, k, metric, res=res)
    gt = gt[:, :k]
    # one copy to the device for the whole run, outside every timing;
    # host-library algos get the numpy copy, so their timed loops pay no
    # copy back. A baselines-only config copies nothing.
    queries_host = np.asarray(queries)
    queries = (timing.prepare(queries_host, res.device)
               if any(not ALGOS[c["algo"]].wants_host_queries
                      for c in config["index"]) else queries_host)

    results = []
    for index_conf in config["index"]:
        algo = ALGOS[index_conf["algo"]]()
        t0 = time.perf_counter()
        index = algo.build(base, index_conf.get("build_param", {}), metric,
                           res)
        _block_on_index(index)
        build_time = time.perf_counter() - t0
        q = queries_host if algo.wants_host_queries else queries
        for sp in index_conf.get("search_params", [{}]):
            row = _run_search(algo, index, q, k, sp, gt, batch_size,
                              search_iters, res)
            row.update({"name": index_conf.get("name", index_conf["algo"]),
                        "algo": index_conf["algo"],
                        "dataset": ds.name,
                        "build_time": round(build_time, 3),
                        "search_param": sp})
            results.append(row)
            if out_path:
                with open(out_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
    return results


def _block_on_index(index) -> None:
    """Wait for the build's device work: every tensor the index holds."""
    timing.fence_index(index)


def _run_search(algo, index, queries, k, search_param, gt, batch_size,
                iters, res):
    """Times both benchmark modes of the reference harness:

    - **throughput**: every batch is launched before any is awaited, so
      the batches in flight keep the card fed (the reference's
      thread-pool pipelining; CUDA's stream is the queue) → ``qps``.
    - **latency**: batches are serialised by a data dependency (each
      batch's input depends on the previous output), one fence a round →
      ``latency_ms`` (mean per-batch time) and ``qps_latency_mode``.
    """
    nq = len(queries)
    bs = batch_size or nq
    n_batches = max(-(-nq // bs), 1)

    def dispatch(s, q_batch=None):
        qb = queries[s : s + bs] if q_batch is None else q_batch
        return algo.search(index, qb, k, search_param, res)

    # warmup + correctness (also compiles both shapes: full + tail batch)
    outs = [dispatch(s) for s in range(0, nq, bs)]
    timing.fence(outs)
    idx = np.concatenate([i.cpu().numpy() if isinstance(i, torch.Tensor)
                          else np.asarray(i) for _, i in outs])
    recall = float(neighborhood_recall(idx[:, :k], gt))

    # throughput mode: dispatch-ahead, one fence per pass
    thr_dt = timing.time_dispatches(
        lambda: [dispatch(s) for s in range(0, nq, bs)],
        iters=iters, warmup=0)

    # latency mode: batches serialised by a data dependency; the tail
    # batch is timed separately when nq % bs != 0
    def chained_latency(q0):
        return timing.time_latency_chained(
            lambda qq: timing.chain_perturb(q0, dispatch(0, q_batch=qq)),
            q0, iters=max(iters * n_batches, 4))

    n_full = nq // bs
    lat_dt = chained_latency(queries[:bs]) * n_full if n_full else 0.0
    tail = nq % bs
    if tail:
        lat_dt += chained_latency(queries[nq - tail:])

    row = {"k": k, "batch_size": bs, "qps": round(nq / thr_dt, 1),
           "qps_latency_mode": round(nq / lat_dt, 1),
           "latency_ms": round(1000.0 * lat_dt / n_batches, 3),
           "recall": round(recall, 4)}
    return row
