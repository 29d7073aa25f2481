#!/usr/bin/env python3
"""Drive raft_tpu_torch's main path on one CUDA card and check every kernel.

    python3 chip_smoke.py [--seed N] [--parent TREE]

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``. At SIFT-1M's shape (1,000,000 × 128 float32 rows made from the
seed, 10,000 queries, k=10, L2) it

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the eight CUDA kernels from ``raft_tpu_torch/csrc`` (timed), and
   prints ptxas's registers, spills and static shared memory of the
   kernels of ``fused_l2_topk``, ``fused_ivf_topk``, ``select_k``,
   ``fused_pq_topk``, ``fused_cagra_topk``, ``fused_l2_argmin``,
   ``ivf_scan`` and ``ring_shift``;
3. runs exact search (``brute_force.build`` + ``search``), the main path's
   first part, with the launch counts set to 0 just before and read just
   after; its result is the ground truth;
4. runs IVF-Flat (``ivf_flat.build`` with 1024 lists + ``search`` with 32
   probes) the same way and checks recall@10 >= 0.90 against phase 3; then
   builds the index again and checks that every part of it is bitwise equal
   (the builds' sums run in row order on the card);
5. runs IVF-PQ at the repository's ``raft_ivf_pq.d64b8n1024`` configuration
   (1024 lists, pq_dim 64, pq_bits 8, 20 k-means iterations): the build;
   search with 32 probes in the decoded-cache regime the card's own memory
   picks (``fused_ivf_topk`` over a bf16 cache); the same search in the LUT
   regime, under a stated device memory that holds the packed codes but not
   the cache (``fused_pq_topk``); and 64 probes with k·2 candidates refined
   exactly. Recall@10 >= 0.80 in both regimes and >= 0.95 after refine (the
   probes double until a floor is met; no floor is lowered);
5b. runs CAGRA at the repository's ``raft_cagra.d32`` configuration
   (graph_degree 32, intermediate_graph_degree 64, NN-descent with 20
   iterations, then ``optimize``): the build, split into NN-descent and
   optimize; search with itopk 64, width 1 and the auto plan through
   ``fused_cagra_topk`` (recall@10 >= 0.90, itopk doubling up to 512 until
   met); and the glue engine (``scan_mode="xla"``) on the first 1,000
   queries, held against the kernel path's result;
5c. runs Lloyd k-means (``cluster.kmeans.fit``: 1024 clusters, k-means++
   init, 20 iterations at most, tol 1e-4) on the dataset, its init and its
   Lloyd loop timed apart, every E-step through ``fused_l2_argmin`` (one
   launch per iteration plus the final assignment); then ``predict`` and
   ``cluster_cost``. The final inertia must not exceed the k-means++
   centres' cost, and ``predict``'s labels must equal ``fused_l2_topk``'s
   nearest centre away from near-ties. ``fused_l2_nn_argmin`` is timed at
   ``raft_tpu/bench/prims.py``'s shape (100,000 × 1,024 × 128);
5d. runs the requests the fused IVF kernels decline, through ``ivf_scan``:
   IVF-Flat (phase 4's index) and IVF-PQ (phase 5's, cache regime) with a
   filter that removes 10% of the row ids, drawn from the seed (recall@10
   against the port's filtered brute force >= 0.90 and >= 0.80; no removed
   id returned), and an inner-product IVF-Flat index at
   raft-ann-bench's ``glove-100-inner`` shape (1,183,514 × 100 unit-norm
   rows from the seed, 10,000 queries, 1024 lists; recall@10 >= 0.90
   against exact inner-product search). Probes double until a floor is met;
5e. runs the sharded path (``raft_tpu_torch.parallel``) on phase 3's rows
   over 4 logical ranks on the card (250,000 rows a rank, the queries
   replicated): ``sharded.knn`` with the allgather, tree and ring merges
   (bitwise equal; ids equal to phase 3's away from near-ties; the ring's
   hops through ``ring_shift``, (size-1) · source devices launches a call:
   3 here); a sharded
   IVF-Flat build (1024 lists a rank) searched at 32 probes with the ring
   merge (recall@10 >= 0.90, bitwise equal to allgather); a sharded IVF-PQ
   build at ``raft_ivf_pq.d64b8n1024`` a rank in the cache regime, the same
   way (recall@10 >= 0.80); and ``sharded.kmeans_fit`` (1024 clusters, 20
   iterations), whose inertia must be below its initial centres' cost,
   and whose first iteration, run alone, must equal a float64 M-step over
   all the rows within 1e-5 of the largest centre coordinate;
6. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gave it, and times kernel, plain version and, where
   one PyTorch call computes the same function, that call
   (``fused_l2_topk`` also over one 250,000-row shard of phase 5e;
   ``fused_l2_topk`` and ``fused_l2_argmin`` with their fp32 bound and the
   3xTF32 tensor-core bound; ``fused_pq_topk`` at the LUT phase's probes
   and at refine's (64 probes, k·2), with the design figure
   ``bound_smem_ms``, its lookups at 32 shared-memory reads a clock an SM;
   ``fused_cagra_topk`` bitwise, with the design figure ``gather_ms``, the
   scored rows at 3.35 TB/s; ``fused_ivf_topk``, ``fused_pq_topk`` and
   ``ivf_scan`` also bitwise equal over two runs; the rows of the planned
   kernels carry the route and plan that ran; ``select_k`` at every shape
   the main path launched it, by the launch counts' ``SELECT_K_SHAPES``: the
   coarse probe selection, and the per-query merges with their ids, their
   rows rebuilt as the fused kernels write them, bitwise against the plain
   version, with ``torch.topk`` as the library yardstick; ``ring_shift`` a
   hop of all ranks, from CUDA graphs and eagerly, against one
   ``torch._foreach_copy_`` of the hop and a ``copy_`` a block). With
   ``--parent TREE`` (a
   source tree, such as the parent commit unpacked under ``build/``) it
   saves the inputs of the planned kernels', ``select_k``'s and
   ``ring_shift``'s calls and times that tree's
   kernels and this tree's on them in turns (parent, this, this, parent,
   one ``raft_tpu_torch/bench/kernel_ab.py`` process each): the rows get
   ``parent_ms`` and ``ab_ms``, null without the option;
6b. serves each index above through ``raft_tpu_torch.serving.Engine``
   (``max_batch=64, max_wait_us=2000, max_inflight=2, warm_ks=(10,)``):
   brute force, IVF-Flat, IVF-PQ in the cache regime and in the LUT
   regime (under the LUT phase's Resources) and CAGRA, each at the probes
   or itopk its phase settled on, under two closed-loop loads (8, then 64
   submitter threads, each of the first 3,000 queries once, one a request,
   k=10;
   ``raft_tpu_torch/bench/serve_load.py``). A ``serving`` line per family
   and load: QPS, p50/p99 latency, mean batch size and bucket histogram,
   host-return and CUDA-event device ms per batch, the device busy share,
   the first request's latency after ``start()``, kernel builds after
   ``start()`` (asserted 0), recall@10 against phase 3 (the phases'
   floors asserted; brute force held to phase 3's rows away from
   near-ties), mismatches against ``solo_reference`` on 256 sampled
   requests (asserted 0), the explain briefs' routes (a batch must name
   the CUDA route) and, for the first load, a scrape of
   ``serve_metrics(0)`` holding the serving families. Then each kernel of
   the served path against its plain version on the inputs that path
   gives it at buckets 8, 16, 32 and 64 (``fused_l2_topk``; the coarse
   ``select_k``; ``fused_ivf_topk`` of IVF-Flat and of the PQ cache;
   ``fused_pq_topk``; ``fused_cagra_topk`` bitwise, with the served
   searcher's seeds); at 8 and 64 also timed, a row of the kernels line
   with its launches at that bucket in the loads;
6c. saves every index above and restores it onto the card
   (``serialize``/``deserialize``, files under ``build/`` deleted at the
   end): brute force, IVF-Flat, IVF-PQ (searched in the cache regime, its
   cache decoded again on the card, and in the LUT regime) and CAGRA (with
   its dataset and with ``dataset=``), each restored search bitwise equal
   to the saved index's and launching its kernel (a ``persist`` line a
   family: file bytes, save, load and load-to-first-result seconds); the
   hnswlib export of phase 5b's graph, ``hnsw.search`` bitwise
   ``cagra.search`` at ``itopk_size=max(ef, k)`` and its C++ engine on
   1,000 queries (the native library asserted built and used); phase 5e's
   sharded IVF-Flat and IVF-PQ (cache) checkpoints: ``verify_checkpoint``,
   the strict restore's ring search and a full elastic restore bitwise
   equal to the saved index's ring and allgather searches; a damaged copy
   (one rank file deleted: the strict restore names it; another truncated:
   ``verify_checkpoint`` names both) restored with ``allow_partial=True``,
   its coverage the surviving ranks' rows over all, its search bitwise the
   allgather merge of the surviving ranks; and that degraded restore
   served through ``serving.Engine(elastic_searcher(...))`` to 8
   submitters on 2,000 queries (0 builds after ``start()``, coverage < 1,
   0 ``solo_reference`` mismatches on 256 samples), then ``swap_index`` to
   the full restore (the coverage transition, recall@10 at phase 4's
   floor). Every restored path's kernels (``fused_l2_topk``,
   ``fused_ivf_topk``, ``fused_pq_topk``, ``fused_cagra_topk``,
   ``select_k``) must launch, counted per step; the kernels line gains
   ``persist_launches``. Each 6c line carries the card's name and limit;
6d. narrow data and the bf16 fast scan: IVF-Flat over uint8 rows (phase
   3's rows and queries mapped affinely onto 0-255 and rounded, SIFT's and
   BIGANN's range), int8 rows at SPACEV-1B's shape (1,000,000 × 100,
   ``datagen`` rows mapped onto -127..127) and phase 3's rows cast to
   fp16, each built with 1024 lists and searched (10,000 queries, k=10,
   ``fused_ivf_topk``) at 32 probes, doubling until recall@10 against the
   exact search of the rows as f32 is >= 0.90; a twin index, the same
   lists cast to f32, searched alike and asserted bitwise equal; for uint8
   the filtered search (phase 5d's filter, ``ivf_scan``) bitwise its
   twin's with no removed id. The fast scan: brute force
   (``scan_dtype="bfloat16"``, ``refine_ratio=4``) recall@10 >= 0.99
   against phase 3, its distances at agreeing ids within rtol 1e-5 (atol
   1e-6·max‖x‖²) of the exact fp32 distances of those ids and within
   phase 3's tolerance of phase 3's; IVF-Flat at phase 4's probes within
   0.01 of phase 4's recall; CAGRA at itopk 64 on 1,000 queries >= 0.90.
   Then the uint8 index served to 8 submitters on 2,000 queries (float32
   batches; 0 builds after ``start()``, 0 ``solo_reference`` mismatches
   on 256 samples). Each
   narrow kernel (``fused_ivf_topk`` for uint8, int8 and fp16,
   ``ivf_scan`` for uint8) is held against its plain version, bitwise
   against the f32 kernel on the twin's lists, and timed beside both (a
   row of the kernels line; launches from 6d's steps). Lines ``narrow``,
   ``narrow_filtered``, ``fast_scan`` and ``narrow_serving``, each with
   the card's name and limit;
6e. the write path and the tiers (``raft_tpu_torch/bench/write_tiers.py``;
   every file under ``build/chip_smoke_6e``, deleted at the end): phase
   4's IVF-Flat as the base of a ``MutableIvf`` takes 20,000 adds, 10,000
   upserts and 10,000 deletes in calls of 64 (acknowledged rows/s, ack
   p50/p99), is searched against the exact search of its live set (recall
   >= 0.90, no deleted id, every distance its id's live row's), compacted
   once (the live ids equal, recall >= 0.90), checkpointed and reopened
   (bitwise), and a child writer is killed with SIGKILL mid-stream and
   mid-compaction (recovery bitwise a never-crashed writer); an
   inner-product IVF-Flat base (``ivf_scan``) and an IVF-PQ base in the
   LUT regime (``fused_pq_topk``) with writes; the writer served to 8
   submitters while a writer thread streams and a background compactor
   publishes (the generation +1 a compaction; 0 of 256 mismatches, 0
   builds); phase 5's IVF-PQ demoted to a 512-slot arena over pinned host
   memory (its bytes as ``solve_host_tier`` predicts), the queries in
   chunks of 16 each bitwise the resident cache search, served at
   ``max_batch=16`` with and without the prefetcher, saved and loaded
   (bitwise); phase 3's rows as an fbin, IVF-Flat and IVF-PQ built from it
   (every id once; recall >= 0.90 and 0.80 at 32 probes). Lines
   ``mutable``, ``mutable_kill9``, ``mutable_variants``,
   ``mutable_serving``, ``tiered``, ``ooc``, each with the card's name and
   limit; two more rows in the kernels line (``fused_ivf_topk`` over the
   arena slabs at bucket 16, bitwise its call over the lists; ``select_k``
   at the mutable merge's shape, each with the launches of its own 6e
   step at that shape) and 6e's launches on every row, counted around the
   main-path calls alone (the references and checks run outside);
6f. measured dispatch and the adaptive planner
   (``raft_tpu_torch/bench/planning.py``): the committed
   ``raft_tpu_torch/artifacts/PALLAS_PROBE_cuda.json`` verdicts printed
   beside their fused and unfused ms (``dispatch_probe``); each family's
   ``scan_mode="auto"`` reason as its verdict implies and its result
   bitwise the forced route's (``dispatch_routing``; phase 2 already
   asserts that every verdict routes ``auto`` to the fused kernel, which
   phases 3-6e count); a padded ``select_k`` bitwise the unpadded one
   (``dispatch_padding``); ``planner.sweep`` over brute force, IVF-Flat,
   IVF-PQ, CAGRA and tiered IVF-PQ at phase 3's rows, k 10, buckets 8-64,
   written to ``build/chip_smoke_6f/PARETO_cuda.json`` (``sweep`` lines;
   every ``roofline_min_ms`` <= ``predicted_ms``); the swept IVF-Flat and
   IVF-PQ served behind ``EngineConfig(planner=...)`` to 8 submitters,
   half the requests with a tight ``deadline_ms`` (``planner_serving``:
   0 builds after ``start()``, 0 of 256 mismatches at each request's
   params, none below the recall floor, the choices by reason); its loads'
   launches on every row (``planning_launches``);
6g. the replica fleet (``raft_tpu_torch/bench/fleet_load.py``): three
   replicas of phase 4's IVF-Flat (quorum 2) behind ``serving.Fleet``
   under 8 and then 64 closed-loop submitters, a breaker tripped and
   re-admitted by the router's probe in the first load, a rolling swap to
   16 probes and a replica killed in the second (``fleet``: every request
   one outcome, counters and spans reconciled, 0 of 256 sampled rows off
   ``solo_reference``, 0 builds after ``start()``, the healthy count never
   below quorum, the first load's recall@10 equal to 6b's IVF-Flat at 8
   submitters); then two ``replica_main`` processes on the card at the
   seeded 1M × 128 IVF-Flat spec (``remote_fleet``: 1,000 queries bitwise
   this process's search of the same spec, one child SIGKILLed mid-load
   with exact accounting, a third spawned by ``Autoscaler.on_fast_burn``
   and retired through the drain handshake, the survivor swapped to the
   brute-force spec and bitwise this process's brute force, every child's
   scrape with 0 builds and the fused route; child start to
   ``REPLICA_READY`` seconds, RPC round trips, QPS); its in-process loads'
   launches on every row (``fleet_launches``); every 6g line carries the
   card's name and power limit;
6h. the rest of the sharded path (``raft_tpu_torch/bench/sharded_rest.py``)
   over phase 5e's four ranks: ``sharded_cagra`` (built in a thread a rank
   and rank after rank, bitwise equal; the three merges bitwise equal;
   recall@10 at phase 5b's less 0.02; the bf16 fast scan's recall;
   ``fused_cagra_topk`` on every rank), ``sharded_from_file`` (IVF-Flat and
   IVF-PQ from the fbin phase 6e wrote: every id once, recall 0.90 / 0.80,
   ``fused_ivf_topk`` on every rank), ``sharded_pod`` (one shared quantizer
   at 1,024 lists, ``fused_pq_topk`` on every rank), ``distributed``
   (``init_distributed`` over NCCL, one process of four ranks: phase 5e's
   IVF-Flat bitwise its ``init_comms`` search, the comms self-tests) and
   ``metrics`` (brute force for L1, Linf, correlation and Minkowski p = 3
   through ``select_k``, each against its plain route); its main-path
   launches on every row (``sharded_launches``, asserted above 0 for
   ``fused_cagra_topk``, ``fused_ivf_topk``, ``fused_pq_topk``,
   ``select_k`` and ``ring_shift``); every 6h line carries the card's name
   and power limit;
6i. the breadth modules (``raft_tpu_torch/bench/breadth.py``, ~2 min):
   ``ball_cover`` (1,000,000 haversine points and 1,000,000 3-D points in
   1,000 seeded clusters, √n landmarks, 10,000 queries, k = 32: ``knn``
   against ``brute_force.knn``, ``eps_nn`` against ``eps_neighbors``;
   build s, QPS, pass 2's lists and query chunk), ``eps_neighbors``
   (10,000 × 100,000 × 128, degrees against float64), ``gram`` (the four
   kernels at 10,000 × 10,000 × 128 and a 1% CSR, against float64 within
   1e-5), ``linalg`` (``rsvd`` of the rows, the 128 × 128 covariance's
   decompositions, ``lanczos`` over the normalised 16-NN graph of 100,000
   rows beside ``eigsh``, two runs of the scatter sums bitwise),
   ``stats`` (moments and histogram of the rows against float64, the
   silhouette of 100 k-means clusters, trustworthiness, the contingency
   scores of phase 5c's labels) and ``quantize`` (int8 codes searched by
   IVF-Flat, bitwise its f32 twin, and brute force); ``breadth_launches``
   on every row, asserted above 0 for ``fused_l2_topk``, ``fused_ivf_topk``
   and ``fused_l2_argmin``; every 6i line carries the card's name and power
   limit;
6j. the graph layer (``raft_tpu_torch/bench/graph.py``, ~3 min):
   ``single_linkage`` (phase 3's rows, ``connectivity_k`` 15, 1,000
   clusters: the kNN graph through ``fused_l2_topk`` at 1M × 1M × 128,
   k = 16, Borůvka, the host extraction and the labelling timed apart; the
   forest's weight against scipy's float64 MST, the clusters against the
   components of the graph below the cut, ``mst`` bitwise run to run and
   card to CPU), ``cross_component_nn`` over the same rows coloured by
   those clusters (200 rows against float64; ``connect_components_edges``
   joins the graph into one component), ``sparse`` (a 20,000 × 131,072
   TF-IDF corpus and 2,000 queries: ``knn`` at k = 10 in cosine, Jaccard
   and expanded L2 through ``select_k``, 500 sampled queries against
   scipy's float64 products;
   every sparse metric on a 32 × 1,000 block against float64), ``spectral``
   (10 planted clusters of 2,000 rows, their 16-NN graph joined by
   ``connect_components_edges``: ``partition`` at its defaults and with 24
   eigenvectors and ``modularity_maximization``, each one's Ritz values
   against the same Lanczos in float64 from its start vector and its
   labels against k-means' final centres, its contingency against the
   planted clusters recorded beside 0.99, the planted cut against
   float64; ``lanczos_smallest`` of a 100,000-row
   normalised Laplacian beside ``eigsh``), ``lap`` (the auction on a
   1,000 × 1,000 uniform cost, within n·eps of scipy's optimum, bitwise run
   to run and card to CPU) and ``labels`` (``make_monotonic`` and
   ``merge_labels`` of the 1M labels against numpy; the resources pool,
   ``auto_sync_resources``, ``debug.checked``); rows of the kernels line
   for ``fused_l2_topk`` at 1M × 1M, k = 16 (held and timed on 10,000 of
   the queries), ``fused_l2_argmin`` at the spectral E-step's 20,000 × 10 ×
   d 10 and 24, and ``select_k`` at [2,000 × 20,000], k = 10, each against
   its plain version; ``graph_launches`` on every row, asserted above 0
   for ``fused_l2_topk``, ``select_k`` and ``fused_l2_argmin``; every 6j
   line carries the card's name and power limit;
6k. the analysis layer (``raft_tpu_torch/bench/audit.py``, ~30 s):
   ``analysis_smem`` (each kernel's Python shared-memory accountant equal
   to the ``rtt_*`` export of its built library at its three
   planner-domain shapes; ptxas' static shared memory plus the plan's
   dynamic bytes within the card's opt-in limit, registers × threads
   within 65,536, spills recorded, the plans' alignment),
   ``analysis_workspace`` (the twelve canonical entries of
   ``analysis.memory_audit`` on the indexes above: the caching allocator's
   peak against the 2 GiB budget, B001, and the planner's prediction, C001,
   beside the host's fake-tensor figure), ``analysis_merges`` (the three
   merges' received bytes at 4 ranks equal ``solve_merge_bytes``) and
   ``analysis_cli`` (``python -m raft_tpu_torch.analysis --threads --flow
   --kernels --artifacts``, exit 0); a finding outside the baseline fails
   the phase; ``analysis_launches`` on every row;
7. prints one ``{"kernels": [...]}`` line (the eight kernels;
   ``fused_l2_topk``, ``fused_ivf_topk`` and ``fused_pq_topk`` at two
   shapes, ``ivf_scan`` at three, ``select_k`` at each of its main-path
   shapes; the served kernels at buckets 8 and 64), then, as the last
   line, ``{"ok": true, "device": {...}}``.

Every phase prints one JSON line. Any failed check raises, and the script
then exits non-zero without the last line. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 10_000, 10
N_LISTS, N_PROBES, RECALL_FLOOR = 1024, 32, 0.90
# raft_tpu/bench/conf/sift-128-euclidean.json, raft_ivf_pq.d64b8n1024
PQ_DIM, PQ_BITS, PQ_RECALL_FLOOR, REFINE_PROBES, REFINE_RECALL_FLOOR = (
    64, 8, 0.80, 64, 0.95)
# raft_tpu/bench/conf/sift-128-euclidean.json:118-143, raft_cagra.d32
CAGRA_DEGREE, CAGRA_INTER, CAGRA_ITOPK, CAGRA_MAX_ITOPK = 32, 64, 64, 512
CAGRA_RECALL_FLOOR, CAGRA_GLUE_QUERIES = 0.90, 1000
# Lloyd k-means: the IVF build's cluster count and iteration count
# (raft_tpu_torch/neighbors/ivf_flat.py, IndexParams.kmeans_n_iters)
KM_CLUSTERS, KM_ITERS, KM_TOL = 1024, 20, 1e-4
# raft_tpu/bench/prims.py:47, bench_fused_l2_nn
NN_ROWS = 100_000
# the filtered requests drop this share of the row ids
FILTER_REMOVED = 0.10
# raft-ann-bench glove-100-inner: rows, dimension, inner product
IP_ROWS, IP_DIM = 1_183_514, 100
# the sharded path: logical ranks on the one card, the merge engines
N_RANKS, MERGE_ENGINES = 4, ("allgather", "tree", "ring")
# the serving phase: closed-loop submitter threads, the sampled requests
# held against solo_reference, the buckets each served kernel is held
# against its plain version at (every warmed one), and those that also
# get a timed row in the kernels line
SERVE_LOADS, SERVE_SAMPLE = (8, 64), 256
#: the requests of each serving load (6b, and 6g's in-process fleet): the
#: first queries, with their ground truth
SERVE_QUERIES = 3000
SERVE_CHECK_BUCKETS, SERVE_ROW_BUCKETS = (8, 16, 32, 64), (8, 64)
SERVE_KERNELS = ("fused_l2_topk", "select_k", "fused_ivf_topk",
                 "fused_pq_topk", "fused_cagra_topk")
#: the persistence phase: queries served by the degraded restore, and the
#: kernels its restored searches must launch
SERVE_DEGRADED_QUERIES = 2000
PERSIST_KERNELS = ("fused_l2_topk", "fused_ivf_topk", "fused_pq_topk",
                   "fused_cagra_topk", "select_k")
SERVE_FAMILIES = ("raft_tpu_serving_requests_total",
                  "raft_tpu_serving_batches_total",
                  "raft_tpu_serving_total_seconds",
                  "raft_tpu_dispatch_total", "raft_tpu_kernel_build_total")
#: phase 6d: SPACEV-1B's row width (int8), the fast scan's refine ratio
#: and its recall floors (brute force against phase 3; IVF-Flat within this
#: much of phase 4's recall)
SPACEV_DIM, FAST_REFINE, FAST_BF_FLOOR, FAST_IVF_SLACK = 100, 4, 0.99, 0.01
#: the TPU kernel each CUDA kernel replaces
REPLACES = {name: f"raft_tpu/ops/pallas_kernels.py:{line}" for name, line in (
    ("fused_l2_argmin", 88), ("ivf_scan", 328), ("select_k", 428),
    ("fused_l2_topk", 610), ("fused_ivf_topk", 798), ("fused_pq_topk", 989),
    ("fused_cagra_topk", 1368), ("ring_shift", 1469))}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn):
    """(fn(), host seconds), the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (after one warm-up run
    unless the caller has just run it)."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_trees(inputs: Path, trees) -> list:
    """kernel_ab.py's times of the saved calls, one process per tree, in the
    order given."""
    script = Path(__file__).resolve().parent / "raft_tpu_torch" / "bench" \
        / "kernel_ab.py"
    runs = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, str(script), str(inputs)], capture_output=True,
            text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(tree)})
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_ab.py on {tree} exited "
                               f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return runs


def bitwise_equal(a, b) -> bool:
    """Two (distances, ids) results equal bit for bit."""
    import torch

    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def persistence_phase(*, smi, dev, queries, gt_i, dataset, bf, flat,
                      flat_probes, pq_index, pq_probes, card_res, lut_probes,
                      lut_res, cg_index, cg_itopk, sf_index, sf_probes,
                      sp_index, sp_probes, ring_comms, launch_counts,
                      root: Path) -> dict:
    """Phase 6c: every ported index saved, restored onto the card and
    searched, its results held bitwise to the index's before saving. Files
    go under ``root`` and are deleted at the end. Returns the phase's
    launch counts by kernel (each step's counts set to 0 just before it
    and read just after)."""
    import numpy as np
    import torch

    from raft_tpu_torch import native, serving
    from raft_tpu_torch.bench.serve_load import BatchSink, closed_loop, \
        summarize
    from raft_tpu_torch.core.errors import IntegrityError
    from raft_tpu_torch.neighbors import brute_force, cagra, hnsw, ivf_flat, \
        ivf_pq
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.parallel import comms as tcomms
    from raft_tpu_torch.parallel import sharded
    from raft_tpu_torch.stats import neighborhood_recall

    # the host C++ library is compiled here, off every timed step below
    built, native_build_s = timed(native.ensure_built)
    if not built:
        raise AssertionError("the native C++ library did not build")
    emit({"phase": "native_build", "card": smi, "seconds": native_build_s,
          "library": str(native.library_path())})

    totals = {name: 0 for name in gk.LAUNCHES}

    def counted(fn):
        """fn() with the launch counts set to 0 just before and read (and
        added to the phase's totals) just after."""
        gk.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches = launch_counts()
        for name in totals:
            totals[name] += launches[name]
        return out, launches

    def sync_clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def round_trip(family, mod, index, searches, load_kw=None, save_kw=None):
        """Save, restore onto the card, search: each search bitwise equal
        to the same search of ``index`` before saving; the first restored
        search's launches must show ``kernel``."""
        before = [search(index) for search, _ in searches]
        path = root / f"{family}.idx"
        _, save_s = timed(lambda: mod.serialize(index, path, **(save_kw or {})))
        n_bytes = path.stat().st_size
        t0 = sync_clock()
        restored = mod.deserialize(path, **(load_kw or {}))
        t_load = sync_clock()
        results = []
        for (search, kernel), want in zip(searches, before):
            got, launches = counted(lambda: search(restored))
            results.append((got, launches))
            if len(results) == 1:
                first_s = time.perf_counter() - t0
            if not bitwise_equal(got, want):
                raise AssertionError(f"persist {family}: the restored search "
                                     "differs from the saved index's")
            if launches[kernel] < 1:
                raise AssertionError(f"persist {family}: the restored search "
                                     f"launched no {kernel}")
        if restored.device != dev:
            raise AssertionError(f"persist {family}: restored onto "
                                 f"{restored.device}")
        path.unlink()
        emit({"phase": "persist", "family": family, "card": smi,
              "file_bytes": n_bytes, "save_seconds": save_s,
              "load_seconds": t_load - t0, "load_to_first_result_seconds":
              first_s, "bitwise_equal": True,
              "launches": [launches for _, launches in results]})
        return restored

    root.mkdir(parents=True, exist_ok=True)
    try:
        # ---- 1. single-device round trips
        round_trip("brute_force", brute_force, bf,
                   [(lambda i: brute_force.search(i, queries, K),
                     "fused_l2_topk")])
        round_trip("ivf_flat", ivf_flat, flat,
                   [(lambda i: ivf_flat.search(
                       i, queries, K, ivf_flat.SearchParams(
                           n_probes=flat_probes)), "fused_ivf_topk")])
        # the file holds no decoded cache: the cache regime decodes it again
        # on the card, the LUT regime scans the packed codes
        round_trip("ivf_pq", ivf_pq, pq_index,
                   [(lambda i: ivf_pq.search(
                       i, queries, K, ivf_pq.SearchParams(n_probes=pq_probes),
                       res=card_res), "fused_ivf_topk"),
                    (lambda i: ivf_pq.search(
                        i, queries, K, ivf_pq.SearchParams(
                            n_probes=lut_probes), res=lut_res),
                     "fused_pq_topk")])
        cg_search = [(lambda i: cagra.search(
            i, queries, K, cagra.SearchParams(itopk_size=cg_itopk,
                                              search_width=1)),
            "fused_cagra_topk")]
        round_trip("cagra", cagra, cg_index, cg_search)
        round_trip("cagra_without_dataset", cagra, cg_index, cg_search,
                   load_kw={"dataset": dataset},
                   save_kw={"include_dataset": False})

        # ---- 2. HNSW: the export, the CAGRA engine bitwise, the C++ engine
        native.CALLS.clear()
        hpath = str(root / "cagra.hnsw")
        _, export_s = timed(lambda: hnsw.from_cagra(cg_index, hpath))
        h_bytes = os.path.getsize(hpath)
        hidx, hload_s = timed(lambda: hnsw.load(hpath))
        os.remove(hpath)
        want = cagra.search(cg_index, queries, K,
                            cagra.SearchParams(itopk_size=max(cg_itopk, K)))
        got, h_launches = counted(lambda: hnsw.search(hidx, queries, K,
                                                      ef=cg_itopk))
        if not bitwise_equal(got, want):
            raise AssertionError("hnsw.search differs from cagra.search at "
                                 "itopk_size=max(ef, k)")
        if h_launches["fused_cagra_topk"] < 1:
            raise AssertionError("hnsw.search launched no fused_cagra_topk")
        n_cpu = CAGRA_GLUE_QUERIES
        (cd, ci), cpu_s = timed(lambda: hnsw.search(
            hidx, queries[:n_cpu], K, ef=cg_itopk, engine="cpu"))
        cpu_recall = float(neighborhood_recall(ci.to(dev), gt_i[:n_cpu]))
        if not (native.available() and native.CALLS["hnswlib_write"] == 1
                and native.CALLS["graph_greedy_search"] == 1):
            raise AssertionError(f"the native C++ library was not built and "
                                 f"used: {dict(native.CALLS)}")
        if cd.shape != (n_cpu, K) or not bool(torch.isfinite(cd).all()):
            raise AssertionError("hnsw cpu engine: distances not finite")
        emit({"phase": "persist_hnsw", "card": smi, "file_bytes": h_bytes,
              "export_seconds": export_s, "load_seconds": hload_s,
              "ef": cg_itopk, "xla_bitwise_equal_cagra": True,
              "cpu_queries": n_cpu, "cpu_seconds": cpu_s,
              "cpu_recall_at_10": cpu_recall,
              "native_library": str(native.library_path()),
              "native_calls": dict(native.CALLS), "launches": h_launches})
        del hidx

        # ---- 3. sharded checkpoints: strict restore (ring) and a full
        # elastic restore (allgather), bitwise the index before saving
        ckpt = {}
        for kind, index, fam, params in (
                ("ivf_flat", sf_index, "ivf_flat",
                 ivf_flat.SearchParams(n_probes=sf_probes)),
                ("ivf_pq", sp_index, "ivf_pq",
                 ivf_pq.SearchParams(n_probes=sp_probes))):
            search = getattr(sharded, f"search_{fam}")
            ring = search(index, queries, K, params, merge_mode="ring")
            gather = search(index, queries, K, params, merge_mode="allgather")
            prefix = str(root / f"sharded_{kind}" / "index")
            os.makedirs(os.path.dirname(prefix))
            _, save_s = timed(lambda: getattr(sharded, f"serialize_{fam}")(
                index, prefix))
            n_bytes = sum(os.path.getsize(f) for f in
                          glob.glob(prefix + ".*"))
            report, verify_s = timed(lambda: sharded.verify_checkpoint(prefix))
            if not report["ok"]:
                raise AssertionError(f"sharded {kind}: verify {report}")
            t0 = sync_clock()
            strict = getattr(sharded, f"deserialize_{fam}")(prefix,
                                                            ring_comms)
            strict_s = sync_clock() - t0
            got, s_launches = counted(lambda: search(
                strict, queries, K, params, merge_mode="ring"))
            if not bitwise_equal(got, ring):
                raise AssertionError(f"sharded {kind}: the strict restore's "
                                     "ring search differs")
            t0 = sync_clock()
            full = getattr(sharded, f"deserialize_{fam}_elastic")(prefix)
            elastic_s = sync_clock() - t0
            got, e_launches = counted(lambda: full.search(queries, K, params))
            if not bitwise_equal(got, gather) or got.coverage != 1.0:
                raise AssertionError(f"sharded {kind}: the full elastic "
                                     "restore differs from allgather")
            kernel = "fused_ivf_topk"
            if e_launches[kernel] < N_RANKS or e_launches["select_k"] < 1 \
                    or s_launches["ring_shift"] < 1:
                raise AssertionError(f"sharded {kind}: launches {s_launches}"
                                     f" / {e_launches}")
            emit({"phase": "persist_sharded", "kind": kind, "card": smi,
                  "ranks": N_RANKS, "file_bytes": n_bytes,
                  "save_seconds": save_s, "verify_seconds": verify_s,
                  "strict_load_seconds": strict_s,
                  "elastic_load_seconds": elastic_s,
                  "strict_ring_bitwise_equal": True,
                  "elastic_bitwise_equal_allgather": True,
                  "pads": sorted({i.list_indices.shape[1]
                                  for i in index.indexes}),
                  "restored_pads": sorted({i.list_indices.shape[1]
                                           for i in strict.indexes}),
                  "strict_launches": s_launches,
                  "elastic_launches": e_launches})
            ckpt[kind] = (prefix, full, gather)
            del strict
            if kind == "ivf_pq":
                shutil.rmtree(os.path.dirname(prefix))
                del full

        # ---- 4. a damaged copy of the IVF-Flat checkpoint
        prefix, full, gather = ckpt["ivf_flat"]
        params = ivf_flat.SearchParams(n_probes=sf_probes)
        shutil.copytree(os.path.dirname(prefix), root / "damaged")
        dprefix = str(root / "damaged" / "index")
        os.remove(f"{dprefix}.rank1")
        try:
            sharded.deserialize_ivf_flat_elastic(dprefix)
        except ValueError as e:
            if f"{dprefix}.rank1" not in str(e):
                raise AssertionError(f"the strict restore did not name the "
                                     f"missing file: {e}") from e
        else:
            raise AssertionError("the strict restore of a checkpoint missing "
                                 "a rank file did not raise")
        with open(f"{dprefix}.rank2", "r+b") as f:
            f.truncate(os.path.getsize(f"{dprefix}.rank2") // 2)
        report = sharded.verify_checkpoint(dprefix)
        if report["files"] != {"index.rank0": "ok", "index.rank1": "missing",
                               "index.rank2": "truncated",
                               "index.rank3": "ok"} or report["ok"]:
            raise AssertionError(f"verify_checkpoint: {report}")
        try:
            sharded.deserialize_ivf_flat_elastic(dprefix)
        except IntegrityError as e:
            if e.reason != "truncated":
                raise AssertionError(f"strict restore: {e.reason}") from e
        else:
            raise AssertionError("the strict restore of a damaged checkpoint "
                                 "did not raise")
        degraded, degraded_s = timed(
            lambda: sharded.deserialize_ivf_flat_elastic(
                dprefix, allow_partial=True))
        survivors = [sf_index.indexes[r] for r in (0, 3)]
        want_cov = sum(int((i.list_indices >= 0).sum())
                       + int((i.overflow_indices >= 0).sum())
                       for i in survivors) / sf_index.n_rows
        if degraded.shard_ranks != [0, 3] or degraded.coverage != want_cov \
                or not degraded.coverage < 1:
            raise AssertionError(f"degraded restore: ranks "
                                 f"{degraded.shard_ranks}, coverage "
                                 f"{degraded.coverage} (want {want_cov})")
        got, d_launches = counted(lambda: degraded.search(queries, K, params))
        two = sharded.ShardedIvfFlat(tcomms.init_comms([dev] * 2), survivors,
                                     sf_index.metric, sf_index.n_rows,
                                     [0, sf_index.n_rows])
        if not bitwise_equal(got, sharded.search_ivf_flat(
                two, queries, K, params, merge_mode="allgather")):
            raise AssertionError("the degraded search differs from the "
                                 "allgather merge of the surviving ranks")
        emit({"phase": "persist_damaged", "card": smi,
              "verify": report["files"],
              "missing_ranks": report["missing_ranks"],
              "coverage": degraded.coverage, "survivors": [0, 3],
              "restore_seconds": degraded_s,
              "degraded_recall_at_10": float(neighborhood_recall(
                  got.indices, gt_i)),
              "bitwise_equal_survivors_allgather": True,
              "launches": d_launches})

        # ---- 5. degraded serving, then the swap to the full restore
        q_host = queries[:SERVE_DEGRADED_QUERIES].cpu().numpy()
        gt_part = gt_i[:SERVE_DEGRADED_QUERIES]
        sample = np.random.default_rng(0).choice(
            SERVE_DEGRADED_QUERIES, SERVE_SAMPLE, replace=False)
        searcher = serving.elastic_searcher(degraded, params)
        sink = BatchSink()
        eng = serving.Engine(searcher, serving.EngineConfig(
            max_batch=64, max_wait_us=2000, max_inflight=2, warm_ks=(K,),
            span_sink=sink))
        eng.start()
        try:
            builds0 = serving.compile_count()
            run, s_launches = counted(lambda: closed_loop(
                eng, q_host, K, SERVE_LOADS[0]))
            line = summarize(run, sink.take())
            coverage = eng.stats.coverage
            mismatches = serving.verify_bit_identity(
                searcher, [q_host[j] for j in sample],
                [(run["distances"][j], run["ids"][j]) for j in sample], K,
                [run["placements"][j] for j in sample])
            degraded_recall = float(neighborhood_recall(
                torch.from_numpy(run["ids"]).to(dev), gt_part))
            full_searcher = serving.elastic_searcher(full, params)
            eng.swap_index(full_searcher)
            transitions = list(eng.stats.coverage_transitions)
            run2, f_launches = counted(lambda: closed_loop(
                eng, q_host, K, SERVE_LOADS[0]))
            builds = serving.compile_count() - builds0
            full_line = summarize(run2, sink.take())
        finally:
            eng.stop()
        full_recall = float(neighborhood_recall(
            torch.from_numpy(run2["ids"]).to(dev), gt_part))
        emit({"phase": "persist_serving", "card": smi,
              "submitters": SERVE_LOADS[0], **line,
              "builds_after_start": builds, "coverage": coverage,
              "solo_mismatches": mismatches, "solo_sampled": SERVE_SAMPLE,
              "recall_at_10": degraded_recall,
              "coverage_transitions": transitions,
              "full_qps": full_line["qps"], "full_p50_ms": full_line["p50_ms"],
              "full_recall_at_10": full_recall,
              "launches": s_launches, "full_launches": f_launches})
        if builds:
            raise AssertionError(f"degraded serving: {builds} kernel builds "
                                 "after start()")
        if not coverage < 1 or mismatches:
            raise AssertionError(f"degraded serving: coverage {coverage}, "
                                 f"{mismatches} rows differ from "
                                 "solo_reference")
        if transitions != [(round(degraded.coverage, 6), 1.0)]:
            raise AssertionError(f"coverage transitions {transitions}")
        if full_recall < RECALL_FLOOR:
            raise AssertionError(f"served full restore recall {full_recall} "
                                 f"< {RECALL_FLOOR}")
        for name in ("fused_ivf_topk", "select_k"):
            if s_launches[name] < 1 or f_launches[name] < 1:
                raise AssertionError(f"elastic serving launched no {name}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in PERSIST_KERNELS:
        if totals[name] < 1:
            raise AssertionError(f"phase 6c launched no {name}")
    return totals


def narrow_phase(*, smi, dev, seed, dataset, queries, gt_v, gt_i, bf, flat,
                 flat_probes, keep_t, filt, cg_index, launch_counts, bound,
                 scale) -> list:
    """Phase 6d: narrow IVF-Flat lists (uint8, int8 at SPACEV's width,
    fp16) through the kernels, each against a twin over the same lists cast
    to f32; the bf16 fast scan of brute force, IVF-Flat and CAGRA on the
    earlier phases' indexes; the uint8 index served. Returns the kernels
    line's rows of the narrow kernels (each step's launch counts set to 0
    just before it and read just after)."""
    import numpy as np
    import torch

    from raft_tpu_torch import serving
    from raft_tpu_torch.bench.datagen import low_rank_clusters
    from raft_tpu_torch.bench.serve_load import BatchSink, closed_loop, \
        summarize
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat
    from raft_tpu_torch.ops import gpu_kernels as gk
    from raft_tpu_torch.ops.distance import gathered_distances, row_norms_sq
    from raft_tpu_torch.stats import neighborhood_recall
    from raft_tpu_torch.testing import assert_topk_close

    def counted(fn):
        gk.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, launch_counts()

    def twin_of(index):
        """The same index with its lists (and overflow rows) cast to f32."""
        return ivf_flat.Index(
            index.params, index.centers, index.list_data.float(),
            index.list_indices, index.list_sizes, index.n_rows,
            index.overflow_data.float(), index.overflow_indices)

    def index_bytes(index):
        return sum(t.numel() * t.element_size() for t in (
            index.centers, index.list_data, index.list_indices,
            index.list_sizes, index.overflow_data, index.overflow_indices))

    def kernel_row(name, label, shape, fn, twin_fn, plain_fn, args,
                   twin_args, n_bytes, n_ops, launches, tol_scale, reps=5):
        """The narrow kernel against the f32 kernel on the twin's lists
        (bitwise) and against its plain version (values within
        1e-4·tol_scale + 1e-5·|v|, tol_scale the largest squared norm of
        the rows and queries); ms of all three."""
        got, twin = fn(*args), twin_fn(*twin_args)
        got_t = got if isinstance(got, tuple) else (got,)
        twin_t = twin if isinstance(twin, tuple) else (twin,)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got_t, twin_t)):
            raise AssertionError(f"{name} ({label}): not bitwise the f32 "
                                 "kernel on the same lists")
        want = plain_fn(*args)
        if isinstance(got, tuple):
            err = assert_topk_close(got, want, 1e-4 * tol_scale, 1e-5,
                                    f"{name} ({label})")["max_abs_err"]
        else:
            diff = (got - want).abs()
            err = float(diff.max())
            if bool((diff > 1e-4 * tol_scale + 1e-5 * want.abs()).any()):
                raise AssertionError(f"{name} ({label}): differs from the "
                                     f"plain version by up to {err}")
        torch.cuda.synchronize()
        row = dict(name=name, route="cuda",
                   source=f"raft_tpu_torch/csrc/{name}.cu",
                   replaces=REPLACES[name], shape=shape, row_type=label,
                   launches=launches, bitwise_f32_twin=True,
                   agrees_with_plain=True, max_abs_err=err,
                   ms=cuda_ms(lambda: fn(*args), reps),
                   twin_f32_ms=cuda_ms(lambda: twin_fn(*twin_args), reps),
                   plain_ms=cuda_ms(lambda: plain_fn(*args), 1, False),
                   library_ms=None, card=smi, **bound(n_bytes, n_ops))
        emit({"phase": "kernel_check", **row})
        return row

    rows_out = []
    lo = float(torch.minimum(dataset.min(), queries.min()))
    hi = float(torch.maximum(dataset.max(), queries.max()))

    def to_u8(x):
        return torch.round((x - lo) * (255.0 / (hi - lo))).to(torch.uint8)

    sp_rows = low_rank_clusters(np.random.default_rng(seed + 2),
                                N_ROWS + N_QUERIES, SPACEV_DIM)
    amax = float(np.abs(sp_rows).max())
    sp_rows = np.round(sp_rows * (127.0 / amax)).astype(np.int8)
    cases = [("uint8", to_u8(dataset), to_u8(queries)),
             ("int8", torch.from_numpy(sp_rows[:N_ROWS]).to(dev),
              torch.from_numpy(sp_rows[N_ROWS:]).to(dev)),
             ("fp16", dataset.half(), queries.half())]
    del sp_rows
    u8 = None
    for label, rows, qs in cases:
        # the ground truth: exact search of the rows as f32
        exact = brute_force.build(rows.float(), metric="sqeuclidean")
        _, n_gt = brute_force.search(exact, qs.float(), K)
        del exact
        index, build_s = timed(lambda: ivf_flat.build(
            rows, ivf_flat.IndexParams(n_lists=N_LISTS)))
        twin = twin_of(index)
        n_probes = N_PROBES
        while True:
            params = ivf_flat.SearchParams(n_probes=n_probes)
            _, first_s = timed(lambda: ivf_flat.search(index, qs, K, params))
            ((nv, ni), search_s), launches = counted(lambda: timed(
                lambda: ivf_flat.search(index, qs, K, params)))
            recall = float(neighborhood_recall(ni, n_gt))
            if recall >= RECALL_FLOOR or n_probes >= N_LISTS:
                break
            n_probes *= 2
        device_ms = cuda_ms(lambda: ivf_flat.search(index, qs, K, params), 3)
        twin_out = ivf_flat.search(twin, qs, K, params)
        bitwise = bitwise_equal((nv, ni), twin_out)
        emit({"phase": "narrow", "card": smi, "row_type": label,
              "rows": rows.shape[0], "dim": rows.shape[1],
              "n_lists": N_LISTS, "n_probes": n_probes,
              "list_pad": index.list_data.shape[1],
              "list_bytes": index.list_data.numel()
              * index.list_data.element_size(),
              "index_bytes": index_bytes(index),
              "twin_index_bytes": index_bytes(twin),
              "build_seconds": build_s, "first_call_seconds": first_s,
              "search_seconds": search_s, "search_cuda_ms": device_ms,
              "qps": N_QUERIES / search_s, "recall_at_10": recall,
              "bitwise_f32_twin": bitwise, "launches": launches})
        if recall < RECALL_FLOOR:
            raise AssertionError(f"narrow {label}: recall {recall} < "
                                 f"{RECALL_FLOOR}")
        if not bitwise:
            raise AssertionError(f"narrow {label}: the search differs from "
                                 "its f32 twin's")
        if launches["fused_ivf_topk"] < 1:
            raise AssertionError(f"narrow {label}: no fused_ivf_topk launch")
        if not bool(torch.isfinite(nv).all()) or bool((ni < 0).any()):
            raise AssertionError(f"narrow {label}: result not complete")

        # the kernel at the search's inputs, as the fused search builds them
        qf = qs.to(torch.float32)
        scores, _ = ivf_flat._coarse_scores(qf, index.centers, index.metric)
        _, probes = gk.streaming_select_k(scores.contiguous(), n_probes)
        rot = index.dim
        qv = qf[:, None, :].expand(N_QUERIES, n_probes, rot).contiguous()
        qn = row_norms_sq(qf)[:, None].expand(N_QUERIES,
                                              n_probes).contiguous()
        norms, ids = index.ensure_row_norms(), index.safe_ids()
        pad = index.list_data.shape[1]
        elem = index.list_data.element_size()
        n_scale = float(torch.maximum(norms.max(), qn.max()))
        rows_scanned = int(index.list_sizes[probes.long()].sum())
        n_probed = torch.unique(probes.long()).numel()
        rows_out.append(kernel_row(
            "fused_ivf_topk", label,
            f"ivf_flat {label}: {N_QUERIES} queries x {n_probes} probes, "
            f"pad {pad}, rot {rot}, clamp",
            gk.fused_ivf_topk, gk.fused_ivf_topk, gk.fused_ivf_topk_plain,
            (probes, qv, qn, index.list_data, norms, ids, K),
            (probes, qv, qn, twin.list_data, norms, ids, K),
            4 * (probes.numel() + qv.numel() + qn.numel())
            + n_probed * pad * (rot * elem + 8) + 8 * N_QUERIES * K,
            2 * rot * rows_scanned, launches["fused_ivf_topk"], n_scale))
        del qv, qn, scores

        if label == "uint8":
            u8 = (index, qs, n_probes, n_gt)
            # the filtered search: ivf_scan over the uint8 lists
            fparams = ivf_flat.SearchParams(n_probes=n_probes)
            ((fv, fi), f_s), f_launches = counted(lambda: timed(
                lambda: ivf_flat.search(index, qs, K, fparams, filter=filt)))
            f_twin = ivf_flat.search(twin, qs, K, fparams, filter=filt)
            f_bitwise = bitwise_equal((fv, fi), f_twin)
            leaked = int((~keep_t[fi.clamp_min(0).long()] | (fi < 0)).sum())
            emit({"phase": "narrow_filtered", "card": smi,
                  "row_type": label, "n_probes": n_probes,
                  "search_seconds": f_s, "qps": N_QUERIES / f_s,
                  "bitwise_f32_twin": f_bitwise, "removed_ids_returned":
                  leaked, "launches": f_launches})
            if not f_bitwise or leaked:
                raise AssertionError(f"narrow filtered: bitwise {f_bitwise}, "
                                     f"{leaked} removed or missing ids")
            if f_launches["ivf_scan"] < 1 or f_launches["fused_ivf_topk"]:
                raise AssertionError("narrow filtered: not on ivf_scan")
            # one query tile of it, as _search_core builds it
            tile = ivf_flat.plan_scan_tiles(
                n_probes, pad, rot, Resources().workspace_limit_bytes)
            qt = qf[:tile]
            sc, _ = ivf_flat._coarse_scores(qt, index.centers, index.metric)
            _, t_pr = gk.streaming_select_k(sc.contiguous(), n_probes)
            t_qv = qt[:, None, :].expand(-1, n_probes, -1).contiguous()
            slots = t_pr.numel() * pad
            t_probed = torch.unique(t_pr.long()).numel()
            rows_out.append(kernel_row(
                "ivf_scan", label,
                f"ivf_flat {label} filtered: one tile of {qt.shape[0]} "
                f"queries x {n_probes} probes, pad {pad}, rot {rot}",
                gk.ivf_scan, gk.ivf_scan, gk.ivf_scan_plain,
                (t_pr, t_qv, index.list_data, norms),
                (t_pr, t_qv, twin.list_data, norms),
                4 * (t_pr.numel() + t_qv.numel()) + t_probed * pad
                * (rot * elem + 4) + 4 * slots, 2 * rot * slots,
                f_launches["ivf_scan"], n_scale))
        else:
            del index
        del twin, rows
        torch.cuda.empty_cache()

    # ---- the bf16 fast scan on the earlier phases' indexes
    (fb, fb_s), fb_launches = counted(lambda: timed(lambda: brute_force.search(
        bf, queries, K, scan_dtype="bfloat16", refine_ratio=FAST_REFINE)))
    fb_recall = float(neighborhood_recall(fb[1], gt_i))
    agree = fb[1] == gt_i
    # the re-ranked distances against the exact fp32 distances of the same
    # ids (rtol 1e-5, atol 1e-6·max‖x‖², fp32's rounding of the expanded
    # form's terms), then against phase 3's within its tolerance
    exact = gathered_distances(queries, dataset[fb[1].clamp_min(0).long()],
                               bf.metric)
    ex_diff = (fb[0] - exact).abs()
    fb_exact_err = float(ex_diff[agree].max())
    fb_exact_rel = float((ex_diff / exact.abs().clamp_min(1e-30))[agree].max())
    fb_exact_ok = bool((ex_diff <= 1e-6 * scale + 1e-5 * exact.abs())
                       [agree].all())
    del exact, ex_diff
    diff = (fb[0] - gt_v).abs()
    fb_err = float(diff[agree].max())
    fb_rel = float((diff / gt_v.abs().clamp_min(1e-30))[agree].max())
    fb_ok = bool((diff <= 1e-4 * scale + 1e-5 * gt_v.abs())[agree].all())
    (ff, ff_s), ff_launches = counted(lambda: timed(lambda: ivf_flat.search(
        flat, queries, K, ivf_flat.SearchParams(
            n_probes=flat_probes, scan_dtype="bfloat16",
            refine_ratio=FAST_REFINE))))
    _, flat_i = ivf_flat.search(flat, queries, K,
                                ivf_flat.SearchParams(n_probes=flat_probes))
    flat_recall = float(neighborhood_recall(flat_i, gt_i))
    ff_recall = float(neighborhood_recall(ff[1], gt_i))
    nq_cg = CAGRA_GLUE_QUERIES
    cg_sp = cagra.SearchParams(itopk_size=CAGRA_ITOPK, search_width=1,
                               scan_dtype="bfloat16")
    cg_plan = cagra.plan_search(cg_index, K, cg_sp)
    (fc, fc_s), fc_launches = counted(lambda: timed(lambda: cagra.search(
        cg_index, queries[:nq_cg], K, cg_sp)))
    fc_recall = float(neighborhood_recall(fc[1], gt_i[:nq_cg]))
    emit({"phase": "fast_scan", "card": smi, "refine_ratio": FAST_REFINE,
          "brute_force": {"seconds": fb_s, "qps": N_QUERIES / fb_s,
                          "recall_at_10": fb_recall,
                          "max_abs_err_vs_exact_fp32": fb_exact_err,
                          "max_rel_err_vs_exact_fp32": fb_exact_rel,
                          "max_abs_err_at_agreeing_ids": fb_err,
                          "max_rel_err_at_agreeing_ids": fb_rel,
                          "launches": fb_launches},
          "ivf_flat": {"n_probes": flat_probes, "seconds": ff_s,
                       "qps": N_QUERIES / ff_s, "recall_at_10": ff_recall,
                       "fp32_recall_at_10": flat_recall,
                       "launches": ff_launches},
          "cagra": {"itopk": CAGRA_ITOPK, "queries": nq_cg,
                    "engine": cg_plan.engine, "reason": cg_plan.reason,
                    "seconds": fc_s, "recall_at_10": fc_recall,
                    "scan_dataset_bytes": cg_index.ensure_scan_dataset()
                    .numel() * 2, "launches": fc_launches}})
    if fb_recall < FAST_BF_FLOOR or not fb_ok or not fb_exact_ok:
        raise AssertionError(f"fast-scan brute force: recall {fb_recall}, "
                             f"distances off by up to {fb_exact_err} from "
                             f"the exact fp32 ones, {fb_err} from phase 3")
    if ff_recall < flat_recall - FAST_IVF_SLACK:
        raise AssertionError(f"fast-scan IVF-Flat recall {ff_recall} against "
                             f"{flat_recall}")
    if fc_recall < CAGRA_RECALL_FLOOR or cg_plan.engine != "xla":
        raise AssertionError(f"fast-scan CAGRA recall {fc_recall} "
                             f"({cg_plan.engine})")
    for launches in (fb_launches, ff_launches, fc_launches):
        if launches["fused_l2_topk"] or launches["fused_ivf_topk"] \
                or launches["ivf_scan"] or launches["fused_cagra_topk"]:
            raise AssertionError("a fast scan launched a fused kernel")

    # ---- the uint8 index served
    index, qs, n_probes, n_gt = u8
    q_host = qs[:SERVE_DEGRADED_QUERIES].cpu().numpy()
    sample = np.random.default_rng(seed).choice(
        SERVE_DEGRADED_QUERIES, SERVE_SAMPLE, replace=False)
    searcher = serving.ivf_flat_searcher(
        index, ivf_flat.SearchParams(n_probes=n_probes))
    sink = BatchSink()
    eng = serving.Engine(searcher, serving.EngineConfig(
        max_batch=64, max_wait_us=2000, max_inflight=2, warm_ks=(K,),
        span_sink=sink))
    eng.start()
    try:
        builds0 = serving.compile_count()
        run, s_launches = counted(lambda: closed_loop(
            eng, q_host, K, SERVE_LOADS[0]))
        builds = serving.compile_count() - builds0
        line = summarize(run, sink.take())
        mismatches = serving.verify_bit_identity(
            searcher, [q_host[j] for j in sample],
            [(run["distances"][j], run["ids"][j]) for j in sample], K,
            [run["placements"][j] for j in sample])
    finally:
        eng.stop()
    s_recall = float(neighborhood_recall(
        torch.from_numpy(run["ids"]).to(dev), n_gt[:SERVE_DEGRADED_QUERIES]))
    emit({"phase": "narrow_serving", "card": smi, "row_type": "uint8",
          "query_dtype": str(searcher.query_dtype),
          "submitters": SERVE_LOADS[0], **line,
          "builds_after_start": builds, "solo_mismatches": mismatches,
          "solo_sampled": SERVE_SAMPLE, "recall_at_10": s_recall,
          "launches": s_launches})
    if builds or mismatches:
        raise AssertionError(f"narrow serving: {builds} builds after start(),"
                             f" {mismatches} rows differ from solo_reference")
    if s_launches["fused_ivf_topk"] < 1:
        raise AssertionError("narrow serving launched no fused_ivf_topk")
    return rows_out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", default=None,
                        help="a source tree (the parent commit, unpacked) "
                        "whose kernels (fused_l2_topk, fused_ivf_topk, "
                        "select_k, fused_pq_topk, fused_cagra_topk, "
                        "fused_l2_argmin, ivf_scan, ring_shift) are timed "
                        "on the same inputs, in turns with this tree's")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from raft_tpu_torch.bench.datagen import low_rank_clusters
        from raft_tpu_torch.cluster import kmeans
        from raft_tpu_torch.core.bitset import Bitset
        from raft_tpu_torch.core.resources import Resources
        from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
        from raft_tpu_torch.neighbors.refine import refine
        from raft_tpu_torch.ops import gpu_kernels as gk
        from raft_tpu_torch.ops.distance import row_norms_sq
        from raft_tpu_torch.ops.fused_l2_nn import fused_l2_nn_argmin
        from raft_tpu_torch.ops.select_k import select_k
        from raft_tpu_torch.parallel import comms as tcomms
        from raft_tpu_torch.parallel import sharded
        from raft_tpu_torch.stats import neighborhood_recall
        from raft_tpu_torch.testing import assert_topk_close
    except ImportError as e:
        print(f"chip_smoke: raft_tpu_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np
    from raft_tpu_torch.bench.kernel_ab import graph_ms, select_k_rows
    from raft_tpu_torch.obs import costs as obs_costs

    #: the bounds' peaks: the H100 SXM data sheet's (``obs.costs``)
    PEAKS = obs_costs.H100_PEAKS

    def launch_counts() -> dict:
        """The launch counts since the last reset, with select_k's launches
        by shape ("caller:n:k")."""
        out = dict(gk.LAUNCHES)
        out["select_k_shapes"] = {f"{c}:{n}:{k}": m for (c, n, k), m
                                  in gk.SELECT_K_SHAPES.items()}
        return out

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sm_clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit({"phase": "card", "nvidia_smi": smi,
          "clocks_max_sm_hz": sm_clock_hz,
          "device": torch.cuda.get_device_name(0),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build the kernels
    paths, build_kernels_s = timed(gk.build_all)
    emit({"phase": "build", "seconds": build_kernels_s,
          "libraries": {k: str(v.name) for k, v in paths.items()}})
    emit({"phase": "ptxas", **{name: obs_costs.ptxas_figures(paths[name])
                               for name in ("fused_l2_topk", "fused_ivf_topk",
                                            "select_k", "fused_pq_topk",
                                            "fused_cagra_topk",
                                            "fused_l2_argmin", "ivf_scan",
                                            "ring_shift")}})
    # phases 3-6e search under scan_mode="auto" and count the fused
    # kernels' launches: the committed verdicts must route auto to them
    # (a losing verdict sends auto to the unfused route; such a family's
    # phases would then ask for scan_mode="pallas")
    routes = {fam: gk.fused_dispatch_explained(fam, "auto", dev)
              for fam in gk.VERDICT_FAMILIES}
    emit({"phase": "dispatch", "card": smi,
          "platform_key": gk.fused_platform_key(dev),
          "auto_routes": {f: {"fused": u, "reason": r}
                          for f, (u, r) in routes.items()}})
    if not all(u for u, _ in routes.values()):
        raise AssertionError(f"scan_mode='auto' leaves a fused kernel on "
                             f"this card: {routes}")

    # data at SIFT-1M's shape, from the seed (set-up, not timed)
    rng = np.random.default_rng(opts.seed)
    rows = low_rank_clusters(rng, N_ROWS + N_QUERIES, DIM)
    dataset = torch.from_numpy(rows[:N_ROWS]).to(dev)
    queries = torch.from_numpy(rows[N_ROWS:]).to(dev)
    torch.cuda.synchronize()

    # ---- 3. exact search: the ground truth. The first call also loads
    # the kernel's library; the second is the warm request.
    bf = brute_force.build(dataset, metric="sqeuclidean")
    gk.reset_launch_counts()
    (gt_v, gt_i), bf_cold_s = timed(lambda: brute_force.search(bf, queries, K))
    (gt_v, gt_i), bf_s = timed(lambda: brute_force.search(bf, queries, K))
    bf_launches = launch_counts()
    if bf_launches["fused_l2_topk"] < 1:
        raise AssertionError("brute_force.search did not launch fused_l2_topk")
    if gt_v.shape != (N_QUERIES, K) or not bool(torch.isfinite(gt_v).all()) \
            or bool((gt_i < 0).any()):
        raise AssertionError("brute-force result is not finite and complete")
    emit({"phase": "brute_force", "queries": N_QUERIES, "rows": N_ROWS,
          "k": K, "first_call_seconds": bf_cold_s, "seconds": bf_s,
          "qps": N_QUERIES / bf_s, "launches": bf_launches})

    # ---- 4. IVF-Flat build + search, recall against phase 3
    gk.reset_launch_counts()
    index, build_s = timed(lambda: ivf_flat.build(
        dataset, ivf_flat.IndexParams(n_lists=N_LISTS)))
    n_probes = N_PROBES
    while True:
        params = ivf_flat.SearchParams(n_probes=n_probes)
        _, first_s = timed(lambda: ivf_flat.search(index, queries, K, params))
        (iv, ii), search_s = timed(lambda: ivf_flat.search(index, queries, K,
                                                           params))
        recall = float(neighborhood_recall(ii, gt_i))
        if recall >= RECALL_FLOOR or n_probes >= N_LISTS:
            break
        n_probes *= 2
    ivf_launches = launch_counts()
    emit({"phase": "ivf_flat", "n_lists": N_LISTS, "n_probes": n_probes,
          "list_pad": index.list_data.shape[1],
          "overflow_rows": int((index.overflow_indices >= 0).sum()),
          "build_seconds": build_s, "first_call_seconds": first_s,
          "search_seconds": search_s, "qps": N_QUERIES / search_s,
          "recall_at_10": recall, "launches": ivf_launches})
    if recall < RECALL_FLOOR:
        raise AssertionError(f"IVF-Flat recall {recall} < {RECALL_FLOOR}")
    for name in ("fused_ivf_topk", "select_k"):
        if ivf_launches[name] < 1:
            raise AssertionError(f"ivf_flat.search did not launch {name}")
    if not bool(torch.isfinite(iv).all()):
        raise AssertionError("IVF-Flat distances are not finite")

    # the same build again: every part of the index bitwise equal (the
    # build's sums run in row order, so the card repeats itself)
    again, rebuild_s = timed(lambda: ivf_flat.build(
        dataset, ivf_flat.IndexParams(n_lists=N_LISTS)))
    differ = [name for name in ("centers", "list_data", "list_indices",
                                "list_sizes", "overflow_data",
                                "overflow_indices")
              if getattr(again, name).shape != getattr(index, name).shape
              or not torch.equal(getattr(again, name), getattr(index, name))]
    emit({"phase": "ivf_flat_rebuild", "build_seconds": rebuild_s,
          "bitwise_equal": not differ, "differ": differ})
    if differ:
        raise AssertionError(f"two IVF-Flat builds differ in {differ}")
    del again

    # ---- 5. IVF-PQ: build, the two regimes of the fused dispatch, refine
    gk.reset_launch_counts()
    pq_index, pq_build_s = timed(lambda: ivf_pq.build(
        dataset, ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                                    pq_bits=PQ_BITS, kmeans_n_iters=20)))
    pq_build_launches = launch_counts()
    pq_pad = pq_index.list_codes.shape[1]
    packed_bytes, cache_bytes = ivf_pq.scan_memory_bytes(pq_index)
    emit({"phase": "ivf_pq_build", "n_lists": N_LISTS, "pq_dim": PQ_DIM,
          "pq_bits": PQ_BITS, "build_seconds": pq_build_s,
          "list_pad": pq_pad,
          "overflow_rows": int((pq_index.overflow_indices >= 0).sum()),
          "packed_bytes": packed_bytes, "cache_bytes": cache_bytes,
          "launches": pq_build_launches})

    def pq_phase(name, res, engine, floor, start_probes):
        """Search until the recall floor is met (probes doubling), with the
        launch counts set to 0 just before; the engine is asserted first."""
        n_probes = start_probes
        gk.reset_launch_counts()
        while True:
            params = ivf_pq.SearchParams(n_probes=n_probes)
            plan = ivf_pq.plan_search(pq_index, K, params, res=res)
            if plan.engine != engine:
                raise AssertionError(f"{name}: engine {plan.engine} "
                                     f"({plan.reason}), expected {engine}")
            _, first_s = timed(lambda: ivf_pq.search(pq_index, queries, K,
                                                     params, res=res))
            (v, i), search_s = timed(lambda: ivf_pq.search(
                pq_index, queries, K, params, res=res))
            recall = float(neighborhood_recall(i, gt_i))
            if recall >= floor or n_probes >= N_LISTS:
                break
            n_probes *= 2
        launches = launch_counts()
        emit({"phase": name, "engine": plan.engine, "reason": plan.reason,
              "n_probes": n_probes, "first_call_seconds": first_s,
              "search_seconds": search_s, "qps": N_QUERIES / search_s,
              "recall_at_10": recall, "launches": launches})
        if recall < floor:
            raise AssertionError(f"{name} recall {recall} < {floor}")
        if v.shape != (N_QUERIES, K) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: distances not finite and complete")
        return n_probes, launches

    card_res = Resources()
    pq_probes, pq_cache_launches = pq_phase(
        "ivf_pq", card_res, "pallas_cache", PQ_RECALL_FLOOR, N_PROBES)
    for name in ("fused_ivf_topk", "select_k"):
        if pq_cache_launches[name] < 1:
            raise AssertionError(f"ivf_pq (cache regime) did not launch {name}")
    # the cache regime's kernel inputs, kept for the kernel check; the index
    # drops its cache so that the LUT regime runs without one
    pq_cache = (pq_index.list_decoded, pq_index.decoded_norms)
    ivf_pq.drop_scan_cache(pq_index)
    lut_res = Resources(device_memory_bytes=packed_bytes + cache_bytes)
    lut_probes, pq_lut_launches = pq_phase(
        "ivf_pq_lut", lut_res, "pallas_lut", PQ_RECALL_FLOOR, N_PROBES)
    if pq_lut_launches["fused_pq_topk"] < 1:
        raise AssertionError("ivf_pq (LUT regime) did not launch fused_pq_topk")
    if pq_index.list_decoded is not None:
        raise AssertionError("the LUT regime built the decoded cache")

    gk.reset_launch_counts()
    refine_probes = REFINE_PROBES
    while True:
        params = ivf_pq.SearchParams(n_probes=refine_probes)

        def search_refine():
            _, cand = ivf_pq.search(pq_index, queries, 2 * K, params,
                                    res=lut_res)
            return refine(dataset, queries, cand, K)

        _, refine_first_s = timed(search_refine)
        (rv, ri), refine_s = timed(search_refine)
        refine_recall = float(neighborhood_recall(ri, gt_i))
        if refine_recall >= REFINE_RECALL_FLOOR or refine_probes >= N_LISTS:
            break
        refine_probes *= 2
    refine_launches = launch_counts()
    emit({"phase": "ivf_pq_refine", "n_probes": refine_probes,
          "candidates": 2 * K, "first_call_seconds": refine_first_s,
          "seconds": refine_s, "qps": N_QUERIES / refine_s,
          "recall_at_10": refine_recall, "launches": refine_launches})
    if refine_recall < REFINE_RECALL_FLOOR:
        raise AssertionError(f"refined recall {refine_recall} < "
                             f"{REFINE_RECALL_FLOOR}")
    if not bool(torch.isfinite(rv).all()):
        raise AssertionError("refined distances are not finite")

    # ---- 5b. CAGRA: build (NN-descent + optimize), the kernel engine, the
    # glue engine on a slice of the queries
    gk.reset_launch_counts()
    cg_params = cagra.IndexParams(graph_degree=CAGRA_DEGREE,
                                  intermediate_graph_degree=CAGRA_INTER,
                                  nn_descent_niter=20)
    cg_index, cg_build_s = timed(lambda: cagra.build(dataset, cg_params))
    cg_build_launches = launch_counts()
    g = cg_index.graph
    if g.shape != (N_ROWS, CAGRA_DEGREE) or bool((g < 0).any()) \
            or bool((g >= N_ROWS).any()):
        raise AssertionError("the CAGRA graph is not complete and in range")
    emit({"phase": "cagra_build", "graph_degree": CAGRA_DEGREE,
          "intermediate_graph_degree": CAGRA_INTER, "nn_descent_niter": 20,
          "build_seconds": cg_build_s,
          "nn_descent_seconds": cg_index.build_seconds["knn_graph"],
          "optimize_seconds": cg_index.build_seconds["optimize"],
          "launches": cg_build_launches})
    itopk = CAGRA_ITOPK
    gk.reset_launch_counts()
    while True:
        cg_sp = cagra.SearchParams(itopk_size=itopk, search_width=1)
        cg_plan = cagra.plan_search(cg_index, K, cg_sp)
        if cg_plan.engine != "pallas":
            raise AssertionError(f"cagra: engine {cg_plan.engine} "
                                 f"({cg_plan.reason}), expected pallas")
        _, cg_first_s = timed(lambda: cagra.search(cg_index, queries, K,
                                                   cg_sp))
        (cv, ci), cg_s = timed(lambda: cagra.search(cg_index, queries, K,
                                                    cg_sp))
        cg_recall = float(neighborhood_recall(ci, gt_i))
        if cg_recall >= CAGRA_RECALL_FLOOR or itopk >= CAGRA_MAX_ITOPK:
            break
        itopk *= 2
    cagra_launches = launch_counts()
    if cagra_launches["fused_cagra_topk"] < 1:
        raise AssertionError("cagra.search did not launch fused_cagra_topk")
    if cv.shape != (N_QUERIES, K) or not bool(torch.isfinite(cv).all()):
        raise AssertionError("cagra: distances not finite and complete")
    # the walk's counts, from the plain version on the same inputs (its
    # result equals the kernel's bitwise, checked in phase 6)
    cg_args = (queries, dataset, cg_index.graph,
               cagra.seed_table(cg_sp, N_QUERIES, N_ROWS,
                                cg_plan.plan["n_seeds"], dev),
               gk.beam_norms(queries))
    cg_max_iter = cg_plan.plan["max_iter"]
    *_, cg_stats = gk.fused_cagra_topk_plain(*cg_args, K, itopk, 1,
                                             cg_max_iter, return_stats=True)
    cg_hops, cg_rows = (int(cg_stats["hops"].sum()),
                        int(cg_stats["rows_scored"].sum()))
    cg_touched, cg_expanded = (cg_stats["rows_touched"],
                               cg_stats["nodes_expanded"])
    nq_glue = CAGRA_GLUE_QUERIES
    glue_sp = cagra.SearchParams(itopk_size=itopk, search_width=1,
                                 scan_mode="xla")
    glue, glue_s = timed(lambda: cagra.search(cg_index, queries[:nq_glue], K,
                                              glue_sp))
    glue_agree = assert_topk_close(
        glue, (cv[:nq_glue], ci[:nq_glue]),
        1e-4 * float(torch.maximum(row_norms_sq(queries).max(),
                                   bf.norms.max())), 1e-5, "cagra glue")
    emit({"phase": "cagra", "itopk": itopk, "search_width": 1,
          "max_iter": cg_max_iter, "n_seeds": cg_plan.plan["n_seeds"],
          "first_call_seconds": cg_first_s, "search_seconds": cg_s,
          "qps": N_QUERIES / cg_s, "recall_at_10": cg_recall,
          "mean_hops": cg_hops / N_QUERIES, "rows_scored": cg_rows,
          "rows_touched": cg_touched, "nodes_expanded": cg_expanded,
          "glue_queries": nq_glue, "glue_seconds": glue_s,
          "glue_vs_kernel": glue_agree, "launches": cagra_launches})
    if cg_recall < CAGRA_RECALL_FLOOR:
        raise AssertionError(f"cagra recall {cg_recall} < "
                             f"{CAGRA_RECALL_FLOOR}")
    scale = float(torch.maximum(row_norms_sq(queries).max(), bf.norms.max()))

    # ---- 5c. Lloyd k-means with k-means++ init; the init and the Lloyd loop
    # are timed apart by wrapping the two functions fit calls
    km_seconds, km_init = {}, []

    def timed_attr(name, keep=None):
        fn = getattr(kmeans, name)

        def wrapper(*a, **kw):
            out, km_seconds[name] = timed(lambda: fn(*a, **kw))
            if keep is not None:
                keep.append(out)
            return out
        return fn, wrapper

    wrapped = {name: timed_attr(name, km_init if name == "_kmeans_pp_init"
                                else None)
               for name in ("_kmeans_pp_init", "_lloyd")}
    km_params = kmeans.KMeansParams(n_clusters=KM_CLUSTERS, max_iter=KM_ITERS,
                                    tol=KM_TOL, init="k-means++", n_init=1)
    for name, (_, wrapper) in wrapped.items():
        setattr(kmeans, name, wrapper)
    try:
        gk.reset_launch_counts()
        (km_centers, km_labels, km_inertia, km_iters), km_fit_s = timed(
            lambda: kmeans.fit(dataset, km_params,
                               res=Resources(seed=opts.seed)))
        km_fit_launches = launch_counts()
    finally:
        for name, (fn, _) in wrapped.items():
            setattr(kmeans, name, fn)
    if km_fit_launches["fused_l2_argmin"] != km_iters + 1:
        raise AssertionError(
            f"kmeans.fit launched fused_l2_argmin "
            f"{km_fit_launches['fused_l2_argmin']} times in {km_iters} "
            "iterations (expected one per iteration plus the final E-step)")
    gk.reset_launch_counts()
    (pred_labels, pred_inertia), predict_s = timed(
        lambda: kmeans.predict(km_centers, dataset))
    km_cost, cost_s = timed(lambda: kmeans.cluster_cost(dataset, km_centers))
    km_launches = {name: km_fit_launches[name] + gk.LAUNCHES[name]
                   for name in gk.LAUNCHES}
    pp_cost = float(kmeans.cluster_cost(dataset, km_init[0]))
    if not float(km_inertia) <= pp_cost:
        raise AssertionError(f"k-means inertia {float(km_inertia)} exceeds the "
                             f"k-means++ centres' cost {pp_cost}")
    # the same 1-NN by another kernel: fused_l2_topk's two nearest centres
    top2_v, top2_i = gk.fused_l2_topk(dataset, km_centers, 2)
    km_tol = 1e-4 * scale
    clear = (top2_v[:, 1] - top2_v[:, 0]) > 2 * km_tol
    km_disagree = int(((pred_labels != top2_i[:, 0]) & clear).sum())
    if km_disagree or not bool(torch.isfinite(km_centers).all()):
        raise AssertionError(f"kmeans.predict: {km_disagree} labels differ "
                             "from fused_l2_topk's away from near-ties")
    nn_rng = np.random.default_rng(opts.seed)
    nn_x = torch.from_numpy(nn_rng.standard_normal(
        (NN_ROWS, DIM)).astype(np.float32)).to(dev)
    nn_y = torch.from_numpy(nn_rng.standard_normal(
        (KM_CLUSTERS, DIM)).astype(np.float32)).to(dev)
    nn_ms = cuda_ms(lambda: fused_l2_nn_argmin(nn_x, nn_y), 10)
    emit({"phase": "kmeans", "rows": N_ROWS, "n_clusters": KM_CLUSTERS,
          "max_iter": KM_ITERS, "tol": KM_TOL, "init": "k-means++",
          "n_iter": km_iters, "fit_seconds": km_fit_s,
          "init_seconds": km_seconds["_kmeans_pp_init"],
          "lloyd_seconds": km_seconds["_lloyd"],
          "inertia": float(km_inertia), "kmeans_pp_cost": pp_cost,
          "predict_seconds": predict_s, "predict_inertia": float(pred_inertia),
          "cluster_cost_seconds": cost_s, "cluster_cost": float(km_cost),
          "labels_clear_of_ties": int(clear.sum()),
          "fused_l2_nn_argmin_ms": nn_ms,
          "fused_l2_nn_argmin_shape": [NN_ROWS, KM_CLUSTERS, DIM],
          "launches": km_launches})
    del top2_v, top2_i, clear, nn_x, nn_y

    # ---- 5d. filtered and inner-product requests, through ivf_scan. The
    # filter removes 10% of the row ids; its ground truth is the port's
    # filtered brute force (its tiled path, no kernel)
    f_rng = np.random.default_rng(opts.seed)
    keep = np.ones(N_ROWS, bool)
    keep[f_rng.choice(N_ROWS, int(FILTER_REMOVED * N_ROWS), replace=False)] = \
        False
    keep_t = torch.from_numpy(keep).to(dev)
    filt = Bitset.from_mask(keep_t)
    _, fgt_i = brute_force.search(bf, queries, K, filter=filt)

    def scan_phase(name, search, floor, start_probes, gt, plan_fn=None):
        """Search until the recall floor is met (probes doubling), the launch
        counts set to 0 just before; ivf_scan must carry it."""
        n_probes = start_probes
        gk.reset_launch_counts()
        while True:
            plan = plan_fn(n_probes) if plan_fn else None
            _, first_s = timed(lambda: search(n_probes))
            (v, i), search_s = timed(lambda: search(n_probes))
            recall = float(neighborhood_recall(i, gt))
            if recall >= floor or n_probes >= N_LISTS:
                break
            n_probes *= 2
        launches = launch_counts()
        line = {"phase": name, "n_probes": n_probes,
                "first_call_seconds": first_s, "search_seconds": search_s,
                "qps": N_QUERIES / search_s, "recall_at_10": recall,
                "launches": launches}
        if plan is not None:
            line.update(engine=plan.engine, reason=plan.reason,
                        unfused_ivf_scan=plan.plan["unfused_ivf_scan"])
        else:
            line.update(engine="ivf_flat tiled path, ivf_scan")
        emit(line)
        if recall < floor:
            raise AssertionError(f"{name} recall {recall} < {floor}")
        if launches["ivf_scan"] < 1 or launches["fused_ivf_topk"] > 0:
            raise AssertionError(f"{name} did not take the ivf_scan route")
        if v.shape != (N_QUERIES, K) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: distances not finite and complete")
        return n_probes, launches, i

    def flat_filtered(n_probes):
        return ivf_flat.search(index, queries, K,
                               ivf_flat.SearchParams(n_probes=n_probes),
                               filter=filt)

    fl_probes, fl_launches, fl_i = scan_phase(
        "ivf_flat_filtered", flat_filtered, RECALL_FLOOR, N_PROBES, fgt_i)
    if not bool(keep_t[fl_i.long()].all()) or bool((fl_i < 0).any()):
        raise AssertionError("ivf_flat_filtered returned a removed id")

    def pq_filtered(n_probes):
        return ivf_pq.search(pq_index, queries, K,
                             ivf_pq.SearchParams(n_probes=n_probes),
                             filter=filt, res=card_res)

    def pq_filtered_plan(n_probes):
        plan = ivf_pq.plan_search(pq_index, K,
                                  ivf_pq.SearchParams(n_probes=n_probes),
                                  True, res=card_res)
        if plan.engine != "cache" or not plan.plan["unfused_ivf_scan"]:
            raise AssertionError(f"ivf_pq_filtered: engine {plan.engine} "
                                 f"({plan.reason}, {plan.plan})")
        return plan

    pqf_probes, pqf_launches, pqf_i = scan_phase(
        "ivf_pq_filtered", pq_filtered, PQ_RECALL_FLOOR, N_PROBES, fgt_i,
        pq_filtered_plan)
    if not bool(keep_t[pqf_i.long()].all()) or bool((pqf_i < 0).any()):
        raise AssertionError("ivf_pq_filtered returned a removed id")
    del fgt_i, fl_i, pqf_i

    # inner product at glove-100-inner's shape: unit-norm rows from the seed
    ip_rows = low_rank_clusters(np.random.default_rng(opts.seed + 1),
                                IP_ROWS + N_QUERIES, IP_DIM)
    ip_rows /= np.linalg.norm(ip_rows, axis=1, keepdims=True)
    ip_data = torch.from_numpy(ip_rows[:IP_ROWS]).to(dev)
    ip_queries = torch.from_numpy(ip_rows[IP_ROWS:]).to(dev)
    del ip_rows
    _, ipgt_i = brute_force.search(
        brute_force.build(ip_data, metric="inner_product"), ip_queries, K)
    ip_index, ip_build_s = timed(lambda: ivf_flat.build(
        ip_data, ivf_flat.IndexParams(n_lists=N_LISTS,
                                      metric="inner_product")))

    def flat_ip(n_probes):
        return ivf_flat.search(ip_index, ip_queries, K,
                               ivf_flat.SearchParams(n_probes=n_probes))

    ip_probes, ip_launches, _ = scan_phase(
        "ivf_flat_inner_product", flat_ip, RECALL_FLOOR, N_PROBES, ipgt_i)
    emit({"phase": "ivf_flat_inner_product_build", "rows": IP_ROWS,
          "dim": IP_DIM, "n_lists": N_LISTS, "build_seconds": ip_build_s,
          "list_pad": ip_index.list_data.shape[1]})
    del ipgt_i

    # ---- 5e. the sharded path: phase 3's rows over 4 logical ranks on the
    # card. Every call runs once cold; the counts are set to 0 just before
    # the warm call and read just after it. The ring merge's first blocks
    # are kept for phase 6.
    ring_comms = tcomms.init_comms([dev] * N_RANKS)
    ring_blocks, ring_shift = [], gk.ring_shift

    def keep_ring_blocks(blocks):
        if not ring_blocks:
            ring_blocks.extend(blocks)
        return ring_shift(blocks)

    def warm_call(fn):
        """(fn(), seconds, launches, first-call seconds)."""
        _, cold_s = timed(fn)
        gk.reset_launch_counts()
        out, warm_s = timed(fn)
        return out, warm_s, launch_counts(), cold_s

    sharded_phases = []
    # a ring call: size - 1 hops, each one launch per source device
    ring_hops = (N_RANKS - 1) * len(gk.ring_shift_launches([dev] * N_RANKS))
    gk.ring_shift = keep_ring_blocks
    try:
        sk_out, sk_line = {}, {}
        for mode in MERGE_ENGINES:
            out, sk_s, launches, cold_s = warm_call(lambda: sharded.knn(
                ring_comms, queries, dataset, K, merge_mode=mode))
            sk_out[mode] = out
            sk_line[mode] = {"first_call_seconds": cold_s, "seconds": sk_s,
                             "qps": N_QUERIES / sk_s, "launches": launches}
            sharded_phases.append(launches)
            if launches["fused_l2_topk"] < N_RANKS:
                raise AssertionError(f"sharded knn ({mode}): each rank must "
                                     "launch fused_l2_topk")
        if sk_line["ring"]["launches"]["ring_shift"] != ring_hops:
            raise AssertionError(
                f"sharded knn (ring) launched ring_shift "
                f"{sk_line['ring']['launches']['ring_shift']} times, "
                f"expected {ring_hops}")
        for mode in ("tree", "ring"):
            if not bitwise_equal(sk_out[mode], sk_out["allgather"]):
                raise AssertionError(f"sharded knn: {mode} differs from "
                                     "allgather")
        sk_agree = assert_topk_close(sk_out["ring"], (gt_v, gt_i),
                                     1e-4 * scale, 1e-5, "sharded knn")
        emit({"phase": "sharded_knn", "ranks": N_RANKS,
              "rows_per_rank": N_ROWS // N_RANKS, "k": K,
              "engines": sk_line, "bitwise_equal_engines": True,
              "vs_brute_force": sk_agree,
              "ring_shift_launches_per_call": ring_hops})
        del sk_out

        def sharded_ivf_phase(name, index, params_of, floor, build_s,
                              build_launches, search, kernel):
            """Ring search until the recall floor is met (probes doubling),
            then the allgather merge on the same index, bitwise equal.
            Returns the probes settled on."""
            n_probes = N_PROBES
            while True:
                sp = params_of(n_probes)
                (v, i), s_s, launches, cold_s = warm_call(
                    lambda: search(index, queries, K, sp, merge_mode="ring"))
                recall = float(neighborhood_recall(i, gt_i))
                if recall >= floor or n_probes >= N_LISTS:
                    break
                n_probes *= 2
            sharded_phases.append(launches)
            gather = search(index, queries, K, sp, merge_mode="allgather")
            emit({"phase": name, "ranks": N_RANKS, "n_lists": N_LISTS,
                  "n_probes": n_probes, "build_seconds": build_s,
                  "build_launches": build_launches,
                  "first_call_seconds": cold_s, "search_seconds": s_s,
                  "qps": N_QUERIES / s_s, "recall_at_10": recall,
                  "bitwise_equal_allgather": bitwise_equal((v, i), gather),
                  "launches": launches})
            if recall < floor:
                raise AssertionError(f"{name} recall {recall} < {floor}")
            if not bitwise_equal((v, i), gather):
                raise AssertionError(f"{name}: ring differs from allgather")
            if launches[kernel] < N_RANKS or launches["select_k"] < N_RANKS \
                    or launches["ring_shift"] != ring_hops:
                raise AssertionError(f"{name}: launches {launches}")
            if v.shape != (N_QUERIES, K) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{name}: distances not finite and "
                                     "complete")
            return n_probes

        gk.reset_launch_counts()
        sf_index, sf_build_s = timed(lambda: sharded.build_ivf_flat(
            ring_comms, dataset, ivf_flat.IndexParams(n_lists=N_LISTS),
            res=Resources(seed=opts.seed)))
        sf_build_launches = launch_counts()
        sharded_phases.append(sf_build_launches)
        # the sharded indexes are kept for phase 6c's checkpoints
        sf_probes = sharded_ivf_phase(
            "sharded_ivf_flat", sf_index,
            lambda p: ivf_flat.SearchParams(n_probes=p), RECALL_FLOOR,
            sf_build_s, sf_build_launches, sharded.search_ivf_flat,
            "fused_ivf_topk")

        gk.reset_launch_counts()
        sp_index, sp_build_s = timed(lambda: sharded.build_ivf_pq(
            ring_comms, dataset, ivf_pq.IndexParams(
                n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=PQ_BITS,
                kmeans_n_iters=20), res=Resources(seed=opts.seed),
            scan_mode="cache"))
        sp_build_launches = launch_counts()
        sharded_phases.append(sp_build_launches)
        for idx in sp_index.indexes:
            engine = ivf_pq.plan_search(idx, K, ivf_pq.SearchParams(
                n_probes=N_PROBES), memory_mode="cache").engine
            if engine != "pallas_cache":
                raise AssertionError(f"sharded_ivf_pq: a rank's engine is "
                                     f"{engine}, expected pallas_cache")
        sp_probes = sharded_ivf_phase(
            "sharded_ivf_pq", sp_index,
            lambda p: ivf_pq.SearchParams(n_probes=p), PQ_RECALL_FLOOR,
            sp_build_s, sp_build_launches, sharded.search_ivf_pq,
            "fused_ivf_topk")
    finally:
        gk.ring_shift = ring_shift

    # sharded k-means; its initial rows are kept to cost its init
    skm_init, draw = [], sharded._initial_rows

    def keep_init(*a):
        skm_init.append(draw(*a))
        return skm_init[-1]

    sharded._initial_rows = keep_init
    try:
        gk.reset_launch_counts()
        (skm_c, skm_l), skm_s = timed(lambda: sharded.kmeans_fit(
            ring_comms, dataset, KM_CLUSTERS, KM_ITERS,
            res=Resources(seed=opts.seed)))
        skm_launches = launch_counts()
    finally:
        sharded._initial_rows = draw
    sharded_phases.append(skm_launches)
    skm_init_c = dataset[torch.sort(skm_init[0].to(dev)).values]
    skm_init_cost = float(kmeans.cluster_cost(dataset, skm_init_c))
    skm_cost = float(kmeans.cluster_cost(dataset, skm_c))
    emit({"phase": "sharded_kmeans", "ranks": N_RANKS, "rows": N_ROWS,
          "n_clusters": KM_CLUSTERS, "n_iters": KM_ITERS,
          "fit_seconds": skm_s, "inertia": skm_cost,
          "initial_centres_cost": skm_init_cost, "launches": skm_launches})
    if not (skm_cost < skm_init_cost and bool(torch.isfinite(skm_c).all())):
        raise AssertionError(f"sharded k-means inertia {skm_cost} is not "
                             f"below its initial centres' {skm_init_cost}")
    if skm_l.shape != (N_ROWS,) or bool((skm_l < 0).any()) \
            or bool((skm_l >= KM_CLUSTERS).any()):
        raise AssertionError("sharded k-means labels out of range")
    del skm_c, skm_l
    # one iteration from the same initial rows, held against a float64
    # M-step over every rank's rows at once: a rank's sums or counts left
    # out of the allreduce, or two ranks' swapped, move a centre far past
    # the tolerance
    sharded._initial_rows = lambda *a: skm_init[0]
    try:
        one_c, _ = sharded.kmeans_fit(ring_comms, dataset, KM_CLUSTERS, 1,
                                      res=Resources(seed=opts.seed))
    finally:
        sharded._initial_rows = draw
    rank_rows = -(-N_ROWS // N_RANKS)
    one_lab = torch.cat([sharded._assign(dataset[lo:lo + rank_rows],
                                         skm_init_c)
                         for lo in range(0, N_ROWS, rank_rows)])
    one_cnt = torch.bincount(one_lab, minlength=KM_CLUSTERS)
    one_ref = torch.zeros((KM_CLUSTERS, DIM), dtype=torch.float64,
                          device=dev).index_add_(0, one_lab, dataset.double())
    one_ref = torch.where((one_cnt > 0)[:, None],
                          one_ref / one_cnt.clamp_min(1)[:, None],
                          skm_init_c.double())
    one_err = float((one_c.double() - one_ref).abs().max())
    one_tol = 1e-5 * float(one_ref.abs().max())
    emit({"phase": "sharded_kmeans_one_step", "max_abs_err": one_err,
          "tolerance": one_tol, "reference": "float64 M-step of all rows"})
    if not one_err <= one_tol:
        raise AssertionError(f"sharded k-means step differs from the "
                             f"all-rows M-step by {one_err} > {one_tol}")
    del one_c, one_lab, one_ref, skm_init_c

    main_phases = (bf_launches, ivf_launches, pq_build_launches,
                   pq_cache_launches, pq_lut_launches, refine_launches,
                   cg_build_launches, cagra_launches, km_launches,
                   fl_launches, pqf_launches, ip_launches, *sharded_phases)
    main_launches = {name: sum(ph[name] for ph in main_phases)
                     for name in gk.LAUNCHES}
    main_shapes = {}  # select_k's launches by "caller:n:k"
    for ph in main_phases:
        for key, count in ph.get("select_k_shapes", {}).items():
            main_shapes[key] = main_shapes.get(key, 0) + count
    if sum(main_shapes.values()) != main_launches["select_k"]:
        raise AssertionError("select_k's launches by shape do not add up")

    # ---- 6. each kernel against its plain version, at the main path's
    # shapes (launches here are not counted in the kernels line)
    def bound(n_bytes, n_ops):
        """The least time of the work on the H100's data-sheet peaks:
        ``obs.costs.roofline_bound``, the formula the cost report and the
        sweep's roofline floors use too."""
        return obs_costs.roofline_bound(n_bytes, n_ops, PEAKS)

    def check(entry, kernel, plain, args, atol, rtol, reps):
        """Hold kernel(*args) against plain(*args), time both, add the
        kernel's entry to the kernels line."""
        res = assert_topk_close(kernel(*args), plain(*args), atol, rtol,
                                entry["name"])
        torch.cuda.synchronize()
        entry.update(agrees_with_plain=True, **res,
                     ms=cuda_ms(lambda: kernel(*args), reps),
                     plain_ms=cuda_ms(lambda: plain(*args), 1, False))
        kernels.append(entry)
        emit({"phase": "kernel_check", **entry})

    def adc_scale(plain, args):
        """The largest finite distance of the plain result: the scale of the
        ADC distances' tolerance."""
        v = plain(*args)[0]
        return float(v[torch.isfinite(v)].abs().max())

    def l2_topk_entry(m, n, launches):
        """fused_l2_topk's row: the fp32 bound outside the tensor cores (the
        products as FMA at 67 TFLOP/s) and the 3xTF32 bound of the design
        (three TF32 products at 495 TFLOP/s)."""
        work = obs_costs.l2_topk_work(m, n, DIM, K)
        return dict(name="fused_l2_topk", route="cuda",
                    source="raft_tpu_torch/csrc/fused_l2_topk.cu",
                    replaces=REPLACES["fused_l2_topk"],
                    shape=f"{m} x {n} x {DIM}, k={K}", launches=launches,
                    library_ms=None, **bound(*work),
                    **obs_costs.tf32_bound(*work, PEAKS),
                    plan=dataclasses.asdict(gk.plan_fused_topk(
                        m, n, DIM, K, n_sm)))

    kernels, ab_cases = [], {}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    x = queries
    xn, yn = row_norms_sq(x), bf.norms
    scale = float(torch.maximum(xn.max(), yn.max()))
    m, n = N_QUERIES, N_ROWS
    sharded_l2 = sum(ph["fused_l2_topk"] for ph in sharded_phases)
    args = (x, dataset, K, xn, yn)
    check(l2_topk_entry(m, n, main_launches["fused_l2_topk"] - sharded_l2),
          gk.fused_l2_topk, gk.fused_l2_topk_plain, args, 1e-4 * scale, 1e-5,
          3)
    ab_cases["fused_l2_topk"] = ("fused_l2_topk", args, 3)
    # one rank's search of the sharded kNN: a 250,000-row shard
    shard = dataset[:N_ROWS // N_RANKS]
    args = (x, shard, K, xn, yn[:N_ROWS // N_RANKS])
    check(l2_topk_entry(m, shard.shape[0], sharded_l2), gk.fused_l2_topk,
          gk.fused_l2_topk_plain, args, 1e-4 * scale, 1e-5, 5)
    ab_cases["fused_l2_topk_shard"] = ("fused_l2_topk", args, 5)

    ivf_model = {}

    def check_ivf(label, shape, args, sizes, atol, launches):
        """fused_ivf_topk against its plain version (values within atol +
        1e-5·|v|, ids equal away from near-ties), bitwise equal over two
        runs, with the plan that ran. The bound counts the probes, queries
        and norms once, each probed slab with its norms and ids once, the
        result once, and 2·rot operations a filled slot scanned. The design's
        slab traffic goes to the read model: each group of 32 pairs reads
        its list's filled chunks (rows, norms, ids) and the run's ids,
        each pair its query once, and the partials are written and read
        once, against every probed row once per (query, probe) for the
        per-query design."""
        pr, qr, qn_, data_, norms_, ids_, k_ = args[:7]
        got = gk.fused_ivf_topk(*args)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, gk.fused_ivf_topk(*args))):
            raise AssertionError(f"fused_ivf_topk ({label}): two runs differ")
        nq_, n_pr = pr.shape
        n_lists_, pad_, rot_ = data_.shape
        elem = data_.element_size()
        plan = gk.plan_fused_ivf(nq_, n_pr, n_lists_, pad_, rot_, k_, elem,
                                 n_sm)
        rows_scanned = int(sizes[pr.long()].sum())
        n_probed = torch.unique(pr.long()).numel()
        per_list = torch.bincount(pr.long().flatten(), minlength=n_lists_)
        row_bytes = rot_ * elem + 4 + 4
        filled = -(-sizes.long() // gk.IVF_SCAN_SLOTS) * gk.IVF_SCAN_SLOTS
        groups = -(-per_list // gk.IVF_SCAN_GROUP)
        ivf_model[label] = {
            "grouped_bytes": int((groups * (filled * row_bytes + pad_ * 4))
                                 .sum()) + nq_ * n_pr * rot_ * 4
            + 2 * nq_ * n_pr * plan.runs * k_ * 8,
            "per_query_bytes": rows_scanned * rot_ * elem,
            "groups": int(groups.sum())}
        ab_cases[f"fused_ivf_topk_{label}"] = ("fused_ivf_topk", args, 5)
        check(dict(name="fused_ivf_topk", route="cuda",
                   source="raft_tpu_torch/csrc/fused_ivf_topk.cu",
                   replaces=REPLACES["fused_ivf_topk"],
                   shape=shape, launches=launches, library_ms=None,
                   rows_scanned=rows_scanned, bitwise_repeatable=True,
                   kernel_route=plan.route, plan=dataclasses.asdict(plan),
                   **bound(*obs_costs.ivf_topk_work(
                       nq_, n_pr, rot_, pad_, elem, k_, n_probed,
                       rows_scanned))),
              gk.fused_ivf_topk, gk.fused_ivf_topk_plain, args, atol, 1e-5, 5)

    # the IVF kernel's inputs, as the fused IVF-Flat search builds them
    qf = queries.to(torch.float32)
    scores, _ = ivf_flat._coarse_scores(qf, index.centers, index.metric)
    scores = scores.contiguous()
    _, probes = gk.streaming_select_k(scores, n_probes)
    qv = qf[:, None, :].expand(N_QUERIES, n_probes, DIM).contiguous()
    qn = row_norms_sq(qf)[:, None].expand(N_QUERIES, n_probes).contiguous()
    pad = index.list_data.shape[1]
    check_ivf("ivf_flat", f"ivf_flat: {N_QUERIES} queries x {n_probes} "
              f"probes, pad {pad}, rot {DIM}, f32, clamp",
              (probes, qv, qn, index.list_data, index.ensure_row_norms(),
               index.safe_ids(), K), index.list_sizes, 1e-4 * scale,
              ivf_launches["fused_ivf_topk"])
    del qv, qn

    # the IVF-PQ cache regime's kernel inputs, as _search_fused_cache_core
    # builds them
    rot = pq_index.rot_dim
    pq_sizes = pq_index.list_sizes.long()
    q_rot, centers_rot, pq_pr = ivf_pq._coarse_probes_rot(queries, pq_index,
                                                         pq_probes)
    qr_res = (q_rot[:, None, :] - centers_rot[pq_pr.long()]).contiguous()
    qr_n = (qr_res * qr_res).sum(-1).contiguous()
    args = (pq_pr, qr_res, qr_n, pq_cache[0], pq_cache[1],
            pq_index.safe_ids(), K, False)
    check_ivf("ivf_pq_cache", f"ivf_pq cache: {N_QUERIES} queries x "
              f"{pq_probes} probes, pad {pq_pad}, rot {rot}, bf16, no clamp",
              args, pq_index.list_sizes,
              1e-4 * adc_scale(gk.fused_ivf_topk_plain, args),
              pq_cache_launches["fused_ivf_topk"])
    del pq_cache, args, qr_res

    # the LUT regime's kernel inputs, as _search_fused_lut_core builds them,
    # at the LUT phase's probes (k) and at refine's (2k candidates)
    codebooks = pq_index.codebooks.contiguous()
    cb_norms = (codebooks * codebooks).sum(-1).contiguous()
    pq_len = pq_index.pq_len
    pq_model = {}

    def check_pq(label, probes_n, k_, launches):
        """fused_pq_topk against its plain version (values within
        1e-4·the largest ADC distance + 1e-5·|v|, ids as assert_topk_close
        holds them), bitwise equal over two runs, with the plan that ran.
        The bound counts the probes, queries, centres, codebooks and norms
        once, each probed list's codes and ids once, the result once, and
        the operations: each LUT's entries (2·pq_len + 2 each) and one add a
        (row, subspace) scanned; the design figure ``bound_smem_ms`` counts
        the lookups, one shared-memory read a (row, pair, subspace), at 32
        a clock on each SM at the card's largest SM clock."""
        q_rot, centers_rot, pr = ivf_pq._coarse_probes_rot(queries, pq_index,
                                                           probes_n)
        args = (pr, q_rot, centers_rot, codebooks, cb_norms,
                pq_index.list_codes, pq_index.safe_ids(), k_)
        got = gk.fused_pq_topk(*args)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, gk.fused_pq_topk(*args))):
            raise AssertionError(f"fused_pq_topk ({label}): two runs differ")
        del got
        rows_scanned = int(pq_sizes[pr.long()].sum())
        n_probed = torch.unique(pr.long()).numel()
        n_luts = pr.numel()
        plan = gk.plan_fused_pq(N_QUERIES, probes_n, N_LISTS, pq_pad, PQ_DIM,
                                pq_len, k_)
        per_list = torch.bincount(pr.long().flatten(), minlength=N_LISTS)
        groups = -(-per_list // gk.IVF_SCAN_GROUP)
        run_rows = gk.PQ_ROWS_PER_WARP * plan.warps
        filled_runs = -(-pq_sizes // run_rows)  # runs with a filled slot
        pq_model[label] = {
            "codes_and_ids_bytes_grouped": int((groups * pq_sizes).sum())
            * (PQ_DIM + 4),
            "codes_and_ids_bytes_per_pair": rows_scanned * (PQ_DIM + 4),
            "codebook_bytes_grouped": int((groups * filled_runs).sum())
            * PQ_DIM * 256 * (pq_len + 1) * 4,
            "codebook_bytes_per_pair": n_luts * PQ_DIM * 256
            * (pq_len + 1) * 4,
            "groups": int(groups.sum()),
            "lut_builds": int((groups * filled_runs).sum())}
        ab_cases[f"fused_pq_topk_{label}"] = ("fused_pq_topk", args, 3)
        lookups = rows_scanned * PQ_DIM
        check(dict(name="fused_pq_topk", route="cuda",
                   source="raft_tpu_torch/csrc/fused_pq_topk.cu",
                   replaces=REPLACES["fused_pq_topk"],
                   shape=f"{label}: {N_QUERIES} queries x {probes_n} probes,"
                         f" pad {pq_pad}, pq_dim {PQ_DIM}, pq_len {pq_len}, "
                         f"k={k_}",
                   launches=launches, library_ms=None,
                   rows_scanned=rows_scanned, luts=n_luts,
                   bitwise_repeatable=True, kernel_route=plan.route,
                   plan=dataclasses.asdict(plan),
                   bound_smem_ms=1e3 * lookups / (32 * n_sm * sm_clock_hz),
                   **bound(*obs_costs.pq_topk_work(
                       N_QUERIES, probes_n, q_rot.shape[1], N_LISTS, PQ_DIM,
                       pq_len, pq_pad, k_, n_probed, rows_scanned))),
              gk.fused_pq_topk, gk.fused_pq_topk_plain, args,
              1e-4 * adc_scale(gk.fused_pq_topk_plain, args), 1e-5, 3)

    check_pq("ivf_pq_lut", lut_probes, K, pq_lut_launches["fused_pq_topk"])
    check_pq("ivf_pq_refine", refine_probes, 2 * K,
             refine_launches["fused_pq_topk"])

    # select_k at each shape the main path launched it: the coarse probe
    # selection over [nq, n_lists] scores, and the per-query merges of
    # fused_l2_topk's database ranges and of the grouped routes' (pair, run)
    # partials, whose rows are rebuilt as the kernels write them (each
    # range's, or each pair and run's, top k from the kernel over that range
    # or that probe and run alone, in (range) or (probe, run, rank) order,
    # with their ids) and selected through select_k's C entry with the ids,
    # as the fused kernels launch it; timed from CUDA graphs (the shorter
    # calls take less device time than a launch takes on the host) and
    # eagerly
    def l2_range_rows(n_sel):
        for size in (N_ROWS, N_ROWS // N_RANKS):
            plan = gk.plan_fused_topk(N_QUERIES, size, DIM, K, n_sm)
            if plan.splits * K != n_sel:
                continue
            vs, ids_ = [], []
            for lo in range(0, size, plan.split_len):
                hi = min(lo + plan.split_len, size)
                v, i = gk.fused_l2_topk(x, dataset[lo:hi], K, xn, yn[lo:hi])
                vs.append(v)
                ids_.append(torch.where(i >= 0, i + lo, -1))
            return (torch.stack(vs, 1).reshape(N_QUERIES, -1),
                    torch.stack(ids_, 1).reshape(N_QUERIES, -1))
        raise AssertionError(f"fused_l2_topk merges {n_sel} candidates a "
                             "query at no planned shape")

    def pair_run_rows(call, n_pr, pad_, run_len):
        runs_ = [(lo, min(lo + run_len, pad_)) for lo in range(0, pad_,
                                                               run_len)]
        vs, ids_ = [], []
        for p in range(n_pr):
            for lo, hi in runs_:
                v, i = call(p, lo, hi)
                vs.append(v)
                ids_.append(i)
        return (torch.stack(vs, 1).reshape(N_QUERIES, -1).contiguous(),
                torch.stack(ids_, 1).reshape(N_QUERIES, -1).contiguous())

    def ivf_rows(n_sel):
        plan = gk.plan_fused_ivf(N_QUERIES, n_probes, N_LISTS, pad, DIM, K, 4,
                                 n_sm)
        if n_probes * plan.runs * K != n_sel:
            raise AssertionError(f"fused_ivf_topk merges {n_sel} candidates "
                                 "a query at no planned shape")
        q1 = qf[:, None, :].contiguous()
        n1 = row_norms_sq(qf)[:, None].contiguous()
        run_len = plan.chunks_per_run * gk.IVF_SCAN_SLOTS
        data_, norms_, ids_ = (index.list_data, index.ensure_row_norms(),
                               index.safe_ids())

        def call(p, lo, hi):
            sl = slice(lo, hi)
            return gk.fused_ivf_topk(
                probes[:, p:p + 1].contiguous(), q1, n1,
                data_[:, sl].contiguous(), norms_[:, sl].contiguous(),
                ids_[:, sl].contiguous(), K)
        return pair_run_rows(call, n_probes, pad, run_len)

    def pq_rows(n_sel, k_sel):
        for probes_n in (lut_probes, refine_probes):
            plan = gk.plan_fused_pq(N_QUERIES, probes_n, N_LISTS, pq_pad,
                                    PQ_DIM, pq_len, k_sel)
            if probes_n * plan.runs * k_sel == n_sel:
                break
        else:
            raise AssertionError(f"fused_pq_topk merges {n_sel} candidates "
                                 "a query at no planned shape")
        q_rot, centers_rot, pr = ivf_pq._coarse_probes_rot(queries, pq_index,
                                                           probes_n)
        codes, ids_ = pq_index.list_codes, pq_index.safe_ids()
        run_len = gk.PQ_ROWS_PER_WARP * plan.warps
        cut = {}

        def call(p, lo, hi):
            if (lo, hi) not in cut:
                cut[(lo, hi)] = (codes[:, lo:hi].contiguous(),
                                 ids_[:, lo:hi].contiguous())
            return gk.fused_pq_topk(pr[:, p:p + 1].contiguous(), q_rot,
                                    centers_rot, codebooks, cb_norms,
                                    *cut[(lo, hi)], k_sel)
        return pair_run_rows(call, probes_n, pq_pad, run_len)

    qf = queries.to(torch.float32)
    for key in sorted(main_shapes):
        caller, n_sel, k_sel = key.split(":")
        n_sel, k_sel = int(n_sel), int(k_sel)
        if caller == "select_k" and n_sel == N_LISTS:
            vals, ids_ = scores, None
        elif caller == "fused_l2_topk" and k_sel == K:
            vals, ids_ = l2_range_rows(n_sel)
        elif caller == "fused_ivf_topk" and k_sel == K:
            vals, ids_ = ivf_rows(n_sel)
        elif caller == "fused_pq_topk":
            vals, ids_ = pq_rows(n_sel, k_sel)
        else:
            raise AssertionError(f"select_k launched at {key}, a shape this "
                                 "script has no inputs for")
        if tuple(vals.shape) != (N_QUERIES, n_sel):
            raise AssertionError(f"select_k {key}: rows {tuple(vals.shape)}")
        if ids_ is None:
            def kernel(v=vals, kk=k_sel):
                return gk.streaming_select_k(v, kk)
            ab_cases[f"select_k_{key}"] = ("streaming_select_k",
                                           (vals, k_sel), 20, True)
        else:
            def kernel(v=vals, i=ids_, kk=k_sel):
                return select_k_rows(v, i, kk)
            ab_cases[f"select_k_{key}"] = ("select_k_rows",
                                           (vals, ids_, k_sel), 20, True)

        def plain(v=vals, i=ids_, kk=k_sel):
            return gk._stable_topk(v, kk, i)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"select_k {key} differs from its plain "
                                 "version")
        del got, want
        entry = dict(
            name="select_k", route="cuda",
            source="raft_tpu_torch/csrc/select_k.cu",
            replaces=REPLACES["select_k"],
            shape=(f"[{N_QUERIES} x {n_sel}], k={k_sel}"
                   + ("" if ids_ is None else ", with ids")
                   + f" ({caller})"),
            launches=main_shapes[key], agrees_with_plain=True, bitwise=True,
            max_abs_err=0.0, kernel_route=gk.plan_select_k(n_sel,
                                                           k_sel).route,
            plan=dataclasses.asdict(gk.plan_select_k(n_sel, k_sel)),
            ms=graph_ms(kernel, 20), ms_eager=cuda_ms(kernel, 20),
            plain_ms=graph_ms(plain, 3),
            library_ms=graph_ms(lambda v=vals, kk=k_sel: torch.topk(
                v, kk, largest=False), 20),
            ab_case=f"select_k_{key}",
            **bound(*obs_costs.select_k_work(N_QUERIES, n_sel, k_sel,
                                             ids_ is not None)))
        kernels.append(entry)
        emit({"phase": "kernel_check", **entry})
        del vals, ids_

    # the beam walk: each row it touches read once, each node's graph row
    # once; a dot product per (query, row) scored and one norm per row
    n_seeds = cg_plan.plan["n_seeds"]
    cg_kplan = gk.plan_fused_cagra(itopk, DIM, 1, CAGRA_DEGREE)
    got = gk.fused_cagra_topk(*cg_args, K, itopk, 1, cg_max_iter)
    want = gk.fused_cagra_topk_plain(*cg_args, K, itopk, 1, cg_max_iter)
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])):
        raise AssertionError("fused_cagra_topk differs from its plain version")
    del got, want
    ab_cases["fused_cagra_topk"] = (
        "fused_cagra_topk", (*cg_args, K, itopk, 1, cg_max_iter), 3)
    check(dict(name="fused_cagra_topk", route="cuda",
               source="raft_tpu_torch/csrc/fused_cagra_topk.cu",
               replaces=REPLACES["fused_cagra_topk"],
               shape=f"cagra: {N_QUERIES} queries, itopk {itopk}, width 1, "
                     f"degree {CAGRA_DEGREE}, dim {DIM}, {n_seeds} seeds, "
                     f"max_iter {cg_max_iter}",
               launches=cagra_launches["fused_cagra_topk"], library_ms=None,
               hops=cg_hops, rows_scored=cg_rows, rows_touched=cg_touched,
               nodes_expanded=cg_expanded, bitwise=True,
               gather_ms=1e3 * cg_rows * DIM * 4 / PEAKS.hbm_bytes_per_s,
               kernel_route=cg_kplan.route,
               plan=dataclasses.asdict(cg_kplan),
               **bound(*obs_costs.cagra_topk_work(
                   N_QUERIES, DIM, CAGRA_DEGREE, K, n_seeds, cg_touched,
                   cg_expanded, cg_rows))),
          lambda *a: gk.fused_cagra_topk(*a, K, itopk, 1, cg_max_iter),
          lambda *a: gk.fused_cagra_topk_plain(*a, K, itopk, 1, cg_max_iter),
          cg_args, 0.0, 0.0, 5)

    # the k-means E-step: the dataset against the final centres, clamped;
    # ids must equal away from near-ties (the two nearest centres further
    # apart than twice the tolerance, by fused_l2_topk's k=2)
    x_n = row_norms_sq(dataset)
    c_n = row_norms_sq(km_centers)
    args = (dataset, km_centers, x_n, c_n, True)
    got_v, got_i = gk.fused_l2_argmin(*args)
    again = gk.fused_l2_argmin(*args)
    if not (torch.equal(got_v.view(torch.int32), again[0].view(torch.int32))
            and torch.equal(got_i, again[1])):
        raise AssertionError("fused_l2_argmin: two runs differ")
    del again
    want_v, want_i = gk.fused_l2_argmin_plain(*args)
    top2_v, _ = gk.fused_l2_topk(dataset, km_centers, 2, x_n, c_n)
    clear = (top2_v[:, 1] - top2_v[:, 0]) > 2 * km_tol
    err = float((got_v - want_v).abs().max())
    bad_v = int(((got_v - want_v).abs() > km_tol + 1e-5 * want_v.abs()).sum())
    bad_i = int(((got_i != want_i) & clear).sum())
    if bad_v or bad_i:
        raise AssertionError(f"fused_l2_argmin: {bad_v} values and {bad_i} "
                             "ids away from near-ties differ from the plain "
                             "version")
    torch.cuda.synchronize()
    m, n = N_ROWS, KM_CLUSTERS
    work = obs_costs.l2_argmin_work(m, n, DIM)
    plan = gk.plan_fused_argmin(m, n, DIM)
    ab_cases["fused_l2_argmin"] = ("fused_l2_argmin", args, 5)
    entry = dict(
        name="fused_l2_argmin", route="cuda",
        source="raft_tpu_torch/csrc/fused_l2_argmin.cu",
        replaces=REPLACES["fused_l2_argmin"],
        shape=f"k-means E-step: {m} x {n} x {DIM}, clamp",
        launches=km_launches["fused_l2_argmin"], library_ms=None,
        agrees_with_plain=True, max_abs_err=err, bitwise_repeatable=True,
        id_agreement=float((got_i == want_i).float().mean()),
        ids_clear_of_ties=int(clear.sum()),
        kernel_route=plan.route, plan=dataclasses.asdict(plan),
        ms=cuda_ms(lambda: gk.fused_l2_argmin(*args), 5),
        plain_ms=cuda_ms(lambda: gk.fused_l2_argmin_plain(*args), 1, False),
        **bound(*work), **obs_costs.tf32_bound(*work, PEAKS))
    kernels.append(entry)
    emit({"phase": "kernel_check", **entry})
    del got_v, got_i, want_v, want_i, top2_v, clear, x_n, args

    scan_model = {}

    def check_scan(label, entry, args, reps):
        """ivf_scan against its plain version on one query tile: values
        within 1e-4·max‖row‖² + 1e-5·|v|, and bitwise equal over two runs;
        the bound counts each probed slab and its norms read once, the
        queries and probes, the partials written once, and 2·rot operations
        a slot. The design's slab traffic goes to the read model: each
        probed slab and its norms once per group of up to 32 of its pairs,
        each pair's query once per 64-slot chunk (against once per pair for
        the slab, in the one-block-per-pair design it replaces)."""
        probes_t, qres_t, data_t, norms_t = args
        got = gk.ivf_scan(*args)
        again = gk.ivf_scan(*args)
        want = gk.ivf_scan_plain(*args)
        atol = 1e-4 * float(norms_t.max())
        err = float((got - want).abs().max())
        if bool(((got - want).abs() > atol + 1e-5 * want.abs()).any()):
            raise AssertionError(f"ivf_scan ({entry['shape']}): differs from "
                                 f"the plain version by up to {err}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"ivf_scan ({entry['shape']}): two runs "
                                 "differ")
        torch.cuda.synchronize()
        t, n_pr = probes_t.shape
        n_lists_, pad_, rot_ = data_t.shape
        slots = t * n_pr * pad_
        n_probed = torch.unique(probes_t.long()).numel()
        per_list = torch.bincount(probes_t.long().flatten(),
                                  minlength=n_lists_)
        groups = int((-(-per_list // gk.IVF_SCAN_GROUP)).sum())
        slab_row = rot_ * data_t.element_size() + 4
        scan_model[label] = {
            "grouped_bytes": groups * pad_ * slab_row
            + t * n_pr * -(-pad_ // gk.IVF_SCAN_SLOTS) * rot_ * 4 + 4 * slots,
            "per_pair_bytes": t * n_pr * pad_ * slab_row + 4 * slots,
            "groups": groups}
        ab_cases[f"ivf_scan_{label}"] = ("ivf_scan", args, reps)
        entry.update(
            route="cuda", source="raft_tpu_torch/csrc/ivf_scan.cu",
            replaces=REPLACES["ivf_scan"], library_ms=None,
            agrees_with_plain=True, max_abs_err=err,
            ms=cuda_ms(lambda: gk.ivf_scan(*args), reps),
            plain_ms=cuda_ms(lambda: gk.ivf_scan_plain(*args), 1, False),
            **bound(*obs_costs.ivf_scan_work(
                t, n_pr, rot_, pad_, data_t.element_size(), n_probed)))
        kernels.append(entry)
        emit({"phase": "kernel_check", **entry})

    # one query tile of the filtered IVF-Flat search, as _search_core
    # builds it
    fl_tile = ivf_flat.plan_scan_tiles(fl_probes, index.list_data.shape[1],
                                       DIM, Resources().workspace_limit_bytes)
    qt = queries[:fl_tile].to(torch.float32)
    sc, _ = ivf_flat._coarse_scores(qt, index.centers, index.metric)
    _, fl_pr = select_k(sc, fl_probes)
    fl_pr = fl_pr.to(torch.int32).contiguous()
    check_scan("ivf_flat_filtered", dict(name="ivf_scan",
                    shape=f"ivf_flat filtered: one tile of {qt.shape[0]} "
                          f"queries x {fl_probes} probes, pad "
                          f"{index.list_data.shape[1]}, rot {DIM}, f32",
                    launches=fl_launches["ivf_scan"]),
               (fl_pr, qt[:, None, :].expand(-1, fl_probes, -1).contiguous(),
                index.list_data, index.ensure_row_norms()), 5)

    # one query tile of the inner-product IVF-Flat search (rot 100)
    ip_tile = ivf_flat.plan_scan_tiles(ip_probes, ip_index.list_data.shape[1],
                                       IP_DIM,
                                       Resources().workspace_limit_bytes)
    qt = ip_queries[:ip_tile].to(torch.float32)
    sc, smin = ivf_flat._coarse_scores(qt, ip_index.centers, ip_index.metric)
    _, ip_pr = select_k(sc, ip_probes, select_min=smin)
    check_scan("ivf_flat_inner_product", dict(name="ivf_scan",
                    shape=f"ivf_flat inner product: one tile of "
                          f"{qt.shape[0]} queries x {ip_probes} probes, pad "
                          f"{ip_index.list_data.shape[1]}, rot {IP_DIM}, f32",
                    launches=ip_launches["ivf_scan"]),
               (ip_pr.to(torch.int32).contiguous(),
                qt[:, None, :].expand(-1, ip_probes, -1).contiguous(),
                ip_index.list_data, ip_index.ensure_row_norms()), 5)

    # one query tile of the filtered IVF-PQ cache engine, as
    # _search_cache_core builds it (L2: the per-probe residuals)
    pq_tile = ivf_pq.plan_search(pq_index, K,
                                 ivf_pq.SearchParams(n_probes=pqf_probes),
                                 True, res=card_res).plan["q_tile"]
    q_rot = queries[:pq_tile] @ pq_index.rotation.T
    pq_pr, _ = ivf_pq._coarse(q_rot, pq_index.centers_rot, pqf_probes,
                              pq_index.metric, 1.0)
    qr_res = (q_rot[:, None, :] - pq_index.centers_rot[pq_pr]).contiguous()
    check_scan("ivf_pq_filtered", dict(name="ivf_scan",
                    shape=f"ivf_pq cache filtered: one tile of "
                          f"{q_rot.shape[0]} queries x {pqf_probes} probes, "
                          f"pad {pq_pad}, rot {rot}, bf16",
                    launches=pqf_launches["ivf_scan"]),
               (pq_pr.to(torch.int32).contiguous(), qr_res,
                pq_index.list_decoded, pq_index.decoded_norms), 5)

    # the ring merge's hop: the [3, nq, k] f32 blocks of the sharded knn's
    # first ring call, bitwise against the plain version; a hop (every rank's
    # block, one launch a source device) from CUDA graphs (a launch costs
    # about as much as one block's copy) and eagerly; the library yardstick
    # is one torch._foreach_copy_ of the hop's blocks, beside a Tensor.copy_
    # a block
    blocks = ring_blocks
    got, want = gk.ring_shift(blocks), gk.ring_shift_plain(blocks)
    for r in range(N_RANKS):
        if not torch.equal(got[r].view(torch.int32), want[r].view(torch.int32)):
            raise AssertionError("ring_shift differs from its plain version")
    torch.cuda.synchronize()
    block_bytes = blocks[0].numel() * blocks[0].element_size()
    copies = [torch.empty_like(b) for b in blocks]

    def foreach_copy():
        torch._foreach_copy_(copies, blocks)

    def copy_loop():
        for c, b in zip(copies, blocks):
            c.copy_(b)

    ab_cases["ring_shift"] = ("ring_shift", (blocks,), 20, True)
    entry = dict(
        name="ring_shift", route="cuda",
        source="raft_tpu_torch/csrc/ring_shift.cu",
        replaces=REPLACES["ring_shift"],
        shape=f"ring merge hop: {N_RANKS} ranks on one card, blocks "
              f"{list(blocks[0].shape)} f32 ({block_bytes} bytes each), a "
              "hop (all ranks)",
        launches=main_launches["ring_shift"],
        launches_per_hop=len(gk.ring_shift_launches([dev] * N_RANKS)),
        agrees_with_plain=True, max_abs_err=0.0, bitwise=True,
        ms=graph_ms(lambda: gk.ring_shift(blocks), 20),
        ms_eager=cuda_ms(lambda: gk.ring_shift(blocks), 50),
        plain_ms=graph_ms(lambda: gk.ring_shift_plain(blocks), 20),
        library_ms=graph_ms(foreach_copy, 20),
        library_copy_loop_ms=graph_ms(copy_loop, 20),
        ab_case="ring_shift",
        **bound(*obs_costs.ring_shift_work(N_RANKS, block_bytes)))
    kernels.append(entry)
    emit({"phase": "kernel_check", **entry})
    del got, want, copies

    # a model, not a measurement: the grouped kernels' traffic against the
    # per-pair designs they replace (check_ivf, check_pq, check_scan: the
    # LUT kernel's codes and ids once per group of pairs against once per
    # pair, its codebooks and their norms once per LUT build against once
    # per (query, probe)), and the beam walk's rows once per visit and its
    # graph rows once per hop; nothing in the run measures it
    emit({"phase": "read_model", "measured": False,
          "fused_ivf_topk": ivf_model, "fused_pq_topk": pq_model,
          "fused_cagra_topk_visit_bytes": cg_rows * DIM * 4
          + cg_hops * CAGRA_DEGREE * 4,
          "ivf_scan": scan_model})

    # the parent tree's planned kernels on the same inputs, in turns with
    # this tree's (parent, this, this, parent), one process each
    if opts.parent:
        ab_path = gk.BUILD_DIR / "ab_inputs.pt"
        ab_path.parent.mkdir(parents=True, exist_ok=True)
        from raft_tpu_torch.bench.kernel_ab import save_inputs
        save_inputs(ab_path, ab_cases)
        here = Path(__file__).resolve().parent
        runs = time_trees(ab_path, [opts.parent, here, here, opts.parent])
        ab_path.unlink()
        emit({"phase": "parent_ab", "parent": opts.parent,
              "order": ["parent", "this", "this", "parent"],
              "runs": [r["ms"] for r in runs]})
    names = {"fused_l2_topk": iter(("fused_l2_topk", "fused_l2_topk_shard")),
             "fused_ivf_topk": iter(("fused_ivf_topk_ivf_flat",
                                     "fused_ivf_topk_ivf_pq_cache")),
             "fused_pq_topk": iter(("fused_pq_topk_ivf_pq_lut",
                                    "fused_pq_topk_ivf_pq_refine")),
             "fused_cagra_topk": iter(("fused_cagra_topk",)),
             "fused_l2_argmin": iter(("fused_l2_argmin",)),
             "ivf_scan": iter(("ivf_scan_ivf_flat_filtered",
                               "ivf_scan_ivf_flat_inner_product",
                               "ivf_scan_ivf_pq_filtered"))}
    for kern in kernels:
        case = kern.pop("ab_case", None)
        if case is None and kern["name"] in names:
            case = next(names[kern["name"]])
        if case is not None:
            kern["parent_ms"] = kern["ab_ms"] = None
            if opts.parent:
                kern["parent_ms"] = (runs[0]["ms"][case]
                                     + runs[3]["ms"][case]) / 2
                kern["ab_ms"] = (runs[1]["ms"][case] + runs[2]["ms"][case]) / 2

    for kern in kernels:
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} was not launched on the "
                                 "main path")

    # ---- 6b. serving: each index above behind a serving Engine, single
    # requests from closed-loop submitter threads, 8 then 64 of them; then
    # each kernel of the served path against its plain version at buckets
    # 8 and 64
    from raft_tpu_torch import serving
    from raft_tpu_torch.bench.serve_load import BatchSink, closed_loop, \
        summarize

    q_host = queries[:SERVE_QUERIES].cpu().numpy()
    served = {
        "brute_force": (serving.brute_force_searcher(bf), None),
        "ivf_flat": (serving.ivf_flat_searcher(
            index, ivf_flat.SearchParams(n_probes=n_probes)), RECALL_FLOOR),
        "ivf_pq_cache": (serving.ivf_pq_searcher(
            pq_index, ivf_pq.SearchParams(n_probes=pq_probes),
            res=card_res), PQ_RECALL_FLOOR),
        "ivf_pq_lut": (serving.ivf_pq_searcher(
            pq_index, ivf_pq.SearchParams(n_probes=lut_probes),
            res=lut_res), PQ_RECALL_FLOOR),
        "cagra": (serving.cagra_searcher(cg_index, cagra.SearchParams(
            itopk_size=itopk, search_width=1)), CAGRA_RECALL_FLOOR)}
    # launches by (family, bucket, kernel) while a load runs
    bucket_launches, counting = {}, [None]

    def counted(family, searcher):
        inner = searcher.search

        def search(q, k_):
            before = dict(gk.LAUNCHES)
            out = inner(q, k_)
            if counting[0] is not None:
                for name, n in gk.LAUNCHES.items():
                    key = (family, q.shape[0], name)
                    bucket_launches[key] = (bucket_launches.get(key, 0)
                                            + n - before[name])
            return out
        searcher.search = search

    for family, (searcher, _) in served.items():
        counted(family, searcher)
    sample = np.random.default_rng(opts.seed).choice(SERVE_QUERIES,
                                                    SERVE_SAMPLE,
                                                    replace=False)
    serve_launches = {name: 0 for name in gk.LAUNCHES}
    served_recall = {}  # (family, submitters) -> recall@10 (phase 6g's)
    for family, (searcher, floor) in served.items():
        for n_threads in SERVE_LOADS:
            sink = BatchSink()
            eng = serving.Engine(searcher, serving.EngineConfig(
                max_batch=64, max_wait_us=2000, max_inflight=2,
                warm_ks=(K,), span_sink=sink))
            eng.start()
            try:
                builds0 = serving.compile_count()
                t_first = time.perf_counter()
                eng.submit(q_host[0], K).result(timeout=60)
                first_ms = (time.perf_counter() - t_first) * 1e3
                sink.take()
                gk.reset_launch_counts()
                counting[0] = family
                run = closed_loop(eng, q_host, K, n_threads)
                counting[0] = None
                launches = launch_counts()
                batches = sink.take()
                builds = serving.compile_count() - builds0
                line = summarize(run, batches)
                line["queue_wait_ms"] = eng.stats.snapshot().get(
                    "queue_wait_ms")
                scrape = None
                if n_threads == SERVE_LOADS[0]:
                    port = eng.serve_metrics(0).port
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/metrics",
                            timeout=30) as resp:
                        text = resp.read().decode()
                    scrape = {fam: fam in text for fam in SERVE_FAMILIES}
                routes = sorted({(b_.get("kernel"), b_.get("route"))
                                 for rec in batches
                                 for b_ in rec.get("explain", [])},
                                key=str)
            finally:
                eng.stop()
            ids_t = torch.from_numpy(run["ids"]).to(dev)
            if floor is None:
                quality = assert_topk_close(
                    (torch.from_numpy(run["distances"]).to(dev), ids_t),
                    (gt_v[:SERVE_QUERIES], gt_i[:SERVE_QUERIES]),
                    1e-4 * scale, 1e-5, f"served {family}")
            else:
                quality = {"recall_at_10": float(
                    neighborhood_recall(ids_t, gt_i[:SERVE_QUERIES]))}
            served_recall[(family, n_threads)] = quality.get(
                "recall_at_10")
            mismatches = serving.verify_bit_identity(
                searcher, [q_host[j] for j in sample],
                [(run["distances"][j], run["ids"][j]) for j in sample], K,
                [run["placements"][j] for j in sample])
            for name in gk.LAUNCHES:
                serve_launches[name] += launches[name]
            emit({"phase": "serving", "family": family,
                  "submitters": n_threads, **line,
                  "first_request_ms": first_ms,
                  "builds_after_start": builds,
                  "warmup": eng.warmup_info, **quality,
                  "solo_mismatches": mismatches,
                  "solo_sampled": SERVE_SAMPLE, "explain_routes": routes,
                  "scrape": scrape, "launches": launches})
            if builds:
                raise AssertionError(f"serving {family}: {builds} kernel "
                                     "builds after start()")
            if mismatches:
                raise AssertionError(f"serving {family}: {mismatches} rows "
                                     "differ from solo_reference")
            if floor is not None and quality["recall_at_10"] < floor:
                raise AssertionError(f"serving {family}: recall "
                                     f"{quality['recall_at_10']} < {floor}")
            if "cuda" not in {route for _, route in routes}:
                raise AssertionError(f"serving {family}: no batch span "
                                     "names the CUDA route")
            if scrape is not None and not all(scrape.values()):
                raise AssertionError(f"serving {family}: the scrape lacks "
                                     f"{[f for f, ok in scrape.items() if not ok]}")
    for name in SERVE_KERNELS:
        if serve_launches[name] < 1:
            raise AssertionError(f"the serving phase launched no {name}")

    # each kernel of the served path against its plain version on the
    # inputs the path gives it at every warmed bucket; timed rows at 8 and
    # 64
    def serve_check(family, bucket, name, kernel, plain, args, atol, n_bytes,
                    n_ops, shape, library=None):
        got, want = kernel(*args), plain(*args)
        if atol == 0.0:
            if not (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} at bucket {bucket} ({family}) "
                                     "differs from its plain version")
            res = {"max_abs_err": 0.0, "bitwise": True}
        else:
            res = assert_topk_close(got, want, atol, 1e-5,
                                    f"{name} bucket {bucket} ({family})")
        torch.cuda.synchronize()
        if bucket not in SERVE_ROW_BUCKETS:
            emit({"phase": "serving_agreement", "name": name,
                  "family": family, "bucket": bucket, **res})
            return None
        entry = dict(
            name=name, route="cuda", source=f"raft_tpu_torch/csrc/"
            f"{gk.SOURCES[name]}", replaces=REPLACES[name],
            shape=f"serving {family}, bucket {bucket}: {shape}",
            launches=bucket_launches.get((family, bucket, name), 0),
            agrees_with_plain=True, **res,
            ms=graph_ms(lambda: kernel(*args), 20),
            ms_eager=cuda_ms(lambda: kernel(*args), 20),
            plain_ms=cuda_ms(lambda: plain(*args), 3),
            library_ms=(graph_ms(library, 20) if library is not None
                        else None),
            parent_ms=None, ab_ms=None, **bound(n_bytes, n_ops))
        emit({"phase": "kernel_check", **entry})
        return entry

    def select_check(family, bucket, scores_b, k_):
        return serve_check(
            family, bucket, "select_k",
            lambda v: gk.streaming_select_k(v, k_),
            lambda v: gk._stable_topk(v, k_), (scores_b,), 0.0,
            *obs_costs.select_k_work(bucket, scores_b.shape[1], k_, False),
            f"coarse probes [{bucket} x {scores_b.shape[1]}], k={k_}",
            library=lambda: torch.topk(scores_b, k_, largest=False))

    serve_rows = []
    codebooks = pq_index.codebooks.contiguous()
    cb_norms = (codebooks * codebooks).sum(-1).contiguous()
    ivf_pq.ensure_scan_cache(pq_index, ivf_pq.SearchParams().scan_cache_dtype)
    for bucket in SERVE_CHECK_BUCKETS:
        xb = queries[:bucket].to(torch.float32).contiguous()
        xbn = row_norms_sq(xb)
        serve_rows.append(serve_check(
            "brute_force", bucket, "fused_l2_topk", gk.fused_l2_topk,
            gk.fused_l2_topk_plain, (xb, dataset, K, xbn, bf.norms),
            1e-4 * scale, *obs_costs.l2_topk_work(bucket, N_ROWS, DIM, K),
            f"{bucket} x {N_ROWS} x {DIM}, k={K}"))
        # IVF-Flat: the coarse selection, then the grouped scan
        sc, _ = ivf_flat._coarse_scores(xb, index.centers, index.metric)
        sc = sc.contiguous()
        serve_rows.append(select_check("ivf_flat", bucket, sc, n_probes))
        _, pr = gk.streaming_select_k(sc, n_probes)
        args = (pr, xb[:, None, :].expand(bucket, n_probes, DIM).contiguous(),
                xbn[:, None].expand(bucket, n_probes).contiguous(),
                index.list_data, index.ensure_row_norms(), index.safe_ids(),
                K, True)
        rows_b = int(index.list_sizes[pr.long()].sum())
        pad_b = index.list_data.shape[1]
        serve_rows.append(serve_check(
            "ivf_flat", bucket, "fused_ivf_topk", gk.fused_ivf_topk,
            gk.fused_ivf_topk_plain, args, 1e-4 * scale,
            *obs_costs.ivf_topk_work(bucket, n_probes, DIM, pad_b, 4, K,
                                     torch.unique(pr.long()).numel(),
                                     rows_b),
            f"{bucket} queries x {n_probes} probes, pad {pad_b}, f32"))
        # IVF-PQ, cache regime: the rotated residuals through the grouped
        # scan over the bf16 cache
        for fam, probes_n in (("ivf_pq_cache", pq_probes),
                              ("ivf_pq_lut", lut_probes)):
            q_rot, centers_rot, ppr = ivf_pq._coarse_probes_rot(
                xb, pq_index, probes_n)
            rows_b = int(pq_index.list_sizes[ppr.long()].sum())
            n_probed = torch.unique(ppr.long()).numel()
            if fam == "ivf_pq_cache":
                qr_res = (q_rot[:, None, :]
                          - centers_rot[ppr.long()]).contiguous()
                args = (ppr, qr_res, (qr_res * qr_res).sum(-1).contiguous(),
                        pq_index.list_decoded, pq_index.decoded_norms,
                        pq_index.safe_ids(), K, False)
                plain_v = gk.fused_ivf_topk_plain(*args)[0]
                serve_rows.append(serve_check(
                    fam, bucket, "fused_ivf_topk", gk.fused_ivf_topk,
                    gk.fused_ivf_topk_plain, args,
                    1e-4 * float(plain_v[torch.isfinite(plain_v)].abs()
                                 .max()),
                    *obs_costs.ivf_topk_work(bucket, probes_n, rot, pq_pad,
                                             2, K, n_probed, rows_b),
                    f"{bucket} queries x {probes_n} probes, pad {pq_pad}, "
                    f"rot {rot}, bf16"))
            else:
                args = (ppr, q_rot, centers_rot, codebooks, cb_norms,
                        pq_index.list_codes, pq_index.safe_ids(), K)
                plain_v = gk.fused_pq_topk_plain(*args)[0]
                serve_rows.append(serve_check(
                    fam, bucket, "fused_pq_topk", gk.fused_pq_topk,
                    gk.fused_pq_topk_plain, args,
                    1e-4 * float(plain_v[torch.isfinite(plain_v)].abs()
                                 .max()),
                    *obs_costs.pq_topk_work(bucket, probes_n, q_rot.shape[1],
                                            N_LISTS, PQ_DIM, pq_len, pq_pad,
                                            K, n_probed, rows_b),
                    f"{bucket} queries x {probes_n} probes, pad {pq_pad}, "
                    f"pq_dim {PQ_DIM}"))
        # CAGRA: the seeds the served searcher draws for this bucket
        cg_b = (xb, dataset, cg_index.graph,
                cagra.seed_table(cg_sp, bucket, N_ROWS, n_seeds, dev),
                gk.beam_norms(xb))
        *_, st = gk.fused_cagra_topk_plain(*cg_b, K, itopk, 1, cg_max_iter,
                                           return_stats=True)
        serve_rows.append(serve_check(
            "cagra", bucket, "fused_cagra_topk",
            lambda *a: gk.fused_cagra_topk(*a, K, itopk, 1, cg_max_iter),
            lambda *a: gk.fused_cagra_topk_plain(*a, K, itopk, 1,
                                                 cg_max_iter),
            cg_b, 0.0,
            *obs_costs.cagra_topk_work(
                bucket, DIM, CAGRA_DEGREE, K, n_seeds, st["rows_touched"],
                st["nodes_expanded"], int(st["rows_scored"].sum())),
            f"{bucket} queries, itopk {itopk}, width 1, {n_seeds} seeds"))
    kernels.extend(row for row in serve_rows if row is not None)

    # ---- 6c. persistence: every index above saved, restored onto the card
    # and searched bitwise like the saved one; the sharded checkpoints'
    # strict and elastic restores, a damaged copy, degraded serving
    persist_launches, persist_s = timed(lambda: persistence_phase(
        smi=smi, dev=dev, queries=queries, gt_i=gt_i, dataset=dataset, bf=bf,
        flat=index, flat_probes=n_probes, pq_index=pq_index,
        pq_probes=pq_probes, card_res=card_res, lut_probes=lut_probes,
        lut_res=lut_res, cg_index=cg_index, cg_itopk=itopk,
        sf_index=sf_index, sf_probes=sf_probes, sp_index=sp_index,
        sp_probes=sp_probes, ring_comms=ring_comms,
        launch_counts=launch_counts,
        root=Path(__file__).resolve().parent / "build" / "chip_smoke_persist"))
    emit({"phase": "persist_total", "card": smi, "seconds": persist_s,
          "launches": persist_launches})
    for row in kernels:
        row["persist_launches"] = persist_launches.get(row["name"], 0)

    # ---- 6d. narrow data and the bf16 fast scan
    narrow_rows, narrow_s = timed(lambda: narrow_phase(
        smi=smi, dev=dev, seed=opts.seed, dataset=dataset, queries=queries,
        gt_v=gt_v, gt_i=gt_i, bf=bf, flat=index, flat_probes=n_probes,
        keep_t=keep_t, filt=filt, cg_index=cg_index,
        launch_counts=launch_counts, bound=bound, scale=scale))
    emit({"phase": "narrow_total", "card": smi, "seconds": narrow_s})
    for row in narrow_rows:
        row["persist_launches"] = persist_launches.get(row["name"], 0)
    kernels.extend(narrow_rows)

    # ---- 6e. the write path and the tiers: a mutable IVF-Flat with its
    # WAL, compaction and kill -9 recovery, served while it takes writes;
    # the tiered IVF-PQ over pinned host memory, served; the streamed
    # builds from a file (the fbin is kept for phase 6h)
    from raft_tpu_torch.bench import write_tiers
    dir_6h = Path(__file__).resolve().parent / "build" / "chip_smoke_6h"
    shutil.rmtree(dir_6h, ignore_errors=True)
    fbin_6h = dir_6h / "base.fbin"
    (wt_rows, wt_launches), wt_s = timed(lambda: write_tiers.phase(
        smi=smi, dev=dev, seed=opts.seed, dataset=dataset, queries=queries,
        gt_i=gt_i, flat=index, flat_probes=n_probes, pq_index=pq_index,
        pq_probes=pq_probes, lut_res=lut_res, lut_probes=lut_probes,
        ip_index=ip_index, ip_data=ip_data, ip_queries=ip_queries,
        ip_probes=ip_probes, launch_counts=launch_counts, emit=emit,
        timed=timed, cuda_ms=cuda_ms, graph_ms=graph_ms, bound=bound,
        replaces=REPLACES,
        root=Path(__file__).resolve().parent / "build" / "chip_smoke_6e",
        repo=Path(__file__).resolve().parent, fbin=fbin_6h))
    emit({"phase": "write_tiers_total", "card": smi, "seconds": wt_s,
          "launches": wt_launches})
    for row in wt_rows:
        row["persist_launches"] = persist_launches.get(row["name"], 0)
    kernels.extend(wt_rows)
    for row in kernels:
        row["write_tier_launches"] = wt_launches.get(row["name"], 0)

    # ---- 6f. measured dispatch and the adaptive planner: the committed
    # probe verdicts and their routes, padding, the sweep to a frontier,
    # IVF-Flat and IVF-PQ served behind the planner
    from raft_tpu_torch.bench import planning
    plan_launches, plan_s = timed(lambda: planning.phase(
        smi=smi, dev=dev, seed=opts.seed, dataset=dataset, queries=queries,
        gt_i=gt_i, bf=bf, flat=index, flat_probes=n_probes,
        pq_index=pq_index, pq_probes=pq_probes, card_res=card_res,
        cg_index=cg_index, cg_itopk=itopk, filt=filt, emit=emit,
        root=Path(__file__).resolve().parent / "build" / "chip_smoke_6f"))
    for name in ("fused_ivf_topk", "select_k"):
        if plan_launches[name] < 1:
            raise AssertionError(f"phase 6f's planner loads launched no "
                                 f"{name}")
    for row in kernels:
        row["planning_launches"] = plan_launches.get(row["name"], 0)

    # ---- 6g. the replica fleet: three replicas of phase 4's IVF-Flat in
    # this process under load and faults; two replica processes on the
    # card, one killed, one autoscaled, one swapped to brute force
    from raft_tpu_torch.bench import fleet_load
    fleet_launches = fleet_load.phase(
        smi=smi, dev=dev, seed=opts.seed, queries=queries[:SERVE_QUERIES],
        gt_i=gt_i[:SERVE_QUERIES],
        flat=index, flat_probes=n_probes,
        serve_recall=served_recall[("ivf_flat", SERVE_LOADS[0])], emit=emit,
        repo=Path(__file__).resolve().parent)
    for row in kernels:
        row["fleet_launches"] = fleet_launches.get(row["name"], 0)

    # ---- 6h. the rest of the sharded path: sharded CAGRA, the from-file
    # and pod builds from 6e's fbin, init_distributed over NCCL, the dense
    # metrics through brute force
    from raft_tpu_torch.bench import sharded_rest
    try:
        sharded_launches = sharded_rest.phase(
            smi=smi, dev=dev, seed=opts.seed, dataset=dataset,
            queries=queries, gt_i=gt_i, ring_comms=ring_comms, fbin=fbin_6h,
            cagra_params=cg_params, cagra_itopk=itopk,
            cagra_recall=cg_recall, n_lists=N_LISTS, pq_dim=PQ_DIM,
            pq_bits=PQ_BITS, flat_index=sf_index, flat_probes=sf_probes,
            emit=emit, timed=timed, launch_counts=launch_counts)
    finally:
        shutil.rmtree(dir_6h, ignore_errors=True)
    for name in ("fused_cagra_topk", "fused_ivf_topk", "fused_pq_topk",
                 "select_k", "ring_shift"):
        if sharded_launches[name] < 1:
            raise AssertionError(f"phase 6h launched no {name}")
    for row in kernels:
        row["sharded_launches"] = sharded_launches.get(row["name"], 0)

    # ---- 6i. the breadth modules: ball cover, the epsilon neighbourhood,
    # Gram matrices, dense and sparse linear algebra, statistics and the
    # scalar quantizer, each held against float64 or its exact counterpart
    from raft_tpu_torch.bench import breadth
    breadth_launches = breadth.phase(
        smi=smi, dev=dev, seed=opts.seed, dataset=dataset, queries=queries,
        gt_i=gt_i, km_centers=km_centers, emit=emit, timed=timed,
        launch_counts=launch_counts)
    for row in kernels:
        row["breadth_launches"] = breadth_launches.get(row["name"], 0)

    # ---- 6j. the graph layer: single linkage at SIFT-1M's shape, the
    # cross-component 1-NN, sparse distances and kNN, spectral
    # partitioning, the auction, labels, the namespaces; its kernels held
    # against their plain versions at the shapes it gives them
    from raft_tpu_torch.bench import graph
    graph_launches, graph_rows = graph.phase(
        smi=smi, dev=dev, seed=opts.seed, dataset=dataset, flat=index,
        flat_probes=n_probes, replaces=REPLACES, emit=emit, timed=timed,
        launch_counts=launch_counts)
    for row in graph_rows:
        # the earlier phases' launch columns, by kernel
        like = next(r for r in kernels if r["name"] == row["name"])
        row.update({key: val for key, val in like.items()
                    if key.endswith("_launches")})
    kernels.extend(graph_rows)
    for row in kernels:
        row["graph_launches"] = graph_launches.get(row["name"], 0)

    # ---- 6k. the analysis layer on the card: the shared-memory accountants
    # against the built libraries, ptxas' limits and the plans' alignment;
    # the canonical entries' allocator peaks against budget and planner;
    # the merges' received bytes; the analysis CLI with no jax
    from raft_tpu_torch.bench import audit
    audit_launches = audit.phase(
        smi=smi, dev=dev, seed=opts.seed, queries=queries, dataset=dataset,
        bf=bf, flat=index, pq_index=pq_index, cg_index=cg_index,
        ring_comms=ring_comms, emit=emit,
        repo=Path(__file__).resolve().parent, launch_counts=launch_counts)
    for row in kernels:
        row["analysis_launches"] = audit_launches.get(row["name"], 0)

    # ---- 7. the kernels line, then the result line
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
