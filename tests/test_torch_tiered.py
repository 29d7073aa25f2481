"""raft_tpu_torch's tiered IVF-PQ against its resident cache search and
against raft_tpu's tiered index, on the CPU.

- Bitwise: ``TieredIvfPq.search`` equals the port's resident cache search
  of the same batch (``ivf_pq.search(..., memory_mode="cache")``, scan_mode
  "auto": ``fused_ivf_topk`` for L2, ``ivf_scan`` + select_k for inner
  product and k > 1024) across metrics, both codebook kinds, with an
  overflow block, through misses, hits and eviction churn in a small arena.
- Across packages: an index built by raft_tpu and carried over by
  ``interop``, demoted in both; the searches agree within
  ``assert_topk_close``'s tolerance (rtol 1e-5, atol 1e-4·max‖x‖², the ADC
  tolerance of ``test_torch_ivf_pq.py``); a manifest written by either
  package loads in the other.
- ``solve_host_tier`` equals raft_tpu's, and its bytes are the arena's and
  the host tier's exactly; an arena smaller than a batch is a typed
  ``TieredArenaError``; the counters reconcile with the registry; two
  namespaces share one arena; a host read failure is a chained
  ``TierReadError``, and through the engine a ``BatchFailed``; the
  prefetcher stages the peeked batch; a non-cache ``scan_mode`` raises.
"""

import json

import numpy as np
import pytest
import torch

from raft_tpu.core.resources import Resources as JResources
from raft_tpu.core.resources import solve_host_tier as j_solve_host_tier
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import tiered as jtiered

from raft_tpu_torch import interop, serving
from raft_tpu_torch.core.resources import Resources, solve_host_tier
from raft_tpu_torch.neighbors import ivf_pq, tiered
from raft_tpu_torch.neighbors.ivf_pq import (CodebookGen, IndexParams,
                                             SearchParams)
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.testing import assert_topk_close

DIM = 24


def _res():
    return Resources(device="cpu", seed=0)


def _build(rows=900, n_lists=37, pq_dim=12, seed=0,
           metric=DistanceType.L2Expanded,
           codebook_kind=CodebookGen.PER_SUBSPACE, expansion=1.5):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((rows, DIM), dtype=np.float32)
    idx = ivf_pq.build(db, IndexParams(
        n_lists=n_lists, pq_dim=pq_dim, metric=metric,
        codebook_kind=codebook_kind, kmeans_n_iters=4,
        list_pad_expansion=expansion), res=_res())
    return db, idx


def _bitwise(a, b) -> bool:
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def _resident(idx, q, k, params, res):
    return ivf_pq.search(idx, q, k, params, res=res, memory_mode="cache")


# ------------------------------------------------------------ bit identity


@pytest.mark.parametrize("metric,kind", [
    (DistanceType.L2Expanded, CodebookGen.PER_SUBSPACE),
    (DistanceType.InnerProduct, CodebookGen.PER_SUBSPACE),
    (DistanceType.L2SqrtExpanded, CodebookGen.PER_CLUSTER),
    (DistanceType.InnerProduct, CodebookGen.PER_CLUSTER),
])
def test_bitwise_the_resident_cache_search(metric, kind):
    res = _res()
    _, idx = _build(metric=metric, codebook_kind=kind)
    t = tiered.TieredIvfPq.from_index(idx, res=res)
    rng = np.random.default_rng(1)
    params = SearchParams(n_probes=6)
    for nq, k in ((5, 7), (16, 10), (3, 1)):
        q = rng.standard_normal((nq, DIM), dtype=np.float32)
        got = t.search(q, k, params, res=res)
        assert _bitwise(got, _resident(idx, q, k, params, res))
    # the arena's norms are the cache's decoded norms bit for bit
    ivf_pq.ensure_scan_cache(idx)
    assert torch.equal(t.tier.norms.view(torch.int32),
                       idx.decoded_norms.view(torch.int32))


def test_bitwise_with_overflow_and_large_k():
    res = _res()
    _, idx = _build(rows=1200, n_lists=16, pq_dim=8, expansion=1.0)
    assert idx.overflow_indices.shape[0] > 0
    t = tiered.TieredIvfPq.from_index(idx, res=res)
    q = np.random.default_rng(2).standard_normal((9, DIM), dtype=np.float32)
    for k, probes in ((10, 5), (1100, 16)):  # k > 1024: the scan route
        params = SearchParams(n_probes=probes)
        assert t._route(k) == ("fused" if k <= 1024 else "scan")
        assert _bitwise(t.search(q, k, params, res=res),
                        _resident(idx, q, k, params, res))


def test_bitwise_through_eviction_churn():
    res = _res()
    _, idx = _build(rows=1500, n_lists=40, pq_dim=8)
    arena = tiered.SlabArena(10, idx.list_codes.shape[1], idx.rot_dim,
                             fetch_tile=3, device="cpu")
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena=arena)
    rng = np.random.default_rng(3)
    params = SearchParams(n_probes=4)
    for _ in range(12):
        q = rng.standard_normal((2, DIM), dtype=np.float32)
        assert _bitwise(t.search(q, 5, params, res=res),
                        _resident(idx, q, 5, params, res))
    c = arena.snapshot_counts()
    assert c["evictions"] > 0 and c["hits"] > 0
    assert c["hits"] + c["misses"] + c["prefetch_hits"] \
        + c["prefetch_fetches"] == c["resolved"]
    assert c["inserts"] == c["misses"] + c["prefetch_fetches"]
    assert c["evictions"] == c["inserts"] - c["occupancy"]
    assert all(p == 0 for p in arena._pins)  # every scan released


def test_rejects_non_cache_scan_mode_and_other_cache_dtype():
    res = _res()
    _, idx = _build(n_lists=16, rows=400, pq_dim=8)
    t = tiered.TieredIvfPq.from_index(idx, res=res)
    for mode in ("lut", "pallas"):
        with pytest.raises(ValueError, match="not tierable"):
            t.search(np.zeros((2, DIM), np.float32), 3,
                     SearchParams(scan_mode=mode), res=res)
    with pytest.raises(ValueError, match="scan_cache_dtype"):
        t.search(np.zeros((2, DIM), np.float32), 3,
                 SearchParams(scan_cache_dtype="float32"), res=res)
    t.search(np.zeros((2, DIM), np.float32), 3,
             SearchParams(scan_mode="cache"), res=res)


# ---------------------------------------------------------- across packages


@pytest.fixture(scope="module")
def carried():
    rng = np.random.default_rng(4)
    db = rng.standard_normal((1200, DIM), dtype=np.float32)
    j = jpq.build(db, jpq.IndexParams(n_lists=24, pq_dim=12,
                                      kmeans_n_iters=4,
                                      list_pad_expansion=1.1),
                  res=JResources(seed=0))
    t = interop.ivf_pq_index_from_numpy(
        IndexParams(n_lists=24, pq_dim=12, list_pad_expansion=1.1),
        j.pq_dim, np.asarray(j.centers), np.asarray(j.rotation),
        np.asarray(j.codebooks), np.asarray(j.list_codes),
        np.asarray(j.list_indices), np.asarray(j.list_sizes), j.n_rows,
        np.asarray(j.overflow_codes), np.asarray(j.overflow_labels),
        np.asarray(j.overflow_indices), device="cpu")
    return db, j, t


def test_agrees_with_raft_tpu_tiered_on_the_same_state(carried):
    db, j, t = carried
    jr = JResources(seed=0)
    jt = jtiered.TieredIvfPq.from_index(j, res=jr, arena_slots=20)
    tt = tiered.TieredIvfPq.from_index(t, res=_res(), arena_slots=20)
    np.testing.assert_array_equal(tt.tier.codes.numpy(), jt.tier.codes)
    np.testing.assert_allclose(tt.tier.norms.numpy(), jt.tier.norms,
                               rtol=1e-5, atol=1e-6)
    scale = float((db * db).sum(1).max())
    q = np.random.default_rng(5).standard_normal((6, DIM), dtype=np.float32)
    for _ in range(2):
        got = tt.search(q, 8, SearchParams(n_probes=6))
        want = jt.search(q, 8, jpq.SearchParams(n_probes=6,
                                                scan_mode="cache"), res=jr)
        assert_topk_close(got, (np.asarray(want[0]), np.asarray(want[1])),
                          1e-4 * scale, 1e-5, "tiered vs raft_tpu")
    a, b = tt.arena.snapshot_counts(), jt.arena.snapshot_counts()
    assert {k: a[k] for k in ("hits", "misses", "resolved")} == \
        {k: b[k] for k in ("hits", "misses", "resolved")}


@pytest.mark.parametrize("writer", ["port", "raft_tpu"])
def test_manifest_crosses_both_ways(tmp_path, carried, writer):
    db, j, t = carried
    jr = JResources(seed=0)
    tt = tiered.TieredIvfPq.from_index(t, res=_res(), arena_slots=24)
    jt = jtiered.TieredIvfPq.from_index(j, res=jr, arena_slots=24)
    q = np.random.default_rng(6).standard_normal((4, DIM), dtype=np.float32)
    params = SearchParams(n_probes=5)
    scale = float((db * db).sum(1).max())
    if writer == "port":
        mp = tiered.save_tiered(tt, str(tmp_path), name="x")
        # the port reads its own bitwise, raft_tpu reads it within tolerance
        back = tiered.load_tiered(mp, res=_res())
        assert _bitwise(back.search(q, 5, params), tt.search(q, 5, params))
        other = jtiered.load_tiered(mp, res=jr)
        got = other.search(q, 5, jpq.SearchParams(n_probes=5,
                                                  scan_mode="cache"), res=jr)
        assert_topk_close((np.asarray(got[0]), np.asarray(got[1])),
                          tt.search(q, 5, params), 1e-4 * scale, 1e-5,
                          "raft_tpu reads the port's manifest")
    else:
        mp = jtiered.save_tiered(jt, str(tmp_path), name="x")
        back = tiered.load_tiered(mp, res=_res())
        assert back.namespace == jt.namespace
        np.testing.assert_array_equal(back.tier.norms.numpy(),
                                      jt.tier.norms)
        assert_topk_close(back.search(q, 5, params), tt.search(q, 5, params),
                          1e-4 * scale, 1e-5, "the port reads raft_tpu's")
    with open(mp) as f:
        art = json.load(f)
    tiered.validate_manifest(art, base_dir=str(tmp_path), check_files=True)
    jtiered.validate_manifest(art, base_dir=str(tmp_path), check_files=True)
    codes = tmp_path / art["files"]["codes"]["path"]
    with open(codes, "r+b") as f:
        f.seek(32)
        f.write(b"\xff\xff")
    with pytest.raises(ValueError, match="crc32"):
        tiered.load_manifest(mp)


def test_manifest_schema_rejections():
    with pytest.raises(ValueError, match="schema"):
        tiered.validate_manifest({"schema": "wrong/v0"})
    art = {"schema": tiered.MANIFEST_SCHEMA}
    with pytest.raises(ValueError, match="non-negative int"):
        tiered.validate_manifest(art)
    geo = dict(art, n_lists=2, list_pad=4, n_code_bytes=8, pq_dim=8,
               pq_bits=8, n_rows=8, dim=8, rot_dim=8)
    with pytest.raises(ValueError, match="files"):
        tiered.validate_manifest(geo)
    files = {k: {"path": k, "crc32": 0}
             for k in ("codes", "ids", "norms", "sizes", "coarse")}
    with pytest.raises(ValueError, match="lists"):
        tiered.validate_manifest(dict(geo, files=files, lists=[]))
    over = [{"list": 0, "row_start": 0, "rows": 4, "size": 5},
            {"list": 1, "row_start": 4, "rows": 4, "size": 1}]
    with pytest.raises(ValueError, match="exceeds list_pad"):
        tiered.validate_manifest(dict(geo, files=files, lists=over))
    with pytest.raises(ValueError):
        jtiered.validate_manifest(dict(geo, files=files, lists=over))


# ----------------------------------------------------------------- sizing


@pytest.mark.parametrize("args", [
    (1024, 1456, 128, 64, 1 << 30), (37, 60, 24, 12, 1 << 20),
    (16, 8, 8, 4, 0), (5000, 300, 96, 48, 8 << 30, 32, 16, 4, 0.25)])
def test_solve_host_tier_equals_raft_tpu(args):
    assert solve_host_tier(*args) == j_solve_host_tier(*args)


def test_arena_and_host_bytes_as_predicted():
    res = Resources(device="cpu", workspace_limit_bytes=1 << 16)
    _, idx = _build(n_lists=32, rows=800, pq_dim=8)
    t = tiered.TieredIvfPq.from_index(idx, res=res)
    plan = solve_host_tier(t.tier.n_lists, t.tier.list_pad, idx.rot_dim,
                           t.tier.n_code_bytes, res.workspace_limit_bytes)
    assert plan["arena_slots"] == t.arena.slots < t.tier.n_lists
    assert plan["arena_bytes"] == t.arena.nbytes
    assert plan["host_bytes"] == t.tier.nbytes


def test_arena_smaller_than_one_batch_is_typed_and_untouched():
    res = _res()
    _, idx = _build(n_lists=32, rows=800, pq_dim=8)
    arena = tiered.SlabArena(4, idx.list_codes.shape[1], idx.rot_dim,
                             device="cpu")
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena=arena)
    with pytest.raises(tiered.TieredArenaError, match="slots"):
        t.search(np.zeros((8, DIM), np.float32), 3,
                 SearchParams(n_probes=16), res=res)
    assert arena.occupancy() == 0 and all(p == 0 for p in arena._pins)


# -------------------------------------------------------------- telemetry


def test_counters_reconcile_with_the_registry_and_spans():
    res = _res()
    _, idx = _build(n_lists=32, rows=800, pq_dim=8)
    reg = obs_metrics.Registry()
    sink = obs_spans.ListSink()
    arena = tiered.SlabArena(16, idx.list_codes.shape[1], idx.rot_dim,
                             registry=reg, label="t", span_sink=sink,
                             device="cpu")
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena=arena)
    rng = np.random.default_rng(5)
    params = SearchParams(n_probes=4)
    with obs_spans.trace_scope("trace-under-test"):
        for _ in range(4):
            t.search(rng.standard_normal((3, DIM), dtype=np.float32), 5,
                     params, res=res)
    t.prefetch_queries(rng.standard_normal((3, DIM), dtype=np.float32),
                       params=params)
    c = arena.snapshot_counts()

    def val(name, *labels):
        return dict(reg.get(name).collect())[labels].value

    assert val("raft_tpu_tier_cache_hits_total", "t") == c["hits"]
    assert val("raft_tpu_tier_cache_misses_total", "t") == c["misses"]
    assert val("raft_tpu_tier_cache_evictions_total", "t") == c["evictions"]
    assert val("raft_tpu_tier_prefetch_total", "t", "fetch") \
        == c["prefetch_fetches"]
    assert val("raft_tpu_tier_prefetch_total", "t", "already_resident") \
        == c["prefetch_hits"]
    assert val("raft_tpu_tier_prefetch_total", "t", "useful") \
        == c["useful_prefetch"]
    assert val("raft_tpu_tier_arena_occupancy", "t") \
        == c["occupancy"] / arena.slots
    hist = dict(reg.get("raft_tpu_tier_fetch_stall_seconds").collect())
    fetches = sink.by_kind("tier_fetch")
    demand = [s for s in fetches if s["path"] == "demand"]
    assert hist[("t", "demand")].count == len(demand) > 0
    assert all(s["trace"] == "trace-under-test" for s in demand)
    assert sum(s["n_lists"] for s in demand) == c["misses"]
    for s in fetches:
        assert len(s["clusters"]) == len(s["slots"])
        json.dumps(s)


def test_two_namespaces_share_one_arena():
    res = _res()
    _, idx_a = _build(n_lists=16, rows=400, pq_dim=8, seed=10)
    _, idx_b = _build(n_lists=16, rows=400, pq_dim=8, seed=11)
    pad = idx_a.list_codes.shape[1]
    assert idx_b.list_codes.shape[1] == pad  # one arena holds both
    arena = tiered.SlabArena(20, pad, idx_a.rot_dim, device="cpu")
    ta = tiered.TieredIvfPq.from_index(idx_a, res=res, arena=arena,
                                       namespace="a")
    tb = tiered.TieredIvfPq.from_index(idx_b, res=res, arena=arena,
                                       namespace="b")
    rng = np.random.default_rng(12)
    params = SearchParams(n_probes=4)
    for _ in range(3):
        q = rng.standard_normal((2, DIM), dtype=np.float32)
        assert _bitwise(ta.search(q, 5, params, res=res),
                        _resident(idx_a, q, 5, params, res))
        assert _bitwise(tb.search(q, 5, params, res=res),
                        _resident(idx_b, q, 5, params, res))
    assert {ns for ns, _ in arena._map} == {"a", "b"}


# ------------------------------------------------------------ degradation


def test_host_read_failure_is_typed_and_chained():
    res = _res()
    _, idx = _build(n_lists=16, rows=400, pq_dim=8)
    t = tiered.TieredIvfPq.from_index(idx, res=res)
    t.tier.norms = None  # a torn host buffer
    with pytest.raises(tiered.TierReadError) as ei:
        t.search(np.zeros((2, DIM), np.float32), 3,
                 SearchParams(n_probes=4), res=res)
    assert ei.value.__cause__ is not None
    assert t.arena.occupancy() == 0 and all(p == 0 for p in t.arena._pins)


def test_host_read_failure_through_engine_is_batch_failed():
    res = _res()
    _, idx = _build(n_lists=16, rows=400, pq_dim=8)
    t = tiered.TieredIvfPq.from_index(idx, res=res)
    searcher = serving.tiered_ivf_pq_searcher(
        t, SearchParams(n_probes=4, scan_mode="cache"), res=res)
    engine = serving.Engine(searcher, serving.EngineConfig(
        max_batch=4, max_wait_us=500, warm_ks=(3,)))
    engine.start()
    try:
        t.tier.norms = None  # after the warm-up
        fut = engine.submit(np.ones(DIM, np.float32), 3)
        with pytest.raises(serving.BatchFailed) as ei:
            fut.result(timeout=30)
        assert isinstance(ei.value.__cause__, tiered.TierReadError)
    finally:
        engine.stop()


# ------------------------------------------------------------- prefetch


def test_prefetcher_stages_the_peeked_batch():
    res = _res()
    _, idx = _build(n_lists=16, rows=400, pq_dim=8)
    arena = tiered.SlabArena(16, idx.list_codes.shape[1], idx.rot_dim,
                             device="cpu")
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena=arena)
    params = SearchParams(n_probes=4)
    q = np.random.default_rng(11).standard_normal((3, DIM), dtype=np.float32)
    assert t.prefetch_queries(q, params=params) > 0
    before = arena.snapshot_counts()
    assert _bitwise(t.search(q, 5, params, res=res),
                    _resident(idx, q, 5, params, res))
    after = arena.snapshot_counts()
    assert after["misses"] == before["misses"]
    assert after["useful_prefetch"] > before["useful_prefetch"]


def test_prefetcher_thread_on_a_serving_engine():
    res = _res()
    _, idx = _build(n_lists=16, rows=400, pq_dim=8)
    arena = tiered.SlabArena(16, idx.list_codes.shape[1], idx.rot_dim,
                             device="cpu")
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena=arena)
    params = SearchParams(n_probes=4)
    searcher = serving.tiered_ivf_pq_searcher(t, params, res=res)
    rng = np.random.default_rng(13)
    q = rng.standard_normal((24, DIM), dtype=np.float32)
    with serving.Engine(searcher, serving.EngineConfig(
            max_batch=8, max_wait_us=20_000, warm_ks=(5,))) as eng:
        with tiered.attach_prefetcher(eng, t, params=params) as pf:
            futs = [eng.submit(row, 5) for row in q]
            rows = [f.result(timeout=60) for f in futs]
        assert pf.n_errors == 0
    want = _resident(idx, q, 5, params, res)
    for j, (d, i) in enumerate(rows):
        assert list(np.asarray(i)) == want[1][j].tolist()
    c = arena.snapshot_counts()
    assert c["hits"] + c["misses"] + c["prefetch_hits"] \
        + c["prefetch_fetches"] == c["resolved"]


def test_two_threads_through_one_small_arena():
    """Two searching threads whose batches together probe more lists than
    the arena holds: a resolve waits for the other's scan instead of
    failing, and every result stays bitwise the resident search."""
    import threading

    res = _res()
    _, idx = _build(rows=1500, n_lists=40, pq_dim=8)
    arena = tiered.SlabArena(12, idx.list_codes.shape[1], idx.rot_dim,
                             fetch_tile=4, device="cpu")
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena=arena)
    params = SearchParams(n_probes=4)
    rng = np.random.default_rng(21)
    batches = [[rng.standard_normal((2, DIM), dtype=np.float32)
                for _ in range(8)] for _ in range(2)]
    want = [[_resident(idx, q, 5, params, res) for q in b] for b in batches]
    got = [[None] * 8 for _ in range(2)]
    errors = []

    def run(th):
        try:
            for i, q in enumerate(batches[th]):
                got[th][i] = t.search(q, 5, params, res=res)
        except Exception as e:  # noqa: BLE001 — relayed to the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(th,)) for th in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors, errors
    for th in range(2):
        for i in range(8):
            assert _bitwise(got[th][i], want[th][i])
    c = arena.snapshot_counts()
    assert c["evictions"] == c["inserts"] - c["occupancy"]
    assert all(p == 0 for p in arena._pins)


def test_a_resolve_waits_for_a_scan_in_flight_without_the_lock():
    """A demand resolve whose misses need slots that a scan in flight holds
    waits for that scan's completion event with the arena lock released:
    a prefetch (which takes the lock) completes meanwhile, and the resolve
    then evicts the released slots."""
    import threading

    res = _res()
    _, idx = _build(rows=1500, n_lists=40, pq_dim=8)
    arena = tiered.SlabArena(4, idx.list_codes.shape[1], idx.rot_dim,
                             device="cpu")
    t = tiered.TieredIvfPq.from_index(idx, res=res, arena=arena)
    slots, pinned = arena.resolve_probes(t, np.arange(4))
    assert sorted(pinned) == [0, 1, 2, 3]
    seen = {}

    class Scan:
        """A scan's completion event, as ``release`` records on the card:
        pending until ``synchronize``, which checks the lock is free."""
        done = False

        def query(self):
            return self.done

        def synchronize(self):
            box = {}
            th = threading.Thread(target=lambda: box.setdefault(
                "n", arena.prefetch(t, np.arange(2))))
            th.start()
            th.join(10)
            seen["prefetch_done_while_waiting"] = box.get("n")
            self.done = True

    with arena._lock:
        arena._inflight.append((Scan(), pinned))
    got, pinned2 = arena.resolve_probes(t, np.arange(4, 8))
    assert seen["prefetch_done_while_waiting"] == 2
    assert sorted(pinned2) == [0, 1, 2, 3] and not arena._inflight
    assert [arena._pins[s] for s in range(4)] == [1, 1, 1, 1]
    arena.release(pinned2)
    c = arena.snapshot_counts()
    assert c["evictions"] == c["inserts"] - c["occupancy"] == 4
