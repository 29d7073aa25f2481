"""raft_tpu_torch's mutable write path against raft_tpu's, on the CPU.

- The WAL: the same op stream writes the same ``wal.log`` bytes in both
  packages; each package reads (``read_wal``, ``verify_wal``) the other's;
  a torn tail is ``IntegrityError(reason="torn_tail")`` and damage with
  bytes after it ``"corrupt"`` in both, from the same damaged file.
- State: a checkpoint directory (checkpoint + WAL tail) written by either
  package opens in the other to the same live ids, tombstone words, delta
  rows and ``applied_lsn``; the mirror equals raft_tpu's after the same ops.
- Search: IVF-Flat and IVF-PQ bases (L2 and inner product) built by
  raft_tpu and carried over by ``interop``, the same writes on both: the
  results agree within ``assert_topk_close``'s tolerance (distances rtol
  1e-5, atol 1e-6·max‖x‖²; IVF-PQ's ADC distances atol 1e-4·max‖x‖², as
  ``test_torch_ivf_pq.py`` holds them), no deleted or superseded id ever
  returned; a search repeats bitwise.
- The Compactor: its closed vocabularies, span and counter 1:1, the
  automatic triggers, ``crash_compactor`` and recovery, ``Engine.writer()``
  and the hot-swap publication.
- Kill -9: this file run as a script is the child writer (``python
  tests/test_torch_mutable.py DIR SEED MODE``), SIGKILLed mid-stream and
  mid-compaction; the recovered writer covers every acknowledged write and
  its live state is bitwise a never-crashed writer's fed ``ops[:applied]``.
- An amplified interleave twin over three seeds (a 100-seed sweep under the
  ``interleave`` marker).
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

if __name__ == "__main__":  # the kill -9 child: the port only
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

from raft_tpu_torch.core.errors import IntegrityError, RaftError  # noqa: E402
from raft_tpu_torch.core.resources import Resources  # noqa: E402
from raft_tpu_torch.neighbors import mutable  # noqa: E402
from raft_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from raft_tpu_torch.obs import spans as obs_spans  # noqa: E402

CHILD_DIM = 8


def make_ops(seed: int, n: int = 64):
    """A seeded (kind, ids, vectors) stream: adds of new explicit ids,
    upserts and deletes of live ids; op i commits as lsn i + 1."""
    rng = np.random.RandomState(seed)
    ops, live, next_id = [], [], 0
    for _ in range(n):
        roll = rng.rand()
        if roll < 0.6 or len(live) < 4:
            count = int(rng.randint(1, 4))
            ids = list(range(next_id, next_id + count))
            next_id += count
            live.extend(ids)
            ops.append(("add", ids,
                        rng.randn(count, CHILD_DIM).astype(np.float32)))
        elif roll < 0.85:
            id_ = live[int(rng.randint(len(live)))]
            ops.append(("upsert", [id_],
                        rng.randn(1, CHILD_DIM).astype(np.float32)))
        else:
            id_ = live.pop(int(rng.randint(len(live))))
            ops.append(("delete", [id_], None))
    return ops


def apply_op(writer, op):
    kind, ids, vectors = op
    if kind == "add":
        return writer.add(vectors, ids=ids)
    if kind == "upsert":
        return writer.upsert(vectors, ids)
    return writer.delete(ids)


def _child_main(directory: str, seed: int, mode: str) -> None:
    """The victim: apply the stream, print ``ACK <lsn>`` after each durable
    write, then park until killed."""
    writer = mutable.MutableIvf(directory, dim=CHILD_DIM, device="cpu",
                                group_window_s=0.0)
    if mode == "compact":
        mutable.Compactor(writer, delta_threshold=8, tombstone_ratio=0.05,
                          poll_s=0.005, min_rows=1).start()
    for op in make_ops(seed):
        apply_op(writer, op)
        print(f"ACK {writer.applied_lsn}", flush=True)
        time.sleep(0.002)
    print("DONE", flush=True)
    while True:
        time.sleep(1)


if __name__ == "__main__":
    _child_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    sys.exit(0)

import pytest  # noqa: E402

from raft_tpu.core.resources import Resources as JResources  # noqa: E402
from raft_tpu.neighbors import ivf_flat as jflat  # noqa: E402
from raft_tpu.neighbors import ivf_pq as jpq  # noqa: E402
from raft_tpu.neighbors import mutable as jmut  # noqa: E402
from raft_tpu.obs import metrics as jmetrics  # noqa: E402

from raft_tpu_torch import interop, serving  # noqa: E402
from raft_tpu_torch.neighbors import ivf_flat as tflat  # noqa: E402
from raft_tpu_torch.neighbors import ivf_pq as tpq  # noqa: E402
from raft_tpu_torch.testing import assert_topk_close, faults  # noqa: E402
from raft_tpu_torch.testing.interleave import (InterleaveAmplifier,  # noqa
                                               seeds)

CPU = Resources(device="cpu")
DIM, N_ROWS, K = 16, 1500, 5


def _twin(tmp_path, name, **kw):
    """A fresh raft_tpu writer and a fresh port writer with the same
    arguments (the port's on the CPU)."""
    kw.setdefault("group_window_s", 0.0)
    j_base, t_base = kw.pop("bases", (None, None))
    j = jmut.MutableIvf(str(tmp_path / f"j_{name}"), base=j_base,
                        registry=jmetrics.Registry(), **kw)
    t = mutable.MutableIvf(str(tmp_path / f"t_{name}"), base=t_base,
                           registry=obs_metrics.Registry(),
                           res=CPU, **kw)
    return j, t


def _live_state(writer):
    """(ids, vectors) of every live row sorted by id (rows round-trip the
    WAL as raw float32)."""
    snap = writer._compaction_snapshot()
    order = np.argsort(snap.ids, kind="stable")
    return snap.ids[order], snap.vectors[order]


def _mirror_state(writer):
    m = writer._mirror
    valid = m.ids[: m.count] >= 0
    return {"ids": m.ids[: m.count][valid].tolist(),
            "rows": m.rows[: m.count][valid].tobytes(),
            "lsns": m.lsns[: m.count][valid].tolist(),
            "tombs": sorted(m.tombs), "base_ids": sorted(m.base_ids),
            "words": np.asarray(m.words).tobytes(),
            "applied": m.applied_lsn, "next_id": m.next_id,
            "live": sorted(m.live_ids())}


def _metric(writer, name, *labels):
    fam = writer.registry.get(name)
    assert fam is not None, name
    return dict(fam.collect()).get(labels, type("z", (), {"value": 0})).value


# ------------------------------------------------------------------- WAL


def test_wal_bytes_equal_raft_tpu_for_the_same_op_stream(tmp_path):
    j, t = _twin(tmp_path, "wal", dim=CHILD_DIM)
    for op in make_ops(5):
        apply_op(j, op)
        apply_op(t, op)
    j.add(np.ones((2, CHILD_DIM), np.float32))  # auto-assigned ids
    assert list(t.add(np.ones((2, CHILD_DIM), np.float32))) == \
        list(range(t._mirror.next_id - 2, t._mirror.next_id))
    j.close()
    t.close()
    with open(j.wal_path, "rb") as a, open(t.wal_path, "rb") as b:
        assert a.read() == b.read()
    assert _mirror_state(j) == _mirror_state(t)


def test_read_and_verify_wal_across_packages(tmp_path):
    j, t = _twin(tmp_path, "rw", dim=CHILD_DIM)
    for op in make_ops(6)[:20]:
        apply_op(j, op)
        apply_op(t, op)
    j.close()
    t.close()
    for path in (j.wal_path, t.wal_path):
        a, b = jmut.read_wal(path), mutable.read_wal(path)
        assert (a.status, a.good_end) == (b.status, b.good_end) == \
            ("ok", os.path.getsize(path))
        assert [(r.lsn, r.op, r.ids.tolist(), r.vectors.tobytes())
                for r in a.records] == \
            [(r.lsn, r.op, r.ids.tolist(), r.vectors.tobytes())
             for r in b.records]
        assert jmut.verify_wal(path) == mutable.verify_wal(path)


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_torn_tail_and_corrupt_classified_as_raft_tpu(tmp_path, mode):
    _, t = _twin(tmp_path, "torn", dim=CHILD_DIM)
    for op in make_ops(7)[:12]:
        apply_op(t, op)
    faults.tear_wal_tail(t, mode=mode)
    t.close()
    a, b = jmut.read_wal(t.wal_path), mutable.read_wal(t.wal_path)
    assert a.status == b.status == "torn_tail"
    assert a.good_end == b.good_end and len(a.records) == len(b.records) == 11
    assert b.error.reason == "torn_tail" and b.error.record == 11
    # the same damage with bytes after it is corrupt
    other = str(tmp_path / "mid.log")
    _, t2 = _twin(tmp_path, "mid", dim=CHILD_DIM)
    for op in make_ops(7)[:12]:
        apply_op(t2, op)
    t2.close()
    faults.flip_record_byte(t2.wal_path, 3)
    os.replace(t2.wal_path, other)
    a, b = jmut.read_wal(other), mutable.read_wal(other)
    assert a.status == b.status == "corrupt"
    assert b.error.reason == "corrupt" and b.error.record == a.error.record
    with pytest.raises(IntegrityError) as ei:
        os.replace(other, t2.wal_path)
        mutable.MutableIvf(t2.directory, dim=CHILD_DIM, res=CPU,
                           registry=obs_metrics.Registry())
    assert ei.value.reason == "corrupt"


def test_torn_tail_recovery_is_typed_and_keeps_acked_writes(tmp_path):
    _, t = _twin(tmp_path, "rec", dim=CHILD_DIM)
    ops = make_ops(8)[:15]
    for op in ops:
        apply_op(t, op)
    faults.tear_wal_tail(t, mode="truncate")
    t.close()
    w = mutable.MutableIvf(t.directory, dim=CHILD_DIM, res=CPU,
                           registry=obs_metrics.Registry())
    assert w.recovery["status"] == "torn_tail"
    assert w.recovery["error"].reason == "torn_tail"
    assert w.applied_lsn == 14
    assert mutable.read_wal(w.wal_path).status == "ok"  # truncated
    w.close()


# ------------------------------------------------------------------ state


@pytest.fixture(scope="module")
def flat_bases():
    rng = np.random.default_rng(2)
    db = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
    out = {}
    for metric in ("sqeuclidean", "inner_product"):
        j = jflat.build(db, jflat.IndexParams(n_lists=16, metric=metric),
                        res=JResources(seed=0))
        t = interop.ivf_flat_index_from_numpy(
            tflat.IndexParams(n_lists=16, metric=metric),
            np.asarray(j.centers), np.asarray(j.list_data),
            np.asarray(j.list_indices), np.asarray(j.list_sizes), j.n_rows,
            np.asarray(j.overflow_data), np.asarray(j.overflow_indices),
            device="cpu")
        out[metric] = (j, t)
    return db, out


@pytest.fixture(scope="module")
def pq_bases():
    rng = np.random.default_rng(4)
    db = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
    out = {}
    for metric in ("sqeuclidean", "inner_product"):
        j = jpq.build(db, jpq.IndexParams(n_lists=16, pq_dim=8,
                                          metric=metric),
                      res=JResources(seed=0))
        t = interop.ivf_pq_index_from_numpy(
            tpq.IndexParams(n_lists=16, pq_dim=8, metric=metric), j.pq_dim,
            np.asarray(j.centers), np.asarray(j.rotation),
            np.asarray(j.codebooks), np.asarray(j.list_codes),
            np.asarray(j.list_indices), np.asarray(j.list_sizes), j.n_rows,
            np.asarray(j.overflow_codes), np.asarray(j.overflow_labels),
            np.asarray(j.overflow_indices), device="cpu")
        out[metric] = (j, t)
    return db, out


def _write_stream(rng, writers, n_base, dim, rounds=3):
    """Adds of new ids, upserts and deletes of base ids, on every writer."""
    deleted, upserted = set(), set()
    next_id = n_base + 1000
    for _ in range(rounds):
        add = rng.standard_normal((20, dim)).astype(np.float32)
        add_ids = np.arange(next_id, next_id + 20)
        next_id += 20
        ups_ids = rng.choice(n_base, 10, replace=False)
        ups = rng.standard_normal((10, dim)).astype(np.float32)
        del_ids = rng.choice(n_base, 10, replace=False)
        for w in writers:
            w.add(add, ids=add_ids)
            w.upsert(ups, ups_ids)
            w.delete(del_ids)
        upserted |= set(ups_ids.tolist())
        deleted |= set(del_ids.tolist())
        upserted -= set(del_ids.tolist())
    return deleted, upserted


def test_mirror_and_tombstone_words_equal_raft_tpu(tmp_path, flat_bases):
    db, bases = flat_bases
    j_base, t_base = bases["sqeuclidean"]
    j, t = _twin(tmp_path, "mirror", bases=(j_base, t_base))
    _write_stream(np.random.default_rng(1), (j, t), N_ROWS, DIM)
    assert _mirror_state(j) == _mirror_state(t)
    assert j.stats() == t.stats()
    j.close()
    t.close()


@pytest.mark.parametrize("direction", ["raft_tpu_to_port", "port_to_raft_tpu"])
def test_checkpoint_directories_cross_both_ways(tmp_path, flat_bases,
                                                direction):
    db, bases = flat_bases
    j_base, t_base = bases["sqeuclidean"]
    j, t = _twin(tmp_path, "ckpt", bases=(j_base, t_base))
    rng = np.random.default_rng(9)
    _write_stream(rng, (j, t), N_ROWS, DIM, rounds=2)
    writer = j if direction == "raft_tpu_to_port" else t
    writer.checkpoint()
    tail_ids = np.arange(50_000, 50_003)
    tail = rng.standard_normal((3, DIM)).astype(np.float32)
    for w in (j, t):
        w.add(tail, ids=tail_ids)  # after the checkpoint: the WAL tail
        w.delete([int(tail_ids[0])])
    want = _mirror_state(writer)
    writer.close()
    if direction == "raft_tpu_to_port":
        other = mutable.MutableIvf(writer.directory, res=CPU,
                                   registry=obs_metrics.Registry())
    else:
        other = jmut.MutableIvf(writer.directory,
                                registry=jmetrics.Registry())
    assert other.recovery["replayed"] == 2
    got = _mirror_state(other)
    assert got == want
    assert other.applied_lsn == writer.applied_lsn
    assert other.family == "ivf_flat" and other.metric.name == "L2Expanded"
    other.close()
    (t if writer is j else j).close()


# ----------------------------------------------------------------- search


def _check_search(j, t, db, deleted, upserted, atol_scale, n_queries=24):
    rng = np.random.default_rng(31)
    q = rng.standard_normal((n_queries, DIM)).astype(np.float32)
    jv, ji = j.search(q, K)
    tv, ti = t.search(q, K)
    scale = float((db * db).sum(1).max())
    assert_topk_close((tv, ti), (np.asarray(jv), np.asarray(ji)),
                      atol_scale * scale, 1e-5, "mutable search")
    ids = ti.numpy()
    assert not set(ids.ravel().tolist()) & deleted
    # an upserted base id surfaces only with its new vector's distance
    again = t.search(q, K)
    assert torch.equal(again[0].view(torch.int32), tv.view(torch.int32))
    assert torch.equal(again[1], ti)
    return ids


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_flat_search_matches_raft_tpu(tmp_path, flat_bases, metric):
    db, bases = flat_bases
    j, t = _twin(tmp_path, f"fs_{metric}", bases=bases[metric],
                 search_params=None)
    t.search_params = tflat.SearchParams(n_probes=8)
    j.search_params = jflat.SearchParams(n_probes=8)
    deleted, upserted = _write_stream(np.random.default_rng(3), (j, t),
                                      N_ROWS, DIM)
    _check_search(j, t, db, deleted, upserted, 1e-6)
    if metric == "sqeuclidean":
        # a superseded base copy never surfaces: the upserted row finds its
        # id once, first
        up = sorted(upserted)[0]
        row = t._mirror.rows[t._mirror.slot_of[up]]
        d, i = t.search(row[None, :], K)
        assert int(i[0, 0]) == up and i[0].tolist().count(up) == 1
    j.close()
    t.close()


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_pq_search_matches_raft_tpu(tmp_path, pq_bases, metric):
    db, bases = pq_bases
    j, t = _twin(tmp_path, f"ps_{metric}", bases=bases[metric],
                 family="ivf_pq")
    t.search_params = tpq.SearchParams(n_probes=8)
    j.search_params = jpq.SearchParams(n_probes=8, scan_mode="cache")
    deleted, upserted = _write_stream(np.random.default_rng(5), (j, t),
                                      N_ROWS, DIM)
    _check_search(j, t, db, deleted, upserted, 1e-4)
    j.close()
    t.close()


def test_empty_and_delta_only_search(tmp_path):
    w = mutable.MutableIvf(str(tmp_path / "e"), dim=4, res=CPU,
                           registry=obs_metrics.Registry(),
                           group_window_s=0.0)
    d, i = w.search(np.zeros((2, 4), np.float32), 3)
    assert bool(torch.isinf(d).all()) and bool((i == -1).all())
    w.add(np.eye(4, dtype=np.float32)[:2])
    d, i = w.search(np.eye(4, dtype=np.float32)[:1], 3)
    assert i[0].tolist() == [0, 1, -1] and float(d[0, 0]) == 0.0
    w.close()


def test_delta_distances_chunked_by_workspace():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((37, 8)).astype(np.float32))
    rows = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    from raft_tpu_torch.ops.distance import DistanceType
    for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct,
                   DistanceType.CosineExpanded,
                   DistanceType.L2SqrtExpanded):
        whole = mutable._delta_distances(q, rows, metric)
        tiny = mutable._delta_distances(q, rows, metric, 64 * 4 * 3 * 5)
        assert torch.equal(whole, tiny)
        if metric == DistanceType.L2Expanded:
            want = ((q[:, None] - rows[None]) ** 2).sum(-1)
            assert torch.allclose(whole, want, atol=1e-4)


# ------------------------------------------------------------- compactor


def _writer(tmp_path, name="c", **kw):
    kw.setdefault("dim", CHILD_DIM)
    kw.setdefault("registry", obs_metrics.Registry())
    kw.setdefault("span_sink", obs_spans.ListSink())
    kw.setdefault("group_window_s", 0.0)
    kw.setdefault("index_params", tflat.IndexParams(n_lists=4))
    return mutable.MutableIvf(str(tmp_path / name), res=CPU, **kw)


def test_compaction_vocabularies_and_counters_reconcile(tmp_path):
    w = _writer(tmp_path)
    comp = mutable.Compactor(w, min_rows=2)
    with pytest.raises(ValueError, match="unknown compaction reason"):
        comp.request("because")
    with pytest.raises(ValueError, match="unknown compaction reason"):
        comp.run_once("because")
    assert comp.run_once("manual") == "skipped"  # empty
    rng = np.random.default_rng(0)
    w.add(rng.standard_normal((40, CHILD_DIM)).astype(np.float32))
    w.delete([3, 4])
    before = _live_state(w)
    assert comp.run_once("manual") == "ok"
    assert comp.run_once("delta_threshold") == "ok"
    after = _live_state(w)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    spans = [s for s in w.span_sink.records if s["kind"] == "compaction"]
    assert [(s["reason"], s["outcome"]) for s in spans] == [
        ("manual", "skipped"), ("manual", "ok"), ("delta_threshold", "ok")]
    assert {s["outcome"] for s in spans} <= mutable.COMPACTION_OUTCOMES
    fam = w.registry.get("raft_tpu_mutable_compactions_total")
    assert sum(c.value for _, c in fam.collect()) == len(spans) == comp.runs
    assert w.stats()["delta_rows"] == 0 and w.stats()["base_rows"] == 38
    # the compacted base searches: its rows are found exactly
    q = after[1][:3]
    d, i = w.search(q, 1)
    assert i[:, 0].tolist() == after[0][:3].tolist()
    w.close()


def test_compaction_auto_triggers(tmp_path):
    w = _writer(tmp_path)
    comp = mutable.Compactor(w, delta_threshold=8, tombstone_ratio=0.5,
                             interval_s=None)
    assert comp._auto_reason() is None
    w.add(np.ones((8, CHILD_DIM), np.float32))
    assert comp._auto_reason() == "delta_threshold"
    assert comp.run_once("delta_threshold") == "ok"
    w.delete(list(range(5)))
    assert comp._auto_reason() == "tombstone_ratio"
    comp2 = mutable.Compactor(w, interval_s=0.0)
    assert comp2._auto_reason() in ("tombstone_ratio", "interval")
    w.close()


def test_background_compactor_and_stall(tmp_path):
    w = _writer(tmp_path)
    comp = mutable.Compactor(w, delta_threshold=16, poll_s=0.005,
                             stall_timeout_s=0.0, min_rows=1).start()
    w.add(np.random.default_rng(1).standard_normal(
        (20, CHILD_DIM)).astype(np.float32))
    deadline = time.time() + 30
    while comp.runs == 0 and time.time() < deadline:
        time.sleep(0.01)
    comp.stop()
    assert comp.runs >= 1
    assert _metric(w, "raft_tpu_mutable_compaction_stalls_total",
                   w.name) >= 1
    assert w.span_sink.by_kind("compaction_stall")
    w.close()


def test_ivf_pq_compaction_extends_and_keeps_upserts(tmp_path, pq_bases):
    db, bases = pq_bases
    _, t_base = bases["sqeuclidean"]
    w = _writer(tmp_path, "pq", dim=None, base=t_base, family="ivf_pq",
                index_params=None)
    rng = np.random.default_rng(2)
    w.add(rng.standard_normal((12, DIM)).astype(np.float32),
          ids=np.arange(9000, 9012))
    w.upsert(rng.standard_normal((2, DIM)).astype(np.float32), [5, 6])
    live = w.live_ids()
    assert mutable.Compactor(w).run_once("manual") == "ok"
    assert np.array_equal(w.live_ids(), live)
    assert w.stats()["delta_rows"] == 2  # the upserted base ids stay delta
    ids = w.base.list_indices.numpy()
    assert (ids == 9000).sum() == 1 and (ids == 5).sum() == 1
    w.close()


def test_crash_compactor_recovers_and_republishes(tmp_path, flat_bases):
    w = _writer(tmp_path, "crash")
    rng = np.random.default_rng(13)
    w.add(rng.standard_normal((24, CHILD_DIM)).astype(np.float32))
    eng = serving.Engine(serving.mutable_ivf_searcher(w),
                         serving.EngineConfig(max_batch=4, max_wait_us=500,
                                              warm_ks=(3,)))
    eng.start()
    try:
        comp = mutable.Compactor(w, publish=eng)
        gen0 = eng.searcher_generation
        with faults.crash_compactor(eng) as c:
            assert c is comp
            assert comp.run_once("manual") == "failed"
        assert isinstance(comp.last_error, mutable.CompactorCrashed)
        assert eng.searcher_generation == gen0  # never published
        state = _live_state(w)
        eng.writer().add(rng.standard_normal((3, CHILD_DIM))
                         .astype(np.float32))
        assert comp.run_once("manual") == "ok"
        assert eng.searcher_generation == gen0 + 1
        span = w.span_sink.by_kind("compaction")[-1]
        assert span["searcher_gen"] == gen0 + 1
    finally:
        eng.stop()
    w.close()
    # the crashed run's checkpoint (and WAL) recover the acked state
    r = mutable.MutableIvf(w.directory, res=CPU,
                           registry=obs_metrics.Registry())
    ids, _ = _live_state(r)
    assert set(state[0].tolist()) < set(ids.tolist())
    assert len(ids) == 27
    r.close()


def test_engine_writer_and_swap_index_publication(tmp_path, flat_bases):
    db, bases = flat_bases
    _, t_base = bases["sqeuclidean"]
    s = serving.ivf_flat_searcher(t_base)
    with pytest.raises(TypeError, match="no write surface"):
        serving.Engine(s).writer()
    w = _writer(tmp_path, "eng", dim=None, base=t_base, index_params=None)
    eng = serving.Engine(serving.mutable_ivf_searcher(w),
                         serving.EngineConfig(max_batch=4, max_wait_us=500,
                                              warm_ks=(K,)))
    with eng:
        assert eng.writer() is w
        new = np.random.default_rng(3).standard_normal(
            (4, DIM)).astype(np.float32)
        ids = eng.writer().add(new)
        d, i = eng.search(new[0], K)
        assert int(np.asarray(i)[0]) == int(ids[0])
        eng.writer().delete([int(ids[0])])
        d, i = eng.search(new[0], K)
        assert int(ids[0]) not in np.asarray(i).tolist()
        comp = mutable.Compactor(w, publish=eng)
        assert comp.run_once("manual") == "ok"
        assert eng.searcher_generation == 1
        d, i = eng.search(new[1], K)
        assert int(np.asarray(i)[0]) == int(ids[1])
    w.close()


def test_verify_dir_classification(tmp_path):
    w = _writer(tmp_path, "v")
    for op in make_ops(3)[:10]:
        apply_op(w, op)
    assert mutable.verify_dir(w.directory)["status"] == "ok"
    w.checkpoint()
    w.add(np.ones((1, CHILD_DIM), np.float32))
    faults.tear_wal_tail(w)
    w.close()
    got, want = mutable.verify_dir(w.directory), jmut.verify_dir(w.directory)
    assert got["status"] == want["status"] == "torn_tail"
    assert got["replay"] == want["replay"]
    assert got["checkpoint"]["applied_lsn"] == \
        want["checkpoint"]["applied_lsn"] == 10
    assert mutable.verify_dir(str(tmp_path / "none"))["status"] == "missing"


# ------------------------------------------------------------ kill -9 suite


def _run_victim(directory, seed, mode, kill_after_acks):
    """Run this file as the child writer, SIGKILL it after
    ``kill_after_acks`` acknowledged writes; returns the highest acked
    lsn."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), directory, str(seed),
         mode], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=env)
    acked = 0
    try:
        for line in proc.stdout:
            if line.startswith("ACK"):
                acked = int(line.split()[1])
                if acked >= kill_after_acks:
                    break
            elif line.startswith("DONE"):
                break
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=60)
    assert acked > 0, "the child never acknowledged a write"
    return acked


def _assert_recovered_matches_oracle(directory, seed, acked, tmp_path):
    w = mutable.MutableIvf(directory, dim=CHILD_DIM, res=CPU,
                           registry=obs_metrics.Registry(),
                           group_window_s=0.0)
    rec = w.recovery
    assert rec["status"] in ("ok", "torn_tail")
    if rec["status"] == "torn_tail":
        assert rec["error"].reason == "torn_tail"
    applied = w.applied_lsn
    assert applied >= acked, f"acked lsn {acked}, recovered {applied}"
    oracle = mutable.MutableIvf(str(tmp_path / "oracle"), dim=CHILD_DIM,
                                res=CPU, registry=obs_metrics.Registry(),
                                group_window_s=0.0)
    for op in make_ops(seed)[:applied]:
        apply_op(oracle, op)
    got, want = _live_state(w), _live_state(oracle)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()
    if w.base is None:  # all delta on both sides: the searches too
        q = np.random.default_rng(seed).standard_normal(
            (5, CHILD_DIM)).astype(np.float32)
        a, b = w.search(q, 4), oracle.search(q, 4)
        assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
        assert torch.equal(a[1], b[1])
    w.close()
    oracle.close()


@pytest.mark.parametrize("mode,seed,kill_after", [("plain", 101, 20),
                                                  ("compact", 202, 30)])
def test_kill9_recovery_bitwise_a_never_crashed_writer(tmp_path, mode, seed,
                                                       kill_after):
    directory = str(tmp_path / "victim")
    acked = _run_victim(directory, seed, mode, kill_after)
    _assert_recovered_matches_oracle(directory, seed, acked, tmp_path)


# ------------------------------------------------- amplified interleaving


def _interleave_round(tmp_path, seed, n_ops=6):
    """Two writer threads on disjoint ids, a searcher and an eager
    compactor under the amplifier; then the exact final state and the
    counters reconciled."""
    reg = obs_metrics.Registry()
    sink = obs_spans.ListSink()
    w = mutable.MutableIvf(str(tmp_path / f"s{seed}"), dim=4, res=CPU,
                           registry=reg, span_sink=sink,
                           group_window_s=0.0, name=f"s{seed}",
                           index_params=tflat.IndexParams(n_lists=2))
    comp = mutable.Compactor(w, delta_threshold=4, poll_s=0.002,
                             min_rows=1)
    expect: dict = {}
    errors: list = []

    def writer_thread(tid):
        rng = np.random.RandomState(seed * 31 + tid)
        base_id = tid * 1000
        try:
            for i in range(n_ops):
                vec = rng.randn(1, 4).astype(np.float32)
                w.upsert(vec, [base_id + i])
                expect[base_id + i] = vec[0]
            w.delete([base_id])
            del expect[base_id]
        except (RaftError, ValueError) as e:  # pragma: no cover
            errors.append(e)

    def searcher_thread():
        rng = np.random.RandomState(seed)
        try:
            for _ in range(3):
                _, i = w.search(rng.randn(1, 4).astype(np.float32), 3)
                ids = i.numpy().ravel()
                ids = ids[ids >= 0]
                assert len(set(ids.tolist())) == len(ids), "duplicate ids"
        except (RaftError, ValueError, AssertionError) as e:
            errors.append(e)

    with InterleaveAmplifier(seed=seed,
                             path_filters=("neighbors/mutable.py",)):
        comp.start()
        threads = [threading.Thread(target=writer_thread, args=(t,))
                   for t in range(2)]
        threads.append(threading.Thread(target=searcher_thread))
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        comp.stop()
    assert not errors, errors
    ids, vecs = _live_state(w)
    assert list(ids) == sorted(expect)
    for id_, vec in zip(ids, vecs):
        np.testing.assert_array_equal(vec, expect[int(id_)])
    n_writes = 2 * (n_ops + 1)
    writes = sum(c.value for _, c in reg.get(
        "raft_tpu_mutable_writes_total").collect())
    acks = dict(reg.get("raft_tpu_mutable_acks_total").collect())[
        (w.name,)].value
    assert writes == acks == n_writes
    spans = [s for s in sink.records if s["kind"] == "compaction"]
    fam = reg.get("raft_tpu_mutable_compactions_total")
    assert sum(c.value for _, c in fam.collect()) == len(spans)
    assert w.applied_lsn == n_writes
    w.close()


def test_mutable_interleave_fast_twin(tmp_path):
    for seed in seeds(3):
        _interleave_round(tmp_path, seed)


@pytest.mark.slow
@pytest.mark.interleave
def test_mutable_interleave_100_seeds(tmp_path):
    for seed in seeds(100):
        _interleave_round(tmp_path, seed)
