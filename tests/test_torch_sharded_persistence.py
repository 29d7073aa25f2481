"""Sharded checkpoints of raft_tpu_torch against raft_tpu's, on the CPU: JAX
on the first 4 devices of its 8-device virtual CPU mesh, the port on
``init_comms(["cpu"] * 4)``.

- raft_tpu's rank files and manifest restore in the port, strict and
  elastic, and the port's in raft_tpu (its elastic restore stacks the ranks
  with ``np.stack``, so the port writes them at one pad): IVF-Flat, IVF-PQ
  in the cache regime (lists decoded only) and in the LUT regime, both with
  overflow blocks.
- The port's restored searches: strict (every merge engine) bitwise equal
  to the index before saving, although the ranks now share the largest
  rank's pad; a full elastic restore bitwise equal to the allgather merge;
  a restore of raft_tpu's file bitwise equal to the same state carried over
  by ``interop``.
- Against raft_tpu's searches of the same files: distances within
  ``test_torch_sharded.py``'s tolerance (atol 1e-4·max‖x‖², IVF-PQ: of the
  largest ADC distance; rtol 1e-5), ids equal away from near-ties.
- A damaged checkpoint: ``verify_checkpoint``'s report, the strict
  restore's error and the degraded restore's coverage equal raft_tpu's; the
  degraded search is bitwise the allgather merge of the surviving ranks and
  within tolerance of raft_tpu's. ``load_manifest`` merges fragments; a
  rank in two files raises.
- Serving: ``elastic_searcher`` in an ``Engine`` reports the coverage, and
  ``swap_index`` to the full restore records the transition.
"""

import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from raft_tpu.core import errors as jerrors
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import sharded as jsh
from raft_tpu_torch import interop, serving
from raft_tpu_torch.core import errors
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import metrics as tmetrics
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import sharded as tsh
from raft_tpu_torch.testing import assert_topk_close

S, K = 4, 5
KINDS = ("flat", "pq_cache", "pq_lut")


def _rows(n, dim, seed):
    """Two blobs of very different spread: each rank's hot lists spill
    to its overflow block, and the ranks' list pads differ."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n // 2, dim)).astype(np.float32) * 0.05
    b = rng.standard_normal((n - n // 2, dim)).astype(np.float32)
    b += rng.standard_normal((n - n // 2, 1)).astype(np.float32) * 3.0
    return np.concatenate([a, b])[rng.permutation(n)]


@pytest.fixture(scope="module")
def data():
    rows = _rows(2000 + 20, 16, 11)
    return rows[:2000], rows[2000:]


def _jparams(kind):
    if kind == "flat":
        return jflat.IndexParams(n_lists=8, kmeans_n_iters=4,
                                 list_pad_expansion=1.01)
    return jpq.IndexParams(n_lists=8, pq_dim=8, kmeans_n_iters=4,
                           list_pad_expansion=1.01)


def _tparams(kind):
    if kind == "flat":
        return tflat.IndexParams(n_lists=8, kmeans_n_iters=4,
                                 list_pad_expansion=1.01)
    return tpq.IndexParams(n_lists=8, pq_dim=8, kmeans_n_iters=4,
                           list_pad_expansion=1.01)


def _jcomms():
    return jcomms.init_comms(jax.devices()[:S])


def _tcomms(size=S):
    return tcomms.init_comms(["cpu"] * size)


def _api(pkg, kind):
    """(serialize, strict restore, elastic restore, search, search params)
    of ``pkg`` (jsh or tsh) for ``kind``."""
    fam = "ivf_flat" if kind == "flat" else "ivf_pq"
    params = (jflat if pkg is jsh else tflat) if kind == "flat" else \
        (jpq if pkg is jsh else tpq)
    return (getattr(pkg, f"serialize_{fam}"), getattr(pkg, f"deserialize_{fam}"),
            getattr(pkg, f"deserialize_{fam}_elastic"),
            getattr(pkg, f"search_{fam}"), params.SearchParams(n_probes=3))


@pytest.fixture(scope="module")
def built(data):
    """Each package's sharded build of each kind."""
    db, _ = data
    out = {}
    for kind in KINDS:
        mode = None if kind == "flat" else kind[3:]
        if kind == "flat":
            j = jsh.build_ivf_flat(_jcomms(), db, _jparams(kind),
                                   res=JResources(seed=0))
            t = tsh.build_ivf_flat(_tcomms(), db, _tparams(kind),
                                   res=Resources(device="cpu", seed=0))
        else:
            j = jsh.build_ivf_pq(_jcomms(), db, _jparams(kind),
                                 res=JResources(seed=0), scan_mode=mode)
            t = tsh.build_ivf_pq(_tcomms(), db, _tparams(kind),
                                 res=Resources(device="cpu", seed=0),
                                 scan_mode=mode)
        out[kind] = (j, t)
    return out


@pytest.fixture(scope="module")
def files(built, tmp_path_factory):
    """Each package's checkpoint of each kind: {(writer, kind): prefix}."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for kind, (j, t) in built.items():
        for writer, pkg, index in (("jax", jsh, j), ("port", tsh, t)):
            os.makedirs(root / writer / kind)
            prefix = str(root / writer / kind / "index")
            _api(pkg, kind)[0](index, prefix)
            out[writer, kind] = prefix
    return out


def _equal(a, b):
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


def _close(got, want, kind, db):
    wv = np.asarray(want[0])
    atol = (1e-4 * float((db ** 2).sum(1).max()) if kind == "flat"
            else 1e-4 * float(np.abs(wv[np.isfinite(wv)]).max()))
    assert_topk_close(got, (wv, np.asarray(want[1])), atol, 1e-5)


def _ladder(search):
    first = search("allgather")
    for e in ("tree", "ring"):
        _equal(search(e), first)
    return first


def _carried(j, kind, tc):
    if kind == "flat":
        return interop.sharded_ivf_flat_from_numpy(
            tc, _tparams(kind), *(np.asarray(a) for a in (
                j.centers, j.list_data, j.list_indices, j.list_sizes)),
            j.bounds, np.asarray(j.overflow_data),
            np.asarray(j.overflow_indices))
    return interop.sharded_ivf_pq_from_numpy(
        tc, _tparams(kind), j.pq_dim, *(np.asarray(a) for a in (
            j.centers, j.rotation, j.codebooks, j.list_codes, j.list_indices,
            j.list_sizes)), j.bounds, scan_mode="lut",
        overflow_decoded=np.asarray(j.overflow_decoded),
        overflow_norms=np.asarray(j.overflow_norms),
        overflow_indices=np.asarray(j.overflow_indices))


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoints_restore_in_the_port(data, built, files, kind):
    db, q = data
    j, _ = built[kind]
    _, strict, elastic, search, sp = _api(tsh, kind)
    prefix = files["jax", kind]
    tc = _tcomms()
    restored = strict(prefix, tc)
    if kind != "flat":
        assert restored.scan_mode == kind[3:]
        assert all(i.lists_decoded_only == (kind == "pq_cache")
                   for i in restored.indexes)
    got = _ladder(lambda e: search(restored, q, K, sp, merge_mode=e))
    full = elastic(prefix, device="cpu")
    assert full.coverage == 1.0 and full.shard_ranks == list(range(S))
    res = full.search(q, K, sp)
    assert res.coverage == 1.0
    _equal(res, got)
    if kind != "pq_cache":  # interop carries the codes of a LUT build
        _equal(search(_carried(j, kind, tc), q, K, sp,
                      merge_mode="allgather"), got)
    _close(got, _api(jsh, kind)[3](j, q, K, _api(jsh, kind)[4]), kind, db)


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoints_restore_in_jax(data, built, files, kind):
    db, q = data
    _, t = built[kind]
    _, jstrict, jelastic, jsearch, jsp = _api(jsh, kind)
    _, strict, _, search, sp = _api(tsh, kind)
    prefix = files["port", kind]
    mine = search(t, q, K, sp, merge_mode="ring")
    pads = {i.list_indices.shape[1] for i in t.indexes}
    assert len(pads) > 1  # the ranks' pads differ before saving...
    restored = strict(prefix, _tcomms())
    assert {i.list_indices.shape[1] for i in restored.indexes} == {max(pads)}
    # ...and the searches stay bitwise across the change of pad
    _equal(_ladder(lambda e: search(restored, q, K, sp, merge_mode=e)), mine)
    j = jstrict(prefix, _jcomms())
    _close(mine, jsearch(j, q, K, jsp), kind, db)
    je = jelastic(prefix)  # np.stack over the ranks: one common pad
    _close(mine, je.search(q, K, jsp), kind, db)
    assert jsh.verify_checkpoint(prefix) == tsh.verify_checkpoint(prefix)
    assert tsh.verify_checkpoint(prefix)["ok"]


def _damage(prefix, delete=1, truncate=2):
    os.remove(f"{prefix}.rank{delete}")
    if truncate is not None:
        path = f"{prefix}.rank{truncate}"
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["flat", "pq_cache"])
def test_damaged_checkpoint_degrades_as_in_jax(data, built, files, tmp_path,
                                               writer, kind):
    db, q = data
    _, _, jelastic, _, jsp = _api(jsh, kind)
    _, _, elastic, search, sp = _api(tsh, kind)
    src = os.path.dirname(files[writer, kind])
    shutil.copytree(src, tmp_path / "c")
    prefix = str(tmp_path / "c" / "index")
    # one file missing: both strict restores name it
    _damage(prefix, truncate=None)
    with pytest.raises(ValueError) as je:
        jelastic(prefix)
    with pytest.raises(ValueError) as te:
        elastic(prefix, device="cpu")
    assert str(te.value) == str(je.value)
    assert f"{prefix}.rank1" in str(te.value)
    # and one truncated: the report, the errors and the coverage agree
    _damage(prefix, delete=3, truncate=2)
    report = tsh.verify_checkpoint(prefix)
    assert report == jsh.verify_checkpoint(prefix)
    assert report["files"] == {"index.rank0": "ok", "index.rank1": "missing",
                               "index.rank2": "truncated",
                               "index.rank3": "missing"}
    assert not report["ok"] and report["missing_ranks"] == [1, 2, 3]
    with pytest.raises(jerrors.IntegrityError) as je:
        jelastic(prefix)
    with pytest.raises(errors.IntegrityError) as te:
        elastic(prefix, device="cpu")
    assert (te.value.reason, te.value.record, te.value.path) == (
        je.value.reason, je.value.record, je.value.path) == (
        "truncated", te.value.record, f"{prefix}.rank2")
    degraded = elastic(prefix, allow_partial=True, device="cpu")
    jdegraded = jelastic(prefix, allow_partial=True)
    assert 0 < degraded.coverage < 1
    assert degraded.coverage == jdegraded.coverage
    assert degraded.shard_ranks == jdegraded.shard_ranks == [0]
    got = degraded.search(q, K, sp)
    assert got.coverage == degraded.coverage
    _close(got, jdegraded.search(q, K, jsp), kind, db)
    # bitwise the allgather merge over the surviving ranks' indexes
    cls = tsh.ShardedIvfFlat if kind == "flat" else tsh.ShardedIvfPq
    extra = () if kind == "flat" else (degraded.scan_mode,)
    survivors = cls(_tcomms(1), degraded.indexes, degraded.metric,
                    degraded.n_rows, [0, degraded.n_rows], *extra)
    _equal(got, search(survivors, q, K, sp, merge_mode="allgather"))


def test_checkpoint_counters_keep_their_names(files, tmp_path):
    verify = tmetrics.REGISTRY.counter("raft_tpu_checkpoint_verify_total",
                                       labelnames=("result",))
    status = tmetrics.REGISTRY.counter(
        "raft_tpu_checkpoint_file_status_total", labelnames=("status",))
    restores = tmetrics.REGISTRY.counter(
        "raft_tpu_checkpoint_restore_total", labelnames=("kind", "mode"))
    before = (verify.labels("ok").value, status.labels("ok").value,
              restores.labels("ivf_flat", "strict").value,
              restores.labels("ivf_flat", "full").value)
    prefix = files["port", "flat"]
    tsh.verify_checkpoint(prefix)
    tsh.deserialize_ivf_flat(prefix, _tcomms())
    tsh.deserialize_ivf_flat_elastic(prefix, device="cpu")
    after = (verify.labels("ok").value, status.labels("ok").value,
             restores.labels("ivf_flat", "strict").value,
             restores.labels("ivf_flat", "full").value)
    assert np.subtract(after, before).tolist() == [1, S, 1, 1]
    with pytest.raises(FileNotFoundError, match="manifest"):
        tsh.verify_checkpoint(str(tmp_path / "none"))


def test_manifest_fragments_merge_and_stale_ranks_raise(files, tmp_path):
    shutil.copytree(os.path.dirname(files["jax", "flat"]), tmp_path / "c")
    prefix = str(tmp_path / "c" / "index")
    whole = json.load(open(f"{prefix}.manifest"))
    os.remove(f"{prefix}.manifest")
    for p, names in enumerate((["index.rank0", "index.rank1"],
                               ["index.rank2", "index.rank3"])):
        frag = dict(whole, files={n: whole["files"][n] for n in names})
        with open(f"{prefix}.manifest.p{p}", "w") as f:
            json.dump(frag, f)
    assert tsh.load_manifest(prefix) == jsh.load_manifest(prefix) == whole
    assert tsh.verify_checkpoint(prefix)["ok"]
    with open(f"{prefix}.manifest.p2", "w") as f:
        json.dump(dict(whole, size=8), f)
    for pkg in (jsh, tsh):
        with pytest.raises(ValueError, match="disagrees"):
            pkg.load_manifest(prefix)
    os.remove(f"{prefix}.manifest.p2")
    # a stale file of another run holding rank 0 again
    shutil.copy(f"{prefix}.rank0", f"{prefix}.rank9")
    for pkg, kw in ((jsh, {}), (tsh, {"device": "cpu"})):
        with pytest.raises(ValueError, match="appears in both"):
            pkg.deserialize_ivf_flat_elastic(prefix, **kw)
    assert tsh.load_manifest(str(tmp_path / "none")) is None


def test_strict_restore_needs_the_same_rank_count(files):
    prefix = files["port", "pq_lut"]
    with pytest.raises(ValueError, match="sharded over 4 devices"):
        tsh.deserialize_ivf_pq(prefix, _tcomms(2))
    assert not glob.glob(prefix + "*.tmp.*")


def test_elastic_searcher_serves_coverage_and_swaps(data, files, tmp_path):
    _, q = data
    shutil.copytree(os.path.dirname(files["port", "flat"]), tmp_path / "c")
    prefix = str(tmp_path / "c" / "index")
    _damage(prefix, delete=2, truncate=None)
    params = tflat.SearchParams(n_probes=3)
    degraded = serving.elastic_searcher(
        tsh.deserialize_ivf_flat_elastic(prefix, allow_partial=True,
                                         device="cpu"), params)
    full = serving.make_searcher(
        "elastic", tsh.deserialize_ivf_flat_elastic(files["port", "flat"],
                                                    device="cpu"),
        params=params)
    assert degraded.family == full.family == "elastic_ivf_flat"
    assert 0 < degraded.coverage < 1 and full.coverage == 1.0
    eng = serving.Engine(degraded, serving.EngineConfig(
        max_batch=8, max_wait_us=2000, warm_ks=(K,)))
    with eng:
        rows = [eng.submit(row, K) for row in q[:6]]
        got = [f.result(timeout=60) for f in rows]
        assert eng.stats.coverage == degraded.coverage
        assert eng.health()["coverage"] == degraded.coverage
        assert eng.health()["status"] == "degraded"
        assert serving.verify_bit_identity(
            degraded, list(q[:6]), got, K, [f.placement for f in rows]) == 0
        old = eng.swap_index(full)
        assert old is degraded
        assert eng.stats.coverage_transitions == [(degraded.coverage, 1.0)]
        assert eng.stats.coverage == 1.0
        after = eng.submit(q[0], K).result(timeout=60)
    want = full.search(torch.from_numpy(q[:1]), K)
    np.testing.assert_array_equal(after[1], want[1][0].numpy())
    with pytest.raises(TypeError, match="ElasticIvf"):
        serving.elastic_searcher(object())
