"""Narrow IVF-Flat lists (int8, uint8, fp16) in raft_tpu_torch against
raft_tpu, on the CPU.

- The kernels' plain versions over narrow lists are bitwise the same
  function of the lists cast to f32 (every int8, uint8 and fp16 value is
  exact in f32), and agree with raft_tpu's Pallas kernels in interpret
  mode (rtol 1e-5, atol 1e-4·max‖row‖²).
- One raft_tpu build of each type, carried over by ``interop`` (a 100-wide
  int8 case among them) and searched by both packages on the fused route,
  the filtered route (held to raft_tpu's ``use_pallas=True,
  pallas_interpret=True`` core, as ``test_torch_ivf_flat.py`` does) and the
  forced tiled route: ids equal and distances within rtol 1e-5 (integer
  rows and queries give integer distances, exact in both packages; fp16
  adds atol 1e-4·max‖x‖², sums in another order).
- ``extend`` of narrow rows (overflow rows too) packs as raft_tpu packs.
- Narrow index files are byte for byte raft_tpu's, both ways.
- The sharded uint8 path: the port's own sharded build (4 ranks) and its
  checkpoint, restored by raft_tpu (JAX on 4 of its 8 virtual CPU
  devices), searched by both; its recall and its strict restore;
  ``scan_dtype`` over narrow lists refused by both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.ops import pallas_kernels as pk
from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import sharded as jsh
from raft_tpu_torch import interop
from raft_tpu_torch.bench.datagen import low_rank_clusters
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import sharded as tsh
from raft_tpu_torch.stats import neighborhood_recall
from raft_tpu_torch.testing import assert_topk_close

NARROW = ["uint8", "int8", "float16"]


def _narrow_rows(dtype: str, n: int, dim: int, seed: int) -> np.ndarray:
    """Clustered rows (the benchmark generator) mapped onto the type's
    range: uint8 affinely onto 0..255, int8 onto -127..127, fp16 cast."""
    x = low_rank_clusters(np.random.default_rng(seed), n, dim)
    if dtype == "uint8":
        lo, hi = x.min(), x.max()
        return np.round((x - lo) * (255.0 / (hi - lo))).astype(np.uint8)
    if dtype == "int8":
        return np.round(x * (127.0 / np.abs(x).max())).astype(np.int8)
    return x.astype(np.float16)


def _atol(dtype: str, db: np.ndarray, q: np.ndarray) -> float:
    """0 for integer rows (exact distances), else 1e-4·max‖x‖²."""
    if dtype != "float16":
        return 0.0
    return 1e-4 * float(max((db.astype(np.float32) ** 2).sum(1).max(),
                            (q.astype(np.float32) ** 2).sum(1).max()))


def _assert_same(got, want, atol: float):
    """Ids equal and distances within rtol 1e-5 (+ atol)."""
    gv, gi = (np.asarray(t) for t in got)
    wv, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=atol)


# ------------------------------------------------- the kernels' plain versions


def _kernel_inputs(dtype, rot, seed=3, L=6, pad=40, nq=5, P=3):
    rng = np.random.default_rng(seed)
    data = _narrow_rows(dtype, L * pad, rot, seed).reshape(L, pad, rot)
    ids = np.arange(L * pad, dtype=np.int32).reshape(L, pad)
    ids[:, -4:] = -1
    probes = rng.integers(0, L, (nq, P)).astype(np.int32)
    qres = rng.standard_normal((nq, P, rot)).astype(np.float32) * 20
    return data, ids, probes, qres


@pytest.mark.parametrize("dtype", NARROW)
@pytest.mark.parametrize("rot", [100, 98, 3])
def test_plain_fused_ivf_topk_on_narrow_lists(dtype, rot):
    data, ids, probes, qres = _kernel_inputs(dtype, rot)
    d = torch.from_numpy(data)
    norms = (d.float() ** 2).sum(-1)
    pr, qr, li = (torch.from_numpy(a) for a in (probes, qres, ids))
    qn = (qr ** 2).sum(-1)
    got = gk.fused_ivf_topk(pr, qr, qn, d, norms, li, 7)
    twin = gk.fused_ivf_topk(pr, qr, qn, d.float(), norms, li, 7)
    assert torch.equal(got[0].view(torch.int32), twin[0].view(torch.int32))
    assert torch.equal(got[1], twin[1])
    want = pk.fused_ivf_topk(probes, qres, qn.numpy(), jnp.asarray(data),
                             norms.numpy(), ids, 7, clamp=True,
                             interpret=True)
    assert_topk_close(got, (np.asarray(want[0]), np.asarray(want[1])),
                      1e-4 * float(max(norms.max(), qn.max())), 1e-5)


@pytest.mark.parametrize("dtype", NARROW)
@pytest.mark.parametrize("rot", [100, 98, 3])
def test_plain_ivf_scan_on_narrow_lists(dtype, rot):
    data, _, probes, qres = _kernel_inputs(dtype, rot, seed=4)
    d = torch.from_numpy(data)
    norms = (d.float() ** 2).sum(-1)
    pr, qr = torch.from_numpy(probes), torch.from_numpy(qres)
    got = gk.ivf_scan(pr, qr, d, norms)
    twin = gk.ivf_scan(pr, qr, d.float(), norms)
    assert torch.equal(got.view(torch.int32), twin.view(torch.int32))
    want = pk.ivf_scan(probes, qres, jnp.asarray(data), norms.numpy(),
                       interpret=True)
    scale = float(max(norms.max(), (qr ** 2).sum(-1).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4 * scale)


def test_row_types_are_the_kernels_codes():
    assert gk.ROW_TYPES == {torch.float32: 0, torch.bfloat16: 1,
                            torch.float16: 2, torch.int8: 3, torch.uint8: 4}
    with pytest.raises(TypeError, match="list rows"):
        tivf.build(np.zeros((64, 4), np.int32), tivf.IndexParams(n_lists=2),
                   device="cpu")


# ------------------------------------------------ searches on carried state

_SHAPES = {"uint8": (32, 0), "int8": (100, 1), "float16": (32, 2)}


@pytest.fixture(scope="module", params=NARROW)
def narrow_pair(request):
    """(dtype, db, q, raft_tpu's index, the port's carried copy)."""
    dtype = request.param
    dim, seed = _SHAPES[dtype]
    rows = _narrow_rows(dtype, 2600, dim, 10 + seed)
    db, q = rows[:2500], rows[2500:]
    j = jivf.build(db, jivf.IndexParams(n_lists=12), res=JResources(seed=1))
    assert np.asarray(j.list_data).dtype == np.dtype(dtype)
    t = interop.ivf_flat_index_from_numpy(
        tivf.IndexParams(n_lists=12), np.asarray(j.centers),
        np.asarray(j.list_data), np.asarray(j.list_indices),
        np.asarray(j.list_sizes), j.n_rows, np.asarray(j.overflow_data),
        np.asarray(j.overflow_indices), device="cpu")
    assert t.list_data.dtype == getattr(torch, dtype)
    return dtype, db, q, j, t


@pytest.mark.parametrize("k", [1, 10])
def test_fused_route_matches_jax_pallas_interpret(narrow_pair, monkeypatch,
                                                  k):
    monkeypatch.setenv("RAFT_TPU_PALLAS_INTERPRET", "1")
    dtype, db, q, j, t = narrow_pair
    q = q[:40]
    want = jivf.search(j, q, k, jivf.SearchParams(n_probes=3,
                                                  scan_mode="pallas"))
    calls = []
    real = gk.fused_ivf_topk
    monkeypatch.setattr(gk, "fused_ivf_topk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tivf.search(t, q, k, tivf.SearchParams(n_probes=3))
    assert calls
    _assert_same(got, want, _atol(dtype, db, q))


def test_filtered_route_matches_jax_use_pallas(narrow_pair, monkeypatch):
    dtype, db, q, j, t = narrow_pair
    q = q[:12]  # one tile of raft_tpu's scan in interpret mode
    mask = np.random.default_rng(5).random(len(db)) < 0.7
    want = jivf.search_core(
        q, j.centers, j.list_data, j.list_indices, j.list_sizes,
        JBitset.from_mask(mask).words, j.metric, 10, 4, q.shape[0], True,
        row_norms=j.ensure_row_norms(), use_pallas=True,
        pallas_interpret=True, overflow_data=j.overflow_data,
        overflow_indices=j.overflow_indices,
        has_overflow=j.overflow_data.shape[0] > 0)
    calls = []
    real = gk.ivf_scan
    monkeypatch.setattr(gk, "ivf_scan",
                        lambda *a: calls.append(1) or real(*a))
    got = tivf.search(t, q, 10, tivf.SearchParams(n_probes=4),
                      filter=Bitset.from_mask(torch.from_numpy(mask)))
    assert calls
    _assert_same(got, want, _atol(dtype, db, q))
    assert mask[got[1].numpy()].all()


def test_forced_tiled_route_matches_jax(narrow_pair):
    dtype, db, q, j, t = narrow_pair
    want = jivf.search(j, q, 10, jivf.SearchParams(n_probes=4,
                                                   scan_mode="xla"))
    got = tivf.search(t, q, 10, tivf.SearchParams(n_probes=4,
                                                  scan_mode="xla"))
    _assert_same(got, want, _atol(dtype, db, q))


def test_port_build_recall_and_twin(narrow_pair):
    """The port's own narrow build: recall against the exact search of the
    rows as f32 within 0.02 of raft_tpu's build, and bitwise the search of
    the same lists cast to f32."""
    dtype, db, q, j, _ = narrow_pair
    t = tivf.build(db, tivf.IndexParams(n_lists=12),
                   res=Resources(device="cpu", seed=1))
    assert t.list_data.dtype == getattr(torch, dtype)
    _, gt = tbf.knn(q.astype(np.float32), db.astype(np.float32), 10,
                    metric="sqeuclidean", device="cpu")
    sp = tivf.SearchParams(n_probes=4)
    got = tivf.search(t, q, 10, sp)
    twin = tivf.Index(t.params, t.centers, t.list_data.float(),
                      t.list_indices, t.list_sizes, t.n_rows,
                      t.overflow_data.float(), t.overflow_indices)
    want = tivf.search(twin, q, 10, sp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jrec = float(neighborhood_recall(np.asarray(jivf.search(
        j, q, 10, jivf.SearchParams(n_probes=4))[1]), gt.numpy()))
    assert float(neighborhood_recall(got[1], gt)) >= jrec - 0.02


# ------------------------------------------------------------------ extend


@pytest.mark.parametrize("dtype", NARROW)
def test_extend_packs_narrow_rows_as_jax(dtype):
    rows = _narrow_rows(dtype, 900, 16, 20)
    base, new = rows[:600], rows[600:]
    j = jivf.build(base, jivf.IndexParams(n_lists=6, list_pad_expansion=1.01),
                   res=JResources(seed=2))
    t = interop.ivf_flat_index_from_numpy(
        tivf.IndexParams(n_lists=6, list_pad_expansion=1.01),
        *(np.asarray(a) for a in (j.centers, j.list_data, j.list_indices,
                                  j.list_sizes)), j.n_rows,
        np.asarray(j.overflow_data), np.asarray(j.overflow_indices),
        device="cpu")
    j2 = jivf.extend(j, new)
    t2 = tivf.extend(t, new)
    assert t2.n_rows == j2.n_rows == 900
    assert np.asarray(j2.overflow_indices).shape[0] > 0  # rows spilled
    for name in ("list_data", "list_indices", "list_sizes", "overflow_data",
                 "overflow_indices"):
        np.testing.assert_array_equal(getattr(t2, name).numpy(),
                                      np.asarray(getattr(j2, name)), name)
    assert t2.list_data.dtype == getattr(torch, dtype)
    # f32 rows into a narrow index are stored in its row type
    t3 = tivf.extend(t, new.astype(np.float32))
    assert t3.list_data.dtype == t.list_data.dtype
    np.testing.assert_array_equal(t3.list_data.numpy(), t2.list_data.numpy())


# ------------------------------------------------------------- the files


def test_narrow_files_cross_both_ways_byte_for_byte(narrow_pair, tmp_path):
    dtype, db, q, j, t = narrow_pair
    jp, tp = tmp_path / "j.ivf", tmp_path / "t.ivf"
    jivf.serialize(j, str(jp))
    tivf.serialize(t, str(tp))
    assert jp.read_bytes() == tp.read_bytes()
    back = tivf.deserialize(str(jp), device="cpu")
    assert back.list_data.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(back.list_data.numpy(),
                                  np.asarray(j.list_data))
    sp = tivf.SearchParams(n_probes=4)
    got = tivf.search(back, q, 10, sp)
    ref = tivf.search(t, q, 10, sp)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    jback = jivf.deserialize(str(tp))
    assert np.asarray(jback.list_data).dtype == np.dtype(dtype)
    _assert_same(got, jivf.search(jback, q, 10,
                                  jivf.SearchParams(n_probes=4)),
                 _atol(dtype, db, q))


# ------------------------------------------------------------- sharded


@pytest.fixture(scope="module")
def sharded_u8(tmp_path_factory):
    """The port's own sharded uint8 build (4 ranks), its checkpoint, and
    raft_tpu's restore of that checkpoint (JAX on 4 virtual devices)."""
    rows = _narrow_rows("uint8", 2100, 16, 30)
    db, q = rows[:2000], rows[2000:]
    tc = tcomms.init_comms(["cpu"] * 4)
    index = tsh.build_ivf_flat(tc, db, tivf.IndexParams(n_lists=4),
                               res=Resources(device="cpu", seed=4))
    prefix = str(tmp_path_factory.mktemp("u8") / "ckpt")
    tsh.serialize_ivf_flat(index, prefix)
    j = jsh.deserialize_ivf_flat(prefix, jcomms.init_comms(jax.devices()[:4]))
    return db, q, tc, index, prefix, j


def test_sharded_uint8_matches_jax_on_identical_state(sharded_u8):
    db, q, _, t, _, j = sharded_u8
    assert all(i.list_data.dtype == torch.uint8 for i in t.indexes)
    assert np.asarray(j.list_data).dtype == np.uint8
    want = jsh.search_ivf_flat(j, q, 5, jivf.SearchParams(n_probes=2))
    for merge in ("allgather", "ring"):
        got = tsh.search_ivf_flat(t, q, 5, tivf.SearchParams(n_probes=2),
                                  merge_mode=merge)
        _assert_same(got, want, 0.0)
    for search, index, params in ((tsh.search_ivf_flat, t, tivf.SearchParams),
                                  (jsh.search_ivf_flat, j, jivf.SearchParams)):
        with pytest.raises(ValueError, match="fp32 list data"):
            search(index, q, 5, params(n_probes=2, scan_dtype="bfloat16"))


def test_own_sharded_uint8_build_recall_and_checkpoint(sharded_u8):
    db, q, tc, index, prefix, _ = sharded_u8
    sp = tivf.SearchParams(n_probes=4)  # every list: exact
    got = tsh.search_ivf_flat(index, q, 10, sp)
    _, gt = tbf.knn(q.astype(np.float32), db.astype(np.float32), 10,
                    metric="sqeuclidean", device="cpu")
    assert float(neighborhood_recall(got[1], gt)) >= 0.99
    back = tsh.deserialize_ivf_flat(prefix, tc)
    assert all(i.list_data.dtype == torch.uint8 for i in back.indexes)
    again = tsh.search_ivf_flat(back, q, 10, sp)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
