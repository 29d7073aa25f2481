"""raft_tpu_torch's ``label``, ``solver``, the pylibraft-shaped namespaces
(``distance``, ``random``, ``spatial``, ``common``),
``core.resources_manager``, ``Resources.sync``, ``utils.debug``,
``utils.compile_cache`` and ``testing.assert_topk_close``, on the CPU,
against raft_tpu's where raft_tpu computes the same thing.

Bitwise: ``get_unique_labels``, ``make_monotonic`` (over-capacity and -1
labels too), ``merge_labels`` and the auction's assignment (n <= 32, tied
costs too). The auction's total within 1e-5 relative of raft_tpu's and
within n·eps of scipy's optimum; the shims' kNN as the functions they
forward to.
"""

import os

import numpy as np
import pytest
import torch

from raft_tpu import distance as jdistance
from raft_tpu import label as jlabel
from raft_tpu import random as jrandom
from raft_tpu import solver as jsolver
from raft_tpu import spatial as jspatial
from raft_tpu_torch import common, distance, label, random, solver, spatial
from raft_tpu_torch import native
from raft_tpu_torch.core import resources_manager as rm
from raft_tpu_torch.core.resources import Resources, default_resources
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.testing import assert_topk_close
from raft_tpu_torch.utils import compile_cache, debug
from raft_tpu_torch.utils import enable_persistent_cache

# ------------------------------------------------------------------ label

LABELS = np.array([7, 3, 7, 9, 3, -1, 12, 5, -4, 3], np.int32)


@pytest.mark.parametrize("cap", [1, 3, 5, 8, 12])
def test_unique_and_monotonic_bitwise(cap):
    ju, jn = jlabel.get_unique_labels(LABELS, cap)
    tu, tn = label.get_unique_labels(torch.from_numpy(LABELS), cap)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert tu.dtype == torch.int32 and int(tn) == int(jn)
    jm = jlabel.make_monotonic(LABELS.reshape(2, 5), cap)
    tm = label.make_monotonic(torch.from_numpy(LABELS.reshape(2, 5)), cap)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.int32


@pytest.mark.parametrize("seed,n_labels,max_iters", [
    (0, 40, 32), (1, 10, 32), (2, 80, 1), (3, 80, 2), (4, 5, 32)])
def test_merge_labels_bitwise(seed, n_labels, max_iters):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_labels, 120).astype(np.int32)
    b = rng.integers(0, n_labels, 120).astype(np.int32)
    want = jlabel.merge_labels(a, b, max_iters=max_iters)
    got = label.merge_labels(torch.from_numpy(a), torch.from_numpy(b),
                             max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_label_entry_points_raise_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        label.make_monotonic(LABELS, 4)
    assert label.make_monotonic(LABELS, 4, device="cpu").device.type == "cpu"


# ------------------------------------------------------------------ solver


def _costs(kind, n, rng):
    if kind == "uniform":
        return rng.random((n, n)).astype(np.float32)
    if kind == "integer_ties":
        return rng.integers(0, 4, (n, n)).astype(np.float32)
    if kind == "all_equal":
        return np.ones((n, n), np.float32)
    return rng.standard_normal((n, n)).astype(np.float32)


@pytest.mark.parametrize("kind,n,maximize", [
    ("uniform", 7, False), ("uniform", 32, False), ("uniform", 16, True),
    ("integer_ties", 12, False), ("integer_ties", 24, True),
    ("all_equal", 9, False), ("normal", 20, False)])
def test_auction_assignment_bitwise(kind, n, maximize):
    cost = _costs(kind, n, np.random.default_rng(n))
    ja, jt = jsolver.solve(cost, maximize=maximize)
    ta, tt = solver.solve(torch.from_numpy(cost), maximize=maximize)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.int32 and sorted(ta.tolist()) == list(range(n))
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5, atol=1e-6)
    _, opt = solver.solve_host(cost, maximize=maximize)
    _, jopt = jsolver.solve_host(cost, maximize=maximize)
    assert opt == jopt
    slack = n / (n + 1) + 1e-4
    assert (float(tt) <= opt + slack) if not maximize \
        else (float(tt) >= opt - slack)


def test_auction_rounds_and_check_interval(monkeypatch):
    cost = torch.from_numpy(_costs("uniform", 20, np.random.default_rng(0)))
    a1, un1, r1 = solver.auction(cost, 1.0 / 21, False, 50 * 20 + 1000)
    monkeypatch.setattr(solver, "CHECK_EVERY", 1)
    a2, un2, r2 = solver.auction(cost, 1.0 / 21, False, 50 * 20 + 1000)
    assert torch.equal(a1, a2) and r1 == r2 > 0 and not un1.any()
    # a cap below the rounds needed leaves rows unassigned, as raft_tpu's
    a3, un3, r3 = solver.auction(cost, 1.0 / 21, False, 3)
    assert r3 == 3 and bool(un3.any())
    with pytest.raises(ValueError, match="square"):
        solver.solve(torch.zeros(3, 4))


# ----------------------------------------------------- the namespace shims


def test_distance_and_random_shims_match_raft_tpu():
    assert set(distance.__all__) == set(jdistance.__all__)
    assert distance.DISTANCE_TYPES == jdistance.DISTANCE_TYPES
    assert set(random.__all__) == set(jrandom.__all__)
    for name in random.__all__:
        assert callable(getattr(random, name)), name
    x = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        distance.pairwise_distance(x, x, "l1", device="cpu").numpy(),
        np.asarray(jdistance.pairwise_distance(x, x, "l1")), rtol=1e-5,
        atol=1e-5)


def test_spatial_knn_search_keeps_the_legacy_order():
    rng = np.random.default_rng(1)
    db = rng.standard_normal((60, 8)).astype(np.float32)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    got = spatial.knn_search(db, q, 4, metric="sqeuclidean", device="cpu")
    want = brute_force.knn(q, db, 4, metric="sqeuclidean", device="cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jv, ji = jspatial.knn.knn(db, q, 4, metric="sqeuclidean")
    jv = np.asarray(jv)
    assert_topk_close(got, (jv, np.asarray(ji)), 1e-5 * jv.max(), 1e-5)
    assert spatial.knn.knn is spatial.knn_search
    assert spatial.knn.ivf_flat.build is not None
    pts = np.radians([[51.5, -0.13], [48.86, 2.35], [40.7, -74.0]]
                     ).astype(np.float32)
    np.testing.assert_allclose(
        spatial.haversine_distance(pts, pts, device="cpu").numpy(),
        np.asarray(jspatial.haversine_distance(pts, pts)), rtol=1e-5,
        atol=1e-7)


def test_common_shim():
    assert common.DeviceResources is Resources
    a = common.device_ndarray(np.arange(6, dtype=np.float64), device="cpu")
    assert a.dtype == torch.float32  # narrowed as jnp.asarray narrows
    b = common.device_ndarray([1, 2, 3], dtype=np.int16, device="cpu")
    assert b.dtype == torch.int16
    t = torch.arange(4.0)
    assert common.device_ndarray(t, device="cpu") is t
    np.testing.assert_array_equal(common.to_host(a), np.arange(6.0))
    calls = []

    @common.auto_sync_resources
    def fn(x, res=None):
        calls.append(res)
        return {"out": (x + 1, [x * 2])}

    res = Resources(device="cpu")
    out = fn(t, res=res)
    assert calls == [res] and torch.equal(out["out"][1][0], t * 2)
    res.sync()
    res.sync(t)  # nothing to wait for on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            common.device_ndarray([1.0])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_resources()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(t)


# ------------------------------------------------------ resources_manager


def test_resources_manager_round_robin_and_freeze():
    rm.reset()
    try:
        rm.set_resources_per_device(3)
        rm.set_workspace_limit(1 << 20)
        got = [rm.get_resources(device="cpu") for _ in range(4)]
        assert got[0] is got[3]
        assert len({id(r) for r in got[:3]}) == 3
        assert all(r.device.type == "cpu" and r.workspace_limit_bytes
                   == 1 << 20 for r in got)
        # the seeds: 1000 + device_index·101 + i, as raft_tpu's
        for i, r in enumerate(got[:3]):
            g = torch.Generator()
            g.manual_seed(1000 + i)
            assert torch.equal(torch.rand(4, generator=r.generator),
                               torch.rand(4, generator=g))
        # options are frozen after the first hand-out
        rm.set_resources_per_device(5)
        rm.set_workspace_limit(1 << 10)
        got2 = [rm.get_resources(device="cpu") for _ in range(5)]
        assert len({id(r) for r in got2}) == 3
        assert got2[0].workspace_limit_bytes == 1 << 20
    finally:
        rm.reset()


# ------------------------------------------------------------------ debug


def test_checked_passes_clean_results_and_raises_on_nan_and_inf():
    def clean(x):
        return x * 2, {"n": torch.tensor(3)}

    x = torch.arange(4.0)
    out = debug.checked(clean)(x)
    assert torch.equal(out[0], x * 2)
    with pytest.raises(FloatingPointError, match="NaN"):
        debug.checked(lambda x: (x, x / 0.0 * 0.0))(x)
    with pytest.raises(FloatingPointError, match="Inf"):
        debug.checked(lambda x: x / 0.0)(torch.ones(2))
    # Inf alone passes a NaN-only check
    assert debug.checked(lambda x: x / 0.0, checks={"nan"})(
        torch.ones(2)).isinf().all()
    # an out-of-bounds gather raises on the CPU and passes through
    with pytest.raises(IndexError):
        debug.checked(lambda x: x[torch.tensor([7])])(x)


def test_debug_mode_checks_every_op_and_is_removed_on_exit():
    x = torch.tensor([0.0, 1.0])
    with pytest.raises(FloatingPointError, match="NaN"):
        with debug.debug_mode():
            torch.log(x - 1.0)  # log(-1) → NaN
    with debug.debug_mode(nans=True, infs=False):
        y = torch.log(x)  # -inf: not checked
    assert torch.isinf(y[0])
    with pytest.raises(FloatingPointError, match="Inf"):
        with debug.debug_mode(nans=False, infs=True):
            torch.log(x)
    # removed on exit
    assert torch.isnan(torch.log(x - 1.0)).any()


# ------------------------------------------------------------ compile cache


def test_enable_persistent_cache_builds_native_there(tmp_path, monkeypatch):
    monkeypatch.setattr(gk, "BUILD_DIR", gk.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "_build_failed", False)
    got = enable_persistent_cache(str(tmp_path / "cache"), 5.0)
    assert got == str((tmp_path / "cache").resolve())
    assert enable_persistent_cache(got) == got  # idempotent
    assert gk.BUILD_DIR == tmp_path / "cache"
    assert native.BUILD_DIR == tmp_path / "cache" / "native"
    assert native.ensure_built()
    assert native.library_path().parent == tmp_path / "cache" / "native"
    assert native.library_path().exists()
    # the default: RAFT_TPU_CACHE_DIR, else build/raft_tpu_torch
    monkeypatch.setenv("RAFT_TPU_CACHE_DIR", str(tmp_path / "env"))
    assert enable_persistent_cache() == str((tmp_path / "env").resolve())
    monkeypatch.delenv("RAFT_TPU_CACHE_DIR")
    assert enable_persistent_cache() == str(compile_cache.DEFAULT_DIR)
    assert os.path.isdir(tmp_path / "env")


# ------------------------------------------------- testing.assert_topk_close


def test_assert_topk_close_accepts_a_near_tie_chain_to_the_kth_value():
    # want 10, 11.5, 13 at tol 1: one chain of near-ties reaching the k-th
    # value; the first two ids swapped, every value within tolerance
    want = (torch.tensor([[10.0, 11.5, 13.0]]), torch.tensor([[1, 2, 3]]))
    got = (torch.tensor([[10.9, 11.0, 13.0]]), torch.tensor([[2, 1, 3]]))
    out = assert_topk_close(got, want, 1.0, 0.0)
    assert out["ids_differ"] == 2
    # the boundary level may continue past k: another id at the k-th value
    got = (torch.tensor([[10.0, 11.5, 13.0]]), torch.tensor([[1, 2, 9]]))
    assert_topk_close(got, want, 1.0, 0.0)


def test_assert_topk_close_still_rejects_a_swap_away_from_ties():
    want = (torch.tensor([[1.0, 5.0, 9.0, 20.0]]),
            torch.tensor([[1, 2, 3, 4]]))
    got = (want[0].clone(), torch.tensor([[2, 1, 3, 4]]))
    with pytest.raises(AssertionError, match="away from near-ties"):
        assert_topk_close(got, want, 1e-3, 0.0)
    # inside the run that reaches rank k, an id clearly better than the
    # k-th value must be present in the other result
    want = (torch.tensor([[10.0, 11.5, 13.0]]), torch.tensor([[1, 2, 3]]))
    got = (torch.tensor([[10.0, 11.5, 13.0]]), torch.tensor([[7, 2, 3]]))
    with pytest.raises(AssertionError, match="near-tie run"):
        assert_topk_close(got, want, 1.0, 0.0)
    # two runs apart: an id may not move between them
    want = (torch.tensor([[1.0, 1.5, 8.0, 8.5, 20.0]]),
            torch.tensor([[1, 2, 3, 4, 5]]))
    got = (want[0].clone(), torch.tensor([[1, 3, 2, 4, 5]]))
    with pytest.raises(AssertionError, match="near-tie run"):
        assert_topk_close(got, want, 0.5, 0.0)


def test_assert_topk_close_rejects_an_id_at_another_ids_distance():
    # one chain of near-ties reaching rank k, every value in place and the
    # ids the same as a set, but id 4 reported at 10 where its distance is
    # 14.5, 4.5 times the tolerance
    want = (torch.tensor([[10.0, 11.5, 13.0, 14.5]]),
            torch.tensor([[1, 2, 3, 4]]))
    got = (want[0].clone(), torch.tensor([[4, 2, 3, 1]]))
    with pytest.raises(AssertionError, match="id 4 at 10.0 in got"):
        assert_topk_close(got, want, 1.0, 0.0)
