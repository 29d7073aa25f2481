"""raft_tpu_torch.parallel.comms against raft_tpu.parallel.comms, on the CPU.

JAX runs each collective inside ``shard_map`` on the first S devices of its
8-device virtual CPU mesh; the port runs it over ``init_comms(["cpu"] * S)``
on the same per-rank numpy inputs. Moves, gathers and shifts are held
bitwise; float sums and products within 1e-6 relative (the ranks' values
are summed in another order), integer reductions exactly.

The top-k merges are held bitwise (values compared as bit patterns, so a
-0.0 against a +0.0 counts as a difference) on candidates with duplicate
values across ranks, ±inf padding, -0.0 and +0.0 tied on different ranks,
both selection directions, and k_out below and equal to S·kk: the tree and
ring merges against JAX's with ``shift=None`` (the XLA ppermute ring), the
port's allgather engine against JAX's. Where -0.0 meets +0.0, JAX's own
engines part (the lex merges hold the zeros equal, ``lax.top_k`` puts -0.0
first); the port parts the same way (ROADMAP, reference caveats).
``ring_shift_plain`` is held bitwise against ``Comms.shift(x, 1)``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import sharded as jsharded
from raft_tpu_torch.core import resources as tres
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import sharded as tsharded

SIZES = [2, 4, 8]
jres = importlib.import_module("raft_tpu.core.resources")


def _pair(size):
    return (jcomms.init_comms(jax.devices()[:size]),
            tcomms.init_comms(["cpu"] * size))


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _bits(a):
    """A view whose equality is bitwise (signed zeros and NaNs apart)."""
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        return a.view(np.dtype(f"int{8 * a.dtype.itemsize}"))
    return a


def _jax_per_rank(jc, body, xs):
    """``body`` on each rank's slice of xs [S, ...] inside shard_map; the
    per-rank outputs stacked [S, ...]."""
    ax = jc.axis
    fn = jc.run(lambda x: body(x[0])[None], P(ax), P(ax))
    return np.asarray(jax.jit(fn)(jc.shard(jnp.asarray(xs), P(ax))))


def _port_per_rank(tc, op, xs):
    return np.stack([_to_numpy(o) for o in op([_to_torch(x) for x in xs])])


def _inputs(size, dtype, shape=(6, 4), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal((size,) + shape).astype(dtype)
    return rng.integers(-5, 6, (size,) + shape).astype(dtype)


# ------------------------------------------------------------- collectives

# (name, JAX body, port op, dtype, exact): each takes comms and the rank's
# value (JAX) or the per-rank list (port)
_CASES = {
    "allreduce_sum_f32": (lambda c, x: c.allreduce(x),
                          lambda c, xs: c.allreduce(xs), np.float32, False),
    "allreduce_sum_i32": (lambda c, x: c.allreduce(x),
                          lambda c, xs: c.allreduce(xs), np.int32, True),
    "allreduce_prod_f32": (lambda c, x: c.allreduce(x, "prod"),
                           lambda c, xs: c.allreduce(xs, "prod"), np.float32,
                           False),
    "allreduce_min_f32": (lambda c, x: c.allreduce(x, "min"),
                          lambda c, xs: c.allreduce(xs, "min"), np.float32,
                          True),
    "allreduce_max_i32": (lambda c, x: c.allreduce(x, "max"),
                          lambda c, xs: c.allreduce(xs, "max"), np.int32,
                          True),
    "allgather_axis0": (lambda c, x: c.allgather(x),
                        lambda c, xs: c.allgather(xs), np.float32, True),
    "allgather_axis1": (lambda c, x: c.allgather(x, axis=1),
                        lambda c, xs: c.allgather(xs, axis=1), np.float32,
                        True),
    "allgather_stacked": (lambda c, x: c.allgather(x, tiled=False),
                          lambda c, xs: c.allgather(xs, tiled=False),
                          np.int32, True),
    "reducescatter": (lambda c, x: c.reducescatter(
                          jnp.tile(x, (c.size, 1))),
                      lambda c, xs: c.reducescatter(
                          [x.repeat(c.size, 1) for x in xs]),
                      np.float32, False),
    "bcast": (lambda c, x: c.bcast(x, root=1),
              lambda c, xs: c.bcast(xs, root=1), np.float32, True),
    "reduce_sum_i32": (lambda c, x: c.reduce(x, root=1),
                       lambda c, xs: c.reduce(xs, root=1), np.int32, True),
    "gather": (lambda c, x: c.gather(x, root=0),
               lambda c, xs: c.gather(xs, root=0), np.float32, True),
    "allgatherv": (lambda c, x: c.allgatherv(x, _counts(c.size)),
                   lambda c, xs: c.allgatherv(xs, _counts(c.size)),
                   np.float32, True),
    "gatherv": (lambda c, x: c.gatherv(x, _counts(c.size), root=1),
                lambda c, xs: c.gatherv(xs, _counts(c.size), root=1),
                np.int32, True),
    "device_send_recv": (lambda c, x: c.device_send_recv(x, _dests(c.size)),
                         lambda c, xs: c.device_send_recv(xs,
                                                          _dests(c.size)),
                         np.float32, True),
    "multicast": (lambda c, x: c.device_multicast_sendrecv(
                      x, 1, range(0, c.size, 2)),
                  lambda c, xs: c.device_multicast_sendrecv(
                      xs, 1, range(0, c.size, 2)), np.float32, True),
    "ppermute_partial": (lambda c, x: c.ppermute(x, [(0, c.size - 1),
                                                     (1, 0)]),
                         lambda c, xs: c.ppermute(xs, [(0, c.size - 1),
                                                       (1, 0)]),
                         np.float32, True),
    "shift_1": (lambda c, x: c.shift(x, 1),
                lambda c, xs: c.shift(xs, 1), np.float32, True),
    "shift_minus_3": (lambda c, x: c.shift(x, -3),
                      lambda c, xs: c.shift(xs, -3), np.int32, True),
}


def _counts(size):
    return [(3 * r + 1) % 7 for r in range(size)]


def _dests(size):
    return [(3 * r + 1) % size if size % 3 else (r + 1) % size
            for r in range(size)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", sorted(_CASES))
def test_collective_matches_jax(case, size):
    jbody, top, dtype, exact = _CASES[case]
    jc, tc = _pair(size)
    xs = _inputs(size, dtype, (6, 4) if case != "reducescatter"
                 else (1, 3))
    want = _jax_per_rank(jc, lambda x: jbody(jc, x), xs)
    got = _port_per_rank(tc, lambda ts: top(tc, ts), xs)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("size", SIZES)
def test_alltoall_matches_jax(size):
    jc, tc = _pair(size)
    xs = _inputs(size, np.float32, (size, 3, 2), seed=1)
    want = _jax_per_rank(jc, jc.alltoall, xs)
    got = _port_per_rank(tc, tc.alltoall, xs)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_allreduce_sums_in_rank_order():
    # 1e8 + 1 - 1e8 in float32 is 0 taken left to right, 1 otherwise
    tc = tcomms.init_comms(["cpu"] * 3)
    xs = [torch.tensor([v], dtype=torch.float32) for v in (1e8, 1.0, -1e8)]
    out = tc.allreduce(xs)
    assert all(float(o) == 0.0 for o in out)
    assert all(o.data_ptr() != out[0].data_ptr() for o in out[1:])


def test_collectives_reject_a_wrong_rank_count_and_bad_tables():
    tc = tcomms.init_comms(["cpu"] * 4)
    xs = [torch.zeros(2) for _ in range(4)]
    with pytest.raises(ValueError, match="one tensor per rank"):
        tc.allreduce(xs[:3])
    with pytest.raises(ValueError, match="not a permutation"):
        tc.device_send_recv(xs, [0, 0, 1, 2])
    with pytest.raises(ValueError, match="twice"):
        tc.ppermute(xs, [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="exceed shard capacity"):
        tc.allgatherv(xs, [3, 1, 1, 1])
    with pytest.raises(ValueError, match="unknown reduce op"):
        tc.allreduce(xs, "mean")
    with pytest.raises(ValueError, match="equal parts"):
        tc.shard(np.zeros((6, 2), np.float32))


def test_shard_and_map():
    tc = tcomms.init_comms(["cpu"] * 4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    parts = tc.shard(x)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    torch.testing.assert_close(torch.cat(parts), torch.from_numpy(x))
    rep = tc.shard(x, axis=None)
    assert all(torch.equal(r, torch.from_numpy(x)) for r in rep)
    out = tc.map(lambda r, p: p.sum() + r, parts)
    assert [float(o) for o in out] == [float(x[2 * r:2 * r + 2].sum() + r)
                                       for r in range(4)]


@pytest.mark.parametrize("color,size", [("rows", 2), ("cols", 4)])
def test_comm_split_on_a_2x4_mesh_matches_jax(color, size):
    jc = jcomms.init_comms(jax.devices()[:8], axis="rows", mesh_shape=(2, 4),
                           axis_names=("rows", "cols"))
    tc = tcomms.init_comms(["cpu"] * 8, axis="rows", mesh_shape=(2, 4),
                           axis_names=("rows", "cols"))
    js, ts = jc.comm_split(color), tc.comm_split(color)
    assert js.size == ts.size == size
    xs = _inputs(size, np.float32, (3, 2), seed=2)
    ax = js.axis
    fn = js.run(lambda x: js.allreduce(x[0])[None] + 0 * x, P(ax), P(ax))
    want = np.asarray(jax.jit(fn)(js.shard(jnp.asarray(xs), P(ax))))
    got = _port_per_rank(ts, ts.allreduce, xs)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="not in mesh"):
        tc.comm_split("bogus")


def test_devices_of_a_mesh_axis():
    tc = tcomms.init_comms([f"cpu:{i}" for i in range(8)], axis="cols",
                           mesh_shape=(2, 4), axis_names=("rows", "cols"))
    # rank r of "cols" is column r of row 0; of "rows", row r's first device
    assert [d.index for d in tc.devices] == [0, 1, 2, 3]
    assert [d.index for d in tc.comm_split("rows").devices] == [0, 4]
    with pytest.raises(ValueError, match="does not hold"):
        tcomms.init_comms(["cpu"] * 6, mesh_shape=(2, 4))
    with pytest.raises(ValueError, match="not in axis_names"):
        tcomms.init_comms(["cpu"] * 8, axis="x", mesh_shape=(2, 4),
                          axis_names=("a", "b"))


def test_a_communicator_holds_one_kind_of_device():
    # a CPU rank would move blocks with plain copies while a CUDA rank's
    # blocks must go through the ring_shift kernel: a mix is refused
    mixed = (torch.device("cuda", 0), torch.device("cpu"))
    with pytest.raises(ValueError, match="one kind"):
        tcomms.Comms(mixed, (2,), ("data",))
    tc = tcomms.init_comms(["cpu"] * 2)
    with pytest.raises(ValueError, match="one kind"):
        dataclasses.replace(tc, mesh=mixed)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["test_collective_allreduce",
                                  "test_collective_allgather",
                                  "test_collective_reducescatter",
                                  "test_pointToPoint_simple_send_recv"])
def test_self_tests_pass_as_in_jax(name, size):
    jc, tc = _pair(size)
    assert getattr(jcomms, name)(jc) and getattr(tcomms, name)(tc)


def test_init_distributed_is_deferred_and_inject_comms_attaches():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcomms.init_distributed()
    res = tres.Resources(device="cpu")
    with pytest.raises(RuntimeError, match="inject_comms"):
        res.comms
    tc = tcomms.init_comms(["cpu"] * 2)
    assert tcomms.inject_comms(res, tc).comms is tc


# -------------------------------------------------------------- ring_shift


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
@pytest.mark.parametrize("shape", [(3, 7, 5), (1001,), (1,)])
@pytest.mark.parametrize("size", [2, 4])
def test_ring_shift_plain_matches_jax_shift(size, shape, dtype):
    jc, _ = _pair(size)
    rng = np.random.default_rng(3)
    xs = jnp.asarray(rng.standard_normal((size,) + shape) * 50).astype(dtype)
    ax = jc.axis
    fn = jc.run(lambda x: jc.shift(x, 1), P(ax), P(ax))
    want = np.asarray(jax.jit(fn)(jc.shard(xs, P(ax))))
    blocks = [_to_torch(np.asarray(xs)[r]) for r in range(size)]
    got = gk.ring_shift_plain(blocks)
    for r in range(size):
        assert got[r].data_ptr() != blocks[(r - 1) % size].data_ptr()
        np.testing.assert_array_equal(_bits(_to_numpy(got[r])),
                                      _bits(want[r]))
    # the wrapper takes its plain version for CPU blocks
    wrapped = gk.ring_shift(blocks)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


# ------------------------------------------------------------ top-k merges


def _candidates(size, nq, kk, kind, seed):
    """Per-rank [nq, kk] (values, global ids), ids -1 where value is ±inf."""
    rng = np.random.default_rng(seed)
    if kind == "duplicates":
        v = rng.integers(0, 4, (size, nq, kk)).astype(np.float32)
    elif kind == "inf_padding":
        v = rng.standard_normal((size, nq, kk)).astype(np.float32)
        v[:, :, kk // 2:] = np.inf
        v[1:, ::2, :] = -np.inf
    elif kind == "signed_zeros":
        v = rng.integers(-1, 2, (size, nq, kk)).astype(np.float32)
        v[v == 0] = 0.0
        v[1::2][v[1::2] == 0] = -0.0
        v[:, :, 0] = np.where(np.arange(size)[:, None] % 2, -0.0, 0.0)
    else:
        v = rng.standard_normal((size, nq, kk)).astype(np.float32)
    ids = (np.arange(size)[:, None, None] * 1000
           + rng.permutation(nq * kk).reshape(1, nq, kk)).astype(np.int32)
    ids = np.where(np.isinf(v), -1, ids).astype(np.int32)
    return v, ids


def _jax_merge(jc, engine, v, ids, k, select_min):
    ax = jc.axis

    def body(vv, ii):
        if engine == "tree":
            out = jc.tree_topk_merge(vv[0], ii[0], k, select_min)
        elif engine == "ring":
            out = jc.ring_topk_merge(vv[0], ii[0], k, select_min, shift=None)
        else:
            plan = jsharded.plan_sharded_search(
                jc, "brute_force", 0, None, v.shape[1], k, v.shape[2], "xla",
                merge_mode="allgather")
            out = jsharded._plan_merge(jc, plan, vv[0], ii[0], select_min)
        return out[0][None], out[1][None]

    fn = jc.run(body, (P(ax), P(ax)), (P(ax), P(ax)))
    ov, oi = jax.jit(fn)(jc.shard(jnp.asarray(v), P(ax)),
                         jc.shard(jnp.asarray(ids), P(ax)))
    return np.asarray(ov), np.asarray(oi)


def _port_merge(tc, engine, v, ids, k, select_min):
    vs = [torch.from_numpy(v[r].copy()) for r in range(tc.size)]
    iis = [torch.from_numpy(ids[r].copy()) for r in range(tc.size)]
    if engine == "tree":
        ov, oi = tc.tree_topk_merge(vs, iis, k, select_min)
    elif engine == "ring":
        ov, oi = tc.ring_topk_merge(vs, iis, k, select_min)
    elif engine == "ring_kernel_route":
        ov, oi = tc.ring_topk_merge(vs, iis, k, select_min,
                                    shift=gk.ring_shift)
    else:
        plan = tsharded.plan_sharded_search(tc, v.shape[1], k, v.shape[2],
                                            merge_mode="allgather")
        ov, oi = tsharded._plan_merge(tc, plan, vs, iis, select_min)
    return (np.stack([o.numpy() for o in ov]),
            np.stack([o.numpy() for o in oi]))


_MERGE_ENGINES = {"tree": "tree", "ring": "ring",
                  "ring_kernel_route": "ring", "allgather": "allgather"}


@pytest.mark.parametrize("engine", sorted(_MERGE_ENGINES))
@pytest.mark.parametrize("kind", ["random", "duplicates", "inf_padding",
                                  "signed_zeros"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("size,kk,k", [(4, 5, 7), (4, 5, 20), (8, 3, 24),
                                       (2, 6, 4)])
def test_merge_matches_jax_bitwise(engine, kind, select_min, size, kk, k):
    jc, tc = _pair(size)
    v, ids = _candidates(size, 9, kk, kind, seed=size * 10 + kk)
    want = _jax_merge(jc, _MERGE_ENGINES[engine], v, ids, k, select_min)
    got = _port_merge(tc, engine, v, ids, k, select_min)
    assert got[0].shape == (size, 9, min(k, size * kk))
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    # replicated: every rank holds the same result
    assert all(np.array_equal(_bits(got[0][r]), _bits(got[0][0]))
               for r in range(size))


@pytest.mark.parametrize("kind", ["random", "duplicates", "inf_padding"])
def test_merge_engines_are_bitwise_equal(kind):
    _, tc = _pair(8)
    v, ids = _candidates(8, 11, 4, kind, seed=7)
    outs = [_port_merge(tc, e, v, ids, 10, True) for e in _MERGE_ENGINES]
    for ov, oi in outs[1:]:
        np.testing.assert_array_equal(_bits(ov), _bits(outs[0][0]))
        np.testing.assert_array_equal(oi, outs[0][1])


def test_engines_part_at_signed_zeros_as_in_jax():
    # -0.0 on odd ranks ties +0.0 on even ones: the lex merges keep the
    # lower position (+0.0 of rank 0), lax.top_k's order takes -0.0 first
    jc, tc = _pair(4)
    v = np.zeros((4, 1, 2), np.float32)
    v[1::2] = -0.0
    ids = np.arange(8, dtype=np.int32).reshape(4, 1, 2)
    for pkg, merge, c in (("jax", _jax_merge, jc), ("port", _port_merge, tc)):
        tree = merge(c, "tree", v, ids, 2, True)
        gather = merge(c, "allgather", v, ids, 2, True)
        assert tree[1][0].tolist() == [[0, 1]], pkg
        assert gather[1][0].tolist() == [[2, 3]], pkg
        assert np.signbit(gather[0][0]).all() and not np.signbit(
            tree[0][0]).any(), pkg


def test_tree_merge_needs_a_power_of_two_and_ring_float32():
    tc = tcomms.init_comms(["cpu"] * 3)
    vs = [torch.zeros((2, 3)) for _ in range(3)]
    iis = [torch.zeros((2, 3), dtype=torch.int32) for _ in range(3)]
    with pytest.raises(ValueError, match="power-of-two"):
        tc.tree_topk_merge(vs, iis, 3)
    with pytest.raises(ValueError, match="float32"):
        tc.ring_topk_merge([v.double() for v in vs], iis, 3)


@pytest.mark.parametrize("size,nq,kk,k_out", [(8, 100, 10, 10),
                                              (6, 7, 4, 20), (1, 5, 3, 3),
                                              (4, 10000, 10, 10)])
def test_solve_merge_bytes_matches_jax(size, nq, kk, k_out):
    assert tres.solve_merge_bytes(size, nq, kk, k_out) == \
        jres.solve_merge_bytes(size, nq, kk, k_out)
