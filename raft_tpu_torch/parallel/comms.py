"""Comms — the communicator of the sharded path.

Counterpart of ``raft_tpu.parallel.comms`` (itself modelled on
``raft::comms_t``: allreduce, bcast, reduce, allgather, gather,
reducescatter, device send/recv, comm_split). The JAX package wraps a mesh
and calls its collectives inside ``shard_map``; here one process drives
every rank, as a single JAX controller drives its mesh: a ``Comms`` holds a
list of torch devices, one rank per entry along its axis, and entries may
repeat (four logical ranks on one card: ``init_comms(["cuda:0"] * 4)``; the
CPU tests: ``init_comms(["cpu"] * 8)``).

A value sharded over the axis is a **per-rank list**: ``size`` tensors,
rank r's on ``devices[r]``. ``shard`` cuts a host array or tensor into one,
``map`` runs a local function per rank, and every collective takes and
returns per-rank lists. The collectives move data with plain tensor copies,
as the JAX package leaves them to XLA; only the ring merge's ``shift=``
argument takes the hand-written ``ring_shift`` kernel
(``ops.gpu_kernels.ring_shift``). Sums run in rank order, so a reduction
gives the same bits on every run.

The cross-rank top-k merges select by the explicit (value, position in the
rank-order concatenation) order of the JAX package's ``_lex_topk``, which
is a total order, so any merge schedule returns the same result. Like
``jax.lax.sort``, the key holds -0.0 and +0.0 equal (the position decides
between them) and puts NaN last.

Not ported (raises ``NotImplementedError``): ``init_distributed``, the
multi-host bootstrap (ROADMAP Queue A item 13).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, resolve_device


class ReduceOp:
    """reference: core/comms.hpp op_t (SUM/PROD/MIN/MAX)."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


def _lex_keys(v: torch.Tensor, pos: torch.Tensor,
              select_min: bool) -> torch.Tensor:
    """int64 keys in ``jax.lax.sort``'s ascending (value, pos) order: the
    value's IEEE order in the high 32 bits (negated for the largest first;
    ±0.0 as one value, NaN after +inf), the position in the low ones."""
    key = v.to(torch.float32)
    key = -key if not select_min else key
    key = torch.where(key == 0, 0.0, key)
    key = torch.where(torch.isnan(key), torch.nan, key)
    bits = key.contiguous().view(torch.int32)
    order = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (order.to(torch.int64) << 32) | pos.to(torch.int64)


def _lex_topk(v, pos, i, k: int, select_min: bool):
    """The ``k`` lexicographically smallest (value, pos) candidates per row,
    sorted: ``(values, positions, ids)``, the values as given (a -0.0 stays
    -0.0). ``pos`` is each candidate's position in the rank-order
    concatenation, unique, so the order is total."""
    key = _lex_keys(v, pos, select_min)
    sel = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
    return (torch.gather(v, 1, sel), torch.gather(pos, 1, sel),
            torch.gather(i, 1, sel))


def _device_context(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


@dataclasses.dataclass(frozen=True)
class Comms:
    """A communicator: a mesh of devices and the axis it communicates over.

    ``mesh`` lists the mesh's devices in row-major order over
    ``mesh_shape``. Rank r of the axis is the slice at coordinate r along
    it; its device (``devices[r]``) is the slice's first, as the JAX
    package's sharded builds place shard r there."""

    mesh: Tuple[torch.device, ...]
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    axis: str = "data"

    def __post_init__(self):
        kinds = sorted({torch.device(d).type for d in self.mesh})
        if len(kinds) > 1:
            raise ValueError(f"a communicator's devices must all be of one "
                             f"kind, got {kinds}: the CPU ranks move blocks "
                             f"with plain copies and the CUDA ranks with the "
                             f"ring_shift kernel")

    # ---- topology ---------------------------------------------------------
    @property
    def size(self) -> int:
        return self.mesh_shape[self.axis_names.index(self.axis)]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        grid = np.arange(len(self.mesh)).reshape(self.mesh_shape)
        ax = self.axis_names.index(self.axis)
        return tuple(self.mesh[int(np.take(grid, r, axis=ax).flat[0])]
                     for r in range(self.size))

    def _check(self, xs) -> List[torch.Tensor]:
        xs = list(xs)
        if len(xs) != self.size:
            raise ValueError(f"expected one tensor per rank ({self.size}), "
                             f"got {len(xs)}")
        return xs

    def _replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        return [t.to(d, copy=True) for d in self.devices]

    # ---- per-rank lists ---------------------------------------------------
    def shard(self, x, axis: Optional[int] = 0) -> List[torch.Tensor]:
        """Cut ``x`` (a host array or a tensor) into ``size`` equal parts
        along ``axis``, rank r's part on ``devices[r]``; ``axis=None``
        replicates ``x`` on every rank. Parts that already lie on their
        rank's device are views of ``x``: treat them as read-only."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if axis is None:
            return [t.to(d) for d in self.devices]
        n = t.shape[axis]
        if n % self.size:
            raise ValueError(f"dimension {axis} of length {n} does not split "
                             f"into {self.size} equal parts")
        parts = torch.split(t, n // self.size, dim=axis)
        return [p.to(d) for p, d in zip(parts, self.devices)]

    def map(self, fn: Callable, *per_rank) -> list:
        """``[fn(r, *args_r) for each rank r]``, rank r's call made with its
        device current; ``per_rank`` are per-rank lists."""
        lists = [self._check(xs) for xs in per_rank]
        out = []
        for r, dev in enumerate(self.devices):
            with _device_context(dev):
                out.append(fn(r, *(xs[r] for xs in lists)))
        return out

    # ---- collectives ------------------------------------------------------
    def allreduce(self, xs, op: str = ReduceOp.SUM) -> List[torch.Tensor]:
        """ncclAllReduce analog: the reduction over ranks, taken in rank
        order on rank 0's device, then copied to every rank."""
        xs = self._check(xs)
        combine = {ReduceOp.SUM: torch.add, ReduceOp.PROD: torch.mul,
                   ReduceOp.MIN: torch.minimum,
                   ReduceOp.MAX: torch.maximum}.get(op)
        if combine is None:
            raise ValueError(f"unknown reduce op {op!r}")
        d0 = self.devices[0]
        acc = xs[0].to(d0)
        for x in xs[1:]:
            acc = combine(acc, x.to(d0))
        return self._replicate(acc)

    def allgather(self, xs, axis: int = 0,
                  tiled: bool = True) -> List[torch.Tensor]:
        """ncclAllGather analog: the ranks' tensors concatenated along
        ``axis`` (stacked on a new ``axis`` when not ``tiled``), on every
        rank."""
        xs = self._check(xs)
        d0 = self.devices[0]
        parts = [x.to(d0) for x in xs]
        whole = torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                     dim=axis)
        return self._replicate(whole)

    def reducescatter(self, xs,
                      scatter_dimension: int = 0) -> List[torch.Tensor]:
        """ncclReduceScatter analog: the rank-order sum, cut into ``size``
        parts along ``scatter_dimension``; rank r keeps part r."""
        total = self.allreduce(xs)
        n = total[0].shape[scatter_dimension]
        if n % self.size:
            raise ValueError(f"dimension {scatter_dimension} of length {n} "
                             f"does not split into {self.size} equal parts")
        return [torch.split(t, n // self.size, dim=scatter_dimension)[r]
                .contiguous() for r, t in enumerate(total)]

    def bcast(self, xs, root: int = 0) -> List[torch.Tensor]:
        """ncclBroadcast analog: every rank gets root's tensor."""
        xs = self._check(xs)
        return self._replicate(xs[root])

    def _root_only(self, full, root: int) -> List[torch.Tensor]:
        return [f if r == root else torch.zeros_like(f)
                for r, f in enumerate(full)]

    def reduce(self, xs, root: int = 0,
               op: str = ReduceOp.SUM) -> List[torch.Tensor]:
        """ncclReduce analog: the reduction on root, zeros elsewhere."""
        return self._root_only(self.allreduce(xs, op), root)

    def gather(self, xs, root: int = 0) -> List[torch.Tensor]:
        """ncclGather analog: the ranks' tensors stacked [size, ...] on
        root, zeros elsewhere."""
        return self._root_only(self.allgather(xs, tiled=False), root)

    def allgatherv(self, xs, counts: Sequence[int],
                   axis: int = 0) -> List[torch.Tensor]:
        """allgatherv analog: the first ``counts[r]`` entries along ``axis``
        of each rank, concatenated in rank order, on every rank."""
        xs = self._check(xs)
        counts = [int(c) for c in counts]
        cap = xs[0].shape[axis]
        if max(counts) > cap:
            raise ValueError(f"counts {counts} exceed shard capacity {cap}")
        d0 = self.devices[0]
        whole = torch.cat([x.to(d0).narrow(axis, 0, c)
                           for x, c in zip(xs, counts)], dim=axis)
        return self._replicate(whole)

    def gatherv(self, xs, counts: Sequence[int], root: int = 0,
                axis: int = 0) -> List[torch.Tensor]:
        """gatherv analog: ``allgatherv`` on root, zeros elsewhere."""
        return self._root_only(self.allgatherv(xs, counts, axis), root)

    def ppermute(self, xs, perm: Sequence[Tuple[int, int]]
                 ) -> List[torch.Tensor]:
        """Point-to-point pairs (src, dst): rank dst receives a copy of rank
        src's tensor; a rank that receives nothing gets zeros (XLA's
        ``ppermute``)."""
        xs = self._check(xs)
        perm = [(int(s), int(d)) for s, d in perm]
        srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"perm {perm} sends or receives twice")
        devs = self.devices
        out = [torch.zeros_like(x) for x in xs]
        for s, d in perm:
            out[d] = xs[s].to(devs[d], copy=True)
        return out

    def device_send_recv(self, xs,
                         dest_of_rank: Sequence[int]) -> List[torch.Tensor]:
        """device_sendrecv analog: rank r's tensor goes to
        ``dest_of_rank[r]``; the table must be a permutation."""
        dests = [int(d) for d in dest_of_rank]
        if sorted(dests) != list(range(self.size)):
            raise ValueError(f"dest table {dests} is not a permutation")
        return self.ppermute(xs, list(enumerate(dests)))

    def device_multicast_sendrecv(self, xs, root: int,
                                  dests: Sequence[int]) -> List[torch.Tensor]:
        """device_multicast_sendrecv analog: the ranks in ``dests`` get
        root's tensor, the others keep their own."""
        xs = self._check(xs)
        dests = {int(d) for d in dests}
        devs = self.devices
        return [(xs[root] if r in dests else xs[r]).to(devs[r], copy=True)
                for r in range(self.size)]

    def shift(self, xs, offset: int = 1) -> List[torch.Tensor]:
        """Ring shift by ``offset``: rank (r + offset) mod size receives
        rank r's tensor."""
        n = self.size
        return self.ppermute(xs, [(i, (i + offset) % n) for i in range(n)])

    def alltoall(self, xs) -> List[torch.Tensor]:
        """ncclAllToAll analog: each rank holds [size, ...]; rank r receives
        entry r of every rank, stacked in rank order."""
        xs = self._check(xs)
        devs = self.devices
        return [torch.stack([x[r].to(devs[r]) for x in xs])
                for r in range(self.size)]

    # ---- cross-rank top-k merges -----------------------------------------
    def _positions(self, nq: int, kk: int) -> List[torch.Tensor]:
        """Each candidate's position in the rank-order concatenation."""
        return [(r * kk + torch.arange(kk, dtype=torch.int32, device=d))
                .expand(nq, kk).contiguous()
                for r, d in enumerate(self.devices)]

    def tree_topk_merge(self, vs, ids, k: int, select_min: bool = True
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Hypercube top-k merge in log₂(size) ``ppermute`` rounds.

        ``vs``/``ids`` are per-rank [nq, kk] candidates (ids global; invalid
        candidates already carry ±inf). Each round a rank exchanges its
        carry with rank ``r XOR step`` and keeps the ``min(k, seen)``
        lexicographically smallest. Needs a power-of-two size. Returns
        per-rank (values, ids) of width ``min(k, size·kk)``, the same on
        every rank."""
        size = self.size
        if size & (size - 1):
            raise ValueError(f"tree merge needs a power-of-two mesh axis, "
                             f"got size={size}")
        vs, ids = self._check(vs), self._check(ids)
        nq, kk = vs[0].shape
        k_out = min(int(k), size * kk)
        cv, cp = list(vs), self._positions(nq, kk)
        ci = [i.to(torch.int32) for i in ids]
        width, step = kk, 1
        while step < size:
            perm = [(r, r ^ step) for r in range(size)]
            pv, pp, pi = (self.ppermute(c, perm) for c in (cv, cp, ci))
            width = min(k_out, 2 * width)
            merged = [_lex_topk(torch.cat([cv[r], pv[r]], 1),
                                torch.cat([cp[r], pp[r]], 1),
                                torch.cat([ci[r], pi[r]], 1), width,
                                select_min) for r in range(size)]
            cv, cp, ci = (list(t) for t in zip(*merged))
            step *= 2
        if size == 1:  # no round ran: still sort and truncate
            cv[0], cp[0], ci[0] = _lex_topk(cv[0], cp[0], ci[0], k_out,
                                            select_min)
        return cv, ci

    def ring_topk_merge(self, vs, ids, k: int, select_min: bool = True,
                        shift: Optional[Callable] = None
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Neighbour-ring top-k merge: size-1 steps, each rotating every
        rank's original [nq, kk] candidates one hop while folding the block
        received last step into the carry. ``shift`` maps the per-rank
        packed [3, nq, kk] float32 blocks (values, positions and ids as
        float32 bits) to their +1 ring rotation: ``Comms.shift`` by default,
        ``ops.gpu_kernels.ring_shift`` for the kernel. Works for any size.
        Returns per-rank (values, ids) of width ``min(k, size·kk)``."""
        vs, ids = self._check(vs), self._check(ids)
        size = self.size
        nq, kk = vs[0].shape
        k_out = min(int(k), size * kk)
        if shift is None:
            def shift(blocks):
                return self.shift(blocks, 1)
        if vs[0].dtype != torch.float32:
            raise ValueError(f"ring merge packs candidates as float32 words, "
                             f"got values dtype {vs[0].dtype}")
        pos = self._positions(nq, kk)
        ids = [i.to(torch.int32).contiguous() for i in ids]
        blocks = [torch.stack([v, p.view(torch.float32),
                               i.view(torch.float32)])
                  for v, p, i in zip(vs, pos, ids)]
        carry = [_lex_topk(v, p, i, min(k_out, kk), select_min)
                 for v, p, i in zip(vs, pos, ids)]
        for s in range(size - 1):
            blocks = shift(blocks)
            width = min(k_out, (s + 2) * kk)
            carry = [_lex_topk(torch.cat([cv, b[0]], 1),
                               torch.cat([cp, b[1].view(torch.int32)], 1),
                               torch.cat([ci, b[2].view(torch.int32)], 1),
                               width, select_min)
                     for (cv, cp, ci), b in zip(carry, blocks)]
        return [c[0] for c in carry], [c[2] for c in carry]

    # ---- split ----------------------------------------------------------
    def comm_split(self, color_axis: str) -> "Comms":
        """comms_t::comm_split analog: a communicator over another axis of
        the same mesh."""
        if color_axis not in self.axis_names:
            raise ValueError(f"axis {color_axis!r} not in mesh "
                             f"{self.axis_names}")
        return dataclasses.replace(self, axis=color_axis)


# ------------------------------------------------------------------ bootstrap


def init_comms(devices: Optional[Sequence] = None, axis: str = "data",
               mesh_shape: Optional[Sequence[int]] = None,
               axis_names: Optional[Sequence[str]] = None) -> Comms:
    """A communicator over ``devices`` (torch devices or their names,
    repeats allowed), one rank per entry; with no devices, one rank per
    CUDA device, and an error without one. ``mesh_shape``/``axis_names``
    lay the devices out as a multi-axis mesh (axis 0 is the comms axis
    unless ``axis`` names another)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_comms() takes every CUDA device and none is available; "
                "pass devices=['cpu'] * size to run the ranks on the CPU "
                "(each rank's device='cpu')")
        devs = tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    else:
        devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("init_comms needs at least one device")
    if mesh_shape is None:
        return Comms(devs, (len(devs),), (axis,), axis)
    shape = tuple(int(s) for s in mesh_shape)
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh_shape {shape} does not hold {len(devs)} "
                         "devices")
    names = tuple(axis_names) if axis_names else tuple(
        f"ax{i}" if i else axis for i in range(len(shape)))
    if axis not in names:
        raise ValueError(f"comms axis {axis!r} not in axis_names {names}")
    return Comms(devs, shape, names, axis)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     axis: str = "data") -> Comms:
    """Multi-host bootstrap: not ported (ROADMAP Queue A item 13: NCCL over
    several processes)."""
    raise NotImplementedError(
        "init_distributed (multi-process NCCL) is not ported yet (ROADMAP "
        "Queue A item 13); init_comms drives every rank from one process")


def inject_comms(res: Resources, comms: Comms) -> Resources:
    """Attach a communicator to a Resources (``inject_comms_on_handle``)."""
    res._comms = comms
    return res


# ------------------------------------------------------------------ self-test


def test_collective_allreduce(comms: Comms) -> bool:
    """Smoke tests mirroring raft::comms::test_collective_* helpers,
    callable from any deployment to check the communicator."""
    xs = comms.shard(torch.ones((comms.size, 8)))
    out = comms.allreduce([x.sum() for x in xs])
    return all(abs(float(o) - comms.size * 8) < 1e-6 for o in out)


def test_collective_allgather(comms: Comms) -> bool:
    xs = comms.shard(torch.arange(comms.size, dtype=torch.float32)[:, None])
    out = comms.allgather(xs)
    want = torch.arange(comms.size, dtype=torch.float32)
    return all(torch.equal(o.cpu().ravel(), want) for o in out)


def test_collective_reducescatter(comms: Comms) -> bool:
    xs = comms.shard(torch.ones((comms.size, comms.size)))
    out = comms.reducescatter([x[0] for x in xs])
    return all(bool((o == comms.size).all()) for o in out)


def test_pointToPoint_simple_send_recv(comms: Comms) -> bool:
    """Ring send/recv analog of comms_test.hpp's send_recv tests."""
    xs = comms.shard(torch.arange(comms.size, dtype=torch.float32)[:, None])
    out = comms.shift(xs, 1)
    want = np.roll(np.arange(comms.size), 1)
    return all(float(o.ravel()[0]) == want[r] for r, o in enumerate(out))
