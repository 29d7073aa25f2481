"""Comms — the communicator of the sharded path.

Counterpart of ``raft_tpu.parallel.comms`` (itself modelled on
``raft::comms_t``: allreduce, bcast, reduce, allgather, gather,
reducescatter, device send/recv, comm_split). The JAX package wraps a mesh
and calls its collectives inside ``shard_map``; here a process drives its
ranks, as a JAX controller drives its addressable devices: a ``Comms``
holds a list of torch devices, one rank per entry along its axis, and
entries may repeat (four logical ranks on one card:
``init_comms(["cuda:0"] * 4)``; the CPU tests: ``init_comms(["cpu"] * 8)``).

A value sharded over the axis is a **per-rank list**: ``size`` entries,
rank r's tensor on ``devices[r]``. ``shard`` cuts a host array or tensor into
one, ``map`` runs a local function per rank, and every collective takes and
returns per-rank lists. The collectives move data with plain tensor copies,
as the JAX package leaves them to XLA; only the ring merge's ``shift=``
argument takes the hand-written ``ring_shift`` kernel
(``ops.gpu_kernels.ring_shift``). Sums run in rank order, so a reduction
gives the same bits on every run.

**Several processes** (``init_distributed`` with an address): the ranks are
ordered by process, then by each process's local devices, as
``jax.devices()`` orders them, and each process holds the entries of its
own ranks (``local_ranks``); the others are None. ``map`` runs the local
ranks only. A collective fetches the other processes' blocks through
``torch.distributed`` (a broadcast from the owner, gloo on the CPU, NCCL on
CUDA devices), then reduces and selects exactly as one process does, so
every process gets the bits one process's communicator over the same ranks
gets. A point-to-point pair across processes is a ``send``/``recv``; the
ring's hop between two ranks of one process stays the ``ring_shift``
kernel. A backend that cannot run a collective raises; nothing is rerouted.

The cross-rank top-k merges select by the explicit (value, position in the
rank-order concatenation) order of the JAX package's ``_lex_topk``, which
is a total order, so any merge schedule returns the same result. Like
``jax.lax.sort``, the key holds -0.0 and +0.0 equal (the position decides
between them) and puts NaN last.

Each communicator counts the bytes every rank receives from the others
(``received``, cleared by ``reset_received``): the ``allgather`` blocks of
the other ranks, ``ppermute``'s copies (the tree merge's rounds, ``shift``)
and the ring merge's hops. ``core.resources.solve_merge_bytes`` predicts
what each merge engine moves; ``obs.costs.merge_entries`` holds the two to
each other, as raft_tpu holds the compiled program's collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    #: the process of each mesh entry (empty: every entry is this one's)
    mesh_processes: Tuple[int, ...] = ()
    process_index: int = 0
    process_count: int = 1
    #: rank → bytes it received from the other ranks since
    #: ``reset_received`` (the module docstring)
    received: Dict[int, int] = dataclasses.field(  # guarded_by: _recv_lock
        default_factory=dict, compare=False, repr=False)
    _recv_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, compare=False, repr=False)

    def __post_init__(self):
        kinds = sorted({torch.device(d).type for d in self.mesh})
        if len(kinds) > 1:
            raise ValueError(f"a communicator's devices must all be of one "
                             f"kind, got {kinds}: the CPU ranks move blocks "
                             f"with plain copies and the CUDA ranks with the "
                             f"ring_shift kernel")
        if self.mesh_processes and len(self.mesh_processes) != len(self.mesh):
            raise ValueError("mesh_processes needs one entry a device")

    # ---- received bytes ---------------------------------------------------
    def reset_received(self) -> None:
        with self._recv_lock:
            self.received.clear()

    def _count_received(self, rank: int, t: Optional[torch.Tensor]) -> None:
        if t is None:
            return
        with self._recv_lock:
            self.received[rank] = (self.received.get(rank, 0)
                                   + t.numel() * t.element_size())

    # ---- topology ---------------------------------------------------------
    @property
    def size(self) -> int:
        return self.mesh_shape[self.axis_names.index(self.axis)]

    def _rank_entries(self) -> List[int]:
        grid = np.arange(len(self.mesh)).reshape(self.mesh_shape)
        ax = self.axis_names.index(self.axis)
        return [int(np.take(grid, r, axis=ax).flat[0])
                for r in range(self.size)]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Rank r's device (another process's device for its ranks)."""
        return tuple(self.mesh[e] for e in self._rank_entries())

    @property
    def rank_processes(self) -> Tuple[int, ...]:
        """The process that holds each rank."""
        if not self.mesh_processes:
            return (self.process_index,) * self.size
        return tuple(self.mesh_processes[e] for e in self._rank_entries())

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The ranks this process holds (every rank in one process)."""
        return tuple(r for r, p in enumerate(self.rank_processes)
                     if p == self.process_index)

    @property
    def distributed(self) -> bool:
        return self.process_count > 1

    @property
    def _home(self) -> torch.device:
        """Where a collective combines the ranks' blocks: rank 0's device in
        one process, this process's first device (the CPU under gloo)
        across several."""
        if not self.distributed:
            return self.devices[0]
        return self.devices[self.local_ranks[0]]

    def _check(self, xs) -> list:
        xs = list(xs)
        if len(xs) != self.size:
            raise ValueError(f"expected one tensor per rank ({self.size}), "
                             f"got {len(xs)}")
        return xs

    def _replicate(self, t: torch.Tensor) -> list:
        local = set(self.local_ranks)
        return [t.to(d, copy=True) if r in local else None
                for r, d in enumerate(self.devices)]

    # ---- moving blocks between processes ----------------------------------
    def _fetch(self, xs, ranks: Sequence[int]) -> dict:
        """Rank → its tensor, for each of ``ranks``, in this process: a local
        rank's own tensor, another process's broadcast from its owner (a
        byte copy, so the bits are the owner's)."""
        if not self.distributed:
            return {r: xs[r] for r in ranks}
        import torch.distributed as dist

        procs = self.rank_processes
        mine = {r: (tuple(xs[r].shape), str(xs[r].dtype).split(".")[-1])
                for r in ranks if procs[r] == self.process_index}
        metas = [None] * self.process_count
        dist.all_gather_object(metas, mine)
        home = self._home
        out = {}
        for r in ranks:
            shape, dtype = metas[procs[r]][r]
            dtype = getattr(torch, dtype)
            numel = int(np.prod(shape)) if shape else 1
            if procs[r] == self.process_index:
                t = xs[r]
                buf = t.to(home).contiguous().reshape(-1).view(torch.uint8)
            else:
                buf = torch.empty((numel * dtype.itemsize,),
                                  dtype=torch.uint8, device=home)
            if buf.numel():
                dist.broadcast(buf, src=procs[r])
            out[r] = (t if procs[r] == self.process_index
                      else buf.view(dtype).reshape(shape))
        return out

    def _all_ranks(self, xs) -> List[torch.Tensor]:
        """Every rank's tensor, in this process, in rank order."""
        got = self._fetch(xs, range(self.size))
        return [got[r] for r in range(self.size)]

    def _pairs(self, xs, pairs, out, dst_like) -> None:
        """Point-to-point copies ``out[d] = xs[s]`` for the (s, d) pairs, in
        their order: a copy where both ranks are this process's, a
        ``send``/``recv`` where they are two processes' (blocking, and in the
        same order in every process, so each pair meets its partner)."""
        procs, me, devs = self.rank_processes, self.process_index, \
            self.devices
        for s, d in pairs:
            if procs[s] == me and procs[d] == me:
                out[d] = xs[s].to(devs[d], copy=True)
                continue
            if procs[s] != me and procs[d] != me:
                continue
            import torch.distributed as dist

            if procs[s] == me:
                dist.send(xs[s].to(self._home).contiguous().reshape(-1)
                          .view(torch.uint8), dst=procs[d])
            else:
                like = dst_like(d)
                buf = torch.empty((like.numel() * like.element_size(),),
                                  dtype=torch.uint8, device=self._home)
                dist.recv(buf, src=procs[s])
                out[d] = buf.view(like.dtype).reshape(like.shape).to(devs[d])

    # ---- per-rank lists ---------------------------------------------------
    def shard(self, x, axis: Optional[int] = 0) -> list:
        """Cut ``x`` (a host array or a tensor) into ``size`` equal parts
        along ``axis``, rank r's part on ``devices[r]``; ``axis=None``
        replicates ``x`` on every rank. Parts that already lie on their
        rank's device are views of ``x``: treat them as read-only. Across
        processes every process passes the same ``x`` and keeps its own
        ranks' parts."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        local = set(self.local_ranks)
        if axis is None:
            return [t.to(d) if r in local else None
                    for r, d in enumerate(self.devices)]
        n = t.shape[axis]
        if n % self.size:
            raise ValueError(f"dimension {axis} of length {n} does not split "
                             f"into {self.size} equal parts")
        parts = torch.split(t, n // self.size, dim=axis)
        return [p.to(d) if r in local else None
                for r, (p, d) in enumerate(zip(parts, self.devices))]

    def map(self, fn: Callable, *per_rank) -> list:
        """``[fn(r, *args_r) for each rank r]``, rank r's call made with its
        device current; ``per_rank`` are per-rank lists. Across processes
        only this process's ranks run (the others' entries are None)."""
        lists = [self._check(xs) for xs in per_rank]
        out = [None] * self.size
        devs = self.devices
        for r in self.local_ranks:
            with _device_context(devs[r]):
                out[r] = fn(r, *(xs[r] for xs in lists))
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
        parts = self._all_ranks(xs)
        home = self._home
        acc = parts[0].to(home)
        for x in parts[1:]:
            acc = combine(acc, x.to(home))
        return self._replicate(acc)

    def allgather(self, xs, axis: int = 0,
                  tiled: bool = True) -> List[torch.Tensor]:
        """ncclAllGather analog: the ranks' tensors concatenated along
        ``axis`` (stacked on a new ``axis`` when not ``tiled``), on every
        rank."""
        xs = self._check(xs)
        home = self._home
        parts = [x.to(home) for x in self._all_ranks(xs)]
        for r in self.local_ranks:
            for q, part in enumerate(parts):
                if q != r:
                    self._count_received(r, part)
        whole = torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                     dim=axis)
        return self._replicate(whole)

    def reducescatter(self, xs,
                      scatter_dimension: int = 0) -> List[torch.Tensor]:
        """ncclReduceScatter analog: the rank-order sum, cut into ``size``
        parts along ``scatter_dimension``; rank r keeps part r."""
        total = self.allreduce(xs)
        n = self._first(total).shape[scatter_dimension]
        if n % self.size:
            raise ValueError(f"dimension {scatter_dimension} of length {n} "
                             f"does not split into {self.size} equal parts")
        return [None if t is None else
                torch.split(t, n // self.size, dim=scatter_dimension)[r]
                .contiguous() for r, t in enumerate(total)]

    def bcast(self, xs, root: int = 0) -> List[torch.Tensor]:
        """ncclBroadcast analog: every rank gets root's tensor."""
        xs = self._check(xs)
        return self._replicate(self._fetch(xs, [root])[root])

    def _root_only(self, full, root: int) -> List[torch.Tensor]:
        return [f if r == root or f is None else torch.zeros_like(f)
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
        parts = self._all_ranks(xs)
        cap = parts[0].shape[axis]
        if max(counts) > cap:
            raise ValueError(f"counts {counts} exceed shard capacity {cap}")
        home = self._home
        whole = torch.cat([x.to(home).narrow(axis, 0, c)
                           for x, c in zip(parts, counts)], dim=axis)
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
        out = [None if x is None else torch.zeros_like(x) for x in xs]
        self._pairs(xs, perm, out, lambda d: xs[d])
        for s, d in perm:
            if s != d and out[d] is not None:
                self._count_received(d, out[d])
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
        src = self._fetch(xs, [root])[root]
        return [None if xs[r] is None else
                (src if r in dests else xs[r]).to(devs[r], copy=True)
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
        parts = self._all_ranks(xs)
        local = set(self.local_ranks)
        return [torch.stack([x[r].to(devs[r]) for x in parts])
                if r in local else None for r in range(self.size)]

    # ---- cross-rank top-k merges -----------------------------------------
    def _positions(self, nq: int, kk: int) -> list:
        """Each candidate's position in the rank-order concatenation."""
        local = set(self.local_ranks)
        return [(r * kk + torch.arange(kk, dtype=torch.int32, device=d))
                .expand(nq, kk).contiguous() if r in local else None
                for r, d in enumerate(self.devices)]

    def _first(self, xs):
        """This process's first rank's entry of a per-rank list."""
        return xs[self.local_ranks[0]]

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
        nq, kk = self._first(vs).shape
        k_out = min(int(k), size * kk)
        cv, cp = list(vs), self._positions(nq, kk)
        ci = [None if i is None else i.to(torch.int32) for i in ids]
        width, step = kk, 1
        while step < size:
            perm = [(r, r ^ step) for r in range(size)]
            pv, pp, pi = (self.ppermute(c, perm) for c in (cv, cp, ci))
            width = min(k_out, 2 * width)
            merged = [None if cv[r] is None else
                      _lex_topk(torch.cat([cv[r], pv[r]], 1),
                                torch.cat([cp[r], pp[r]], 1),
                                torch.cat([ci[r], pi[r]], 1), width,
                                select_min) for r in range(size)]
            cv, cp, ci = ([None if m is None else m[j] for m in merged]
                          for j in range(3))
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
        first = self._first(vs)
        nq, kk = first.shape
        k_out = min(int(k), size * kk)
        # Comms.shift counts its own copies; a given shift's hops are
        # counted here
        count_hops = shift is not None
        if shift is None:
            def shift(blocks):
                return self.shift(blocks, 1)
        elif self.distributed:
            shift = self._split_hop(shift)
        if first.dtype != torch.float32:
            raise ValueError(f"ring merge packs candidates as float32 words, "
                             f"got values dtype {first.dtype}")
        pos = self._positions(nq, kk)
        ids = [None if i is None else i.to(torch.int32).contiguous()
               for i in ids]
        blocks = [None if v is None else
                  torch.stack([v, p.view(torch.float32),
                               i.view(torch.float32)])
                  for v, p, i in zip(vs, pos, ids)]
        carry = [None if v is None else
                 _lex_topk(v, p, i, min(k_out, kk), select_min)
                 for v, p, i in zip(vs, pos, ids)]
        for s in range(size - 1):
            blocks = shift(blocks)
            if count_hops:
                for r, b in enumerate(blocks):
                    self._count_received(r, b)
            width = min(k_out, (s + 2) * kk)
            carry = [None if c is None else
                     _lex_topk(torch.cat([c[0], b[0]], 1),
                               torch.cat([c[1], b[1].view(torch.int32)], 1),
                               torch.cat([c[2], b[2].view(torch.int32)], 1),
                               width, select_min)
                     for c, b in zip(carry, blocks)]
        return ([None if c is None else c[0] for c in carry],
                [None if c is None else c[2] for c in carry])

    def _split_hop(self, shift: Callable) -> Callable:
        """A +1 ring hop across processes: ``shift`` (the ``ring_shift``
        kernel) over this process's run of ranks, whose rotation's
        wrap-around block is dropped, then a ``send``/``recv`` for each hop
        from one process's last rank to the next one's first."""
        size = self.size
        local = list(self.local_ranks)
        procs = self.rank_processes

        def hop(blocks):
            out = [None] * size
            if len(local) > 1:
                rot = shift([blocks[r] for r in local])
                for j in range(1, len(local)):
                    out[local[j]] = rot[j]
            cross = [(r, (r + 1) % size) for r in range(size)
                     if procs[r] != procs[(r + 1) % size]]
            self._pairs(blocks, cross, out, lambda d: blocks[d])
            return out

        return hop

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
                     axis: str = "data", device=None,
                     local_devices: Optional[Sequence] = None) -> Comms:
    """Multi-process bootstrap (the JAX package's
    ``jax.distributed.initialize`` + the global mesh; raft-dask's NCCL
    rendezvous). This process's ranks are ``local_devices`` (repeats
    allowed), by default every visible CUDA device, or one CPU rank when
    the caller passes ``device="cpu"``.

    With no ``coordinator_address`` it returns ``init_comms`` over the local
    devices. With one (``host:port``) it joins the ``torch.distributed``
    process group at ``tcp://host:port`` as process ``process_id`` of
    ``num_processes`` (NCCL when the local ranks are CUDA devices, gloo on
    the CPU), exchanges every process's devices and returns a ``Comms``
    whose ranks are ordered by process, then by local device. Every
    process must make the same calls on it in the same order."""
    if local_devices is not None:
        local = tuple(resolve_device(d) for d in local_devices)
    elif device is not None and torch.device(device).type == "cpu":
        local = (torch.device("cpu"),)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed() takes every CUDA device and none is "
                "available; pass device='cpu' (or local_devices=['cpu'] * n) "
                "to run the ranks on the CPU")
        local = tuple(torch.device("cuda", i)
                      for i in range(torch.cuda.device_count()))
    if not local:
        raise ValueError("init_distributed needs at least one local device")
    if coordinator_address is None:
        return init_comms(local, axis=axis)
    import torch.distributed as dist

    kinds = {d.type for d in local}
    if len(kinds) > 1:
        raise ValueError(f"a process's ranks must all be of one kind, got "
                         f"{sorted(kinds)}")
    backend = "nccl" if local[0].type == "cuda" else "gloo"
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed with an address needs "
                         "num_processes and process_id")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"already up; these ranks need {backend}")
    else:
        if backend == "nccl":
            torch.cuda.set_device(local[0])
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    every = [None] * int(num_processes)
    dist.all_gather_object(every, [str(d) for d in local])
    mesh = tuple(torch.device(d) for names in every for d in names)
    procs = tuple(p for p, names in enumerate(every) for _ in names)
    return Comms(mesh, (len(mesh),), (axis,), axis, mesh_processes=procs,
                 process_index=int(process_id),
                 process_count=int(num_processes))


def inject_comms(res: Resources, comms: Comms) -> Resources:
    """Attach a communicator to a Resources (``inject_comms_on_handle``)."""
    res._comms = comms
    return res


# ------------------------------------------------------------------ self-test


def _local(comms: Comms, out: list) -> list:
    """(rank, entry) of this process's ranks."""
    return [(r, out[r]) for r in comms.local_ranks]


def test_collective_allreduce(comms: Comms) -> bool:
    """Smoke tests mirroring raft::comms::test_collective_* helpers,
    callable from any deployment (and from every process of one) to check
    the communicator."""
    xs = comms.shard(torch.ones((comms.size, 8)))
    out = comms.allreduce(comms.map(lambda r, x: x.sum(), xs))
    return all(abs(float(o) - comms.size * 8) < 1e-6
               for _, o in _local(comms, out))


def test_collective_allgather(comms: Comms) -> bool:
    xs = comms.shard(torch.arange(comms.size, dtype=torch.float32)[:, None])
    out = comms.allgather(xs)
    want = torch.arange(comms.size, dtype=torch.float32)
    return all(torch.equal(o.cpu().ravel(), want)
               for _, o in _local(comms, out))


def test_collective_reducescatter(comms: Comms) -> bool:
    xs = comms.shard(torch.ones((comms.size, comms.size)))
    out = comms.reducescatter(comms.map(lambda r, x: x[0], xs))
    return all(bool((o == comms.size).all()) for _, o in _local(comms, out))


def test_pointToPoint_simple_send_recv(comms: Comms) -> bool:
    """Ring send/recv analog of comms_test.hpp's send_recv tests."""
    xs = comms.shard(torch.arange(comms.size, dtype=torch.float32)[:, None])
    out = comms.shift(xs, 1)
    want = np.roll(np.arange(comms.size), 1)
    return all(float(o.ravel()[0]) == want[r] for r, o in _local(comms, out))
