"""Tiered IVF-PQ: the lists in pinned host memory behind a device slab arena.

Counterpart of ``raft_tpu.neighbors.tiered``. The packed codes, ids and
decoded-residual norms of every list live in host memory
(:class:`HostTier`, pinned when the index is on the card); the coarse
centres, rotation, codebooks and the decoded overflow block stay on the
device. A batch's probed lists resolve through a fixed-size arena of decoded
slabs (:class:`SlabArena`), an LRU keyed by ``(namespace, cluster)``, so one
arena serves several indexes.

A fetch gathers a group of lists' host rows into pinned staging memory,
copies them to the card on the arena's copy stream without blocking, decodes
the codes there with ``ivf_pq._decode_lists`` (with the group's own
codebooks when they are per cluster), writes the arena slots and records an
event; the scan's stream waits on the events of the slots it reads. The hot
path takes no device-wide synchronisation. The arena is written in place,
so a slot a scan resolved is pinned until the scan's completion event has
fired: a later batch's fetch evicts only unpinned slots, and every scan sees
the slabs it resolved.

The scan takes the route of the resident cache engine over the arena slabs,
with the slot of each probe for the slabs and its cluster for the centres:
for L2 ``gk.fused_ivf_topk`` (``ivf_pq._search_fused_cache_core``), for inner
product (or k > 1024) ``gk.ivf_scan`` and ``select_k``
(``ivf_pq._search_cache_core``). The arena's norms are the cache's
``decoded_norms`` bit for bit (the host tier computes them by the cache's
own decode tiles), so a tiered search is bitwise the resident search of the
same batch: ``ivf_pq.search(index, queries, k, params, memory_mode="cache")``
with ``scan_mode="auto"``.

A :class:`TierPrefetcher` thread peeks the serving batcher's next batch
(``Batcher.peek()``) and stages its probed lists, so the copies overlap the
previous batch's device time. ``save_tiered``/``load_tiered`` write and read
the JAX package's manifest and host files.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.core.resources import (Resources, ensure_resources,
                                           resolve_device, solve_host_tier)
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.neighbors.brute_force import (fused_ineligible_reason,
                                                  kernel_plan)
from raft_tpu_torch.neighbors.ivf_pq import CodebookGen, SearchParams
from raft_tpu_torch.obs import explain as obs_explain
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.obs import spans as obs_spans
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops.distance import DistanceType, dot_fp32
from raft_tpu_torch.utils.shape import (as_query_array, balanced_tile,
                                        query_bucket)

__all__ = [
    "HostTier",
    "SlabArena",
    "TierPrefetcher",
    "TierReadError",
    "TierStats",
    "TieredArenaError",
    "TieredIvfPq",
    "attach_prefetcher",
    "host_tier_from_index",
    "load_manifest",
    "load_tiered",
    "save_tiered",
    "validate_manifest",
    "MANIFEST_PREFIX",
    "MANIFEST_SCHEMA",
]

logger = logging.getLogger("raft_tpu_torch.neighbors.tiered")

MANIFEST_PREFIX = "TIERED_MANIFEST_"
MANIFEST_SCHEMA = "raft_tpu.tiered_manifest/v1"

_arena_seq = itertools.count()


class TierReadError(RuntimeError):
    """A host-tier list read failed: raised before the arena map changes
    and chained (``__cause__``) to the underlying error; the serving engine
    relays it as a ``BatchFailed``, never a hang."""


class TieredArenaError(RuntimeError):
    """One batch probes more distinct lists than the arena has slots: a
    sizing error (``solve_host_tier`` reports the worst batch)."""


# ------------------------------------------------------------- host tier


def _host_tensor(a, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    t = a.detach().cpu() if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    t = t.to(dtype).contiguous()
    return t.pin_memory() if pin else t


class HostTier:
    """Host residence of one index's packed lists: codes [L, pad, bytes]
    uint8, ids [L, pad] int32, sizes [L] int32, and the decoded-residual
    norms [L, pad] f32 the resident cache would hold in ``decoded_norms``
    (:func:`host_tier_from_index`). ``pin`` keeps them in pinned memory,
    which a copy to the card needs in order not to block."""

    def __init__(self, codes, ids, sizes, norms, pin: bool = False) -> None:
        codes = _host_tensor(codes, torch.uint8, pin)
        ids = _host_tensor(ids, torch.int32, pin)
        sizes = _host_tensor(sizes, torch.int32, pin)
        norms = _host_tensor(norms, torch.float32, pin)
        if codes.dim() != 3 or tuple(ids.shape) != tuple(codes.shape[:2]):
            raise ValueError(f"codes {tuple(codes.shape)} / ids "
                             f"{tuple(ids.shape)} disagree")
        if (tuple(norms.shape) != tuple(ids.shape)
                or tuple(sizes.shape) != (codes.shape[0],)):
            raise ValueError(f"norms {tuple(norms.shape)} / sizes "
                             f"{tuple(sizes.shape)} disagree with lists "
                             f"{tuple(ids.shape)}")
        self.pinned = bool(pin)
        self.codes, self.ids, self.sizes, self.norms = codes, ids, sizes, norms

    @property
    def n_lists(self) -> int:
        return self.codes.shape[0]

    @property
    def list_pad(self) -> int:
        return self.codes.shape[1]

    @property
    def n_code_bytes(self) -> int:
        return self.codes.shape[2]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.ids, self.sizes, self.norms))

    def read_lists(self, clusters) -> Tuple[torch.Tensor, ...]:
        """The named lists' host rows (codes, ids, sizes, norms), gathered
        into pinned memory when the tier is pinned. Any failure is a
        chained :class:`TierReadError`."""
        try:
            cl = torch.as_tensor(np.asarray(clusters, np.int64))
            if cl.numel() and (int(cl.min()) < 0
                               or int(cl.max()) >= self.n_lists):
                raise IndexError(f"cluster ids {int(cl.min())}.."
                                 f"{int(cl.max())} outside "
                                 f"[0, {self.n_lists})")
            out = []
            for t in (self.codes, self.ids, self.sizes, self.norms):
                buf = torch.empty((cl.numel(), *t.shape[1:]), dtype=t.dtype,
                                  pin_memory=self.pinned)
                torch.index_select(t, 0, cl, out=buf)
                out.append(buf)
            return tuple(out)
        except Exception as e:
            raise TierReadError(
                f"host tier read failed for {np.size(clusters)} "
                f"list(s)") from e


def _host_norms(index: "ivf_pq.Index", cache_dtype=torch.bfloat16
                ) -> np.ndarray:
    """Decoded-residual norms of every list, decoded in exactly
    ``ensure_scan_cache``'s list tiles (each tile's shape the cache's own,
    so its sums run in the same order): bit for bit
    ``index.decoded_norms``."""
    per_cluster = index.params.codebook_kind == CodebookGen.PER_CLUSTER
    n_lists = index.n_lists
    list_pad = index.list_codes.shape[1]
    list_tile = balanced_tile(n_lists, min(n_lists, 128), 8)
    dtype = ivf_pq._dtype(cache_dtype, ivf_pq._FLOAT_DTYPES,
                          "scan_cache_dtype")
    out = np.empty((n_lists, list_pad), np.float32)
    for a in range(0, n_lists, list_tile):
        b = min(a + list_tile, n_lists)
        cb = index.codebooks[a:b] if per_cluster else index.codebooks
        _, nrm = ivf_pq._decode_lists(cb, index.list_codes[a:b],
                                      index.pq_dim, index.pq_bits,
                                      per_cluster, list_tile, dtype)
        out[a:b] = nrm.cpu().numpy()
    return out


def host_tier_from_index(index: "ivf_pq.Index",
                         cache_dtype=torch.bfloat16) -> HostTier:
    """Demote an index's lists to a :class:`HostTier` (pinned when the index
    is on the card)."""
    if index.list_codes is None or index.lists_decoded_only:
        raise ValueError("index has no packed lists to demote")
    return HostTier(index.list_codes, index.list_indices, index.list_sizes,
                    _host_norms(index, cache_dtype),
                    pin=index.device.type == "cuda")


# ------------------------------------------------------------ telemetry

#: ``raft_tpu_tier_prefetch_total``'s ``event`` label: fetch (lists pulled
#: by the prefetch path), already_resident (peeked lists already in the
#: arena), useful (a demand hit on a slab the prefetcher staged), error (a
#: prefetch pass failed; serving goes on)
_PREFETCH_EVENTS = ("fetch", "already_resident", "useful", "error")

_STALL_PATHS = ("demand", "prefetch")


class TierStats:
    """Registry-backed telemetry of one arena (the children of each label
    made up front, so that a scrape shows the vocabulary at 0)."""

    def __init__(self, registry: Optional[obs_metrics.Registry] = None,
                 arena_label: str = "arena") -> None:
        r = registry if registry is not None else obs_metrics.REGISTRY
        self.registry = r
        self.arena_label = arena_label
        a = arena_label
        self._hits = r.counter(
            "raft_tpu_tier_cache_hits_total",
            "Demand-path probed lists found resident in the arena.",
            ("arena",)).labels(a)
        self._misses = r.counter(
            "raft_tpu_tier_cache_misses_total",
            "Demand-path probed lists fetched from the host tier.",
            ("arena",)).labels(a)
        self._evictions = r.counter(
            "raft_tpu_tier_cache_evictions_total",
            "LRU slab evictions (any path).", ("arena",)).labels(a)
        pf = r.counter(
            "raft_tpu_tier_prefetch_total",
            "Prefetcher accounting by event.", ("arena", "event"))
        self._pf = {ev: pf.labels(a, ev) for ev in _PREFETCH_EVENTS}
        stall = r.histogram(
            "raft_tpu_tier_fetch_stall_seconds",
            "Wall time a resolve blocked on host->device slab fetches.",
            ("arena", "path"),
            buckets=obs_metrics.exponential_buckets(1e-5, 2.0, 20))
        self._stall = {p: stall.labels(a, p) for p in _STALL_PATHS}
        self._occ = r.gauge(
            "raft_tpu_tier_arena_occupancy",
            "Occupied arena slot fraction.", ("arena",)).labels(a)
        self._occ.set(0.0)

    def record_resolve(self, path: str, hits: int, misses: int,
                       evictions: int, useful: int,
                       occupancy_frac: float) -> None:
        if path == "demand":
            if hits:
                self._hits.inc(hits)
            if misses:
                self._misses.inc(misses)
            if useful:
                self._pf["useful"].inc(useful)
        else:
            if hits:
                self._pf["already_resident"].inc(hits)
            if misses:
                self._pf["fetch"].inc(misses)
        if evictions:
            self._evictions.inc(evictions)
        self._occ.set(occupancy_frac)

    def record_stall(self, path: str, seconds: float) -> None:
        self._stall[path].observe(seconds)

    def prefetch_event(self, event: str, n: int = 1) -> None:
        self._pf[event].inc(n)


# ------------------------------------------------------------ slab arena


class SlabArena:
    """Fixed-size device LRU of decoded list slabs, keyed by ``(namespace,
    cluster)``: a tenant with no traffic holds no slot, a hot one keeps its
    probed lists.

    Four device tensors (decoded residuals, norms, ids — -1 past a list's
    size — and sizes) are written in place by fetches on the arena's copy
    stream. The map, the counters and the pins live under one lock, and
    nothing blocks under it. A demand resolve pins its slots until
    :meth:`release` is handed the scan's stream and the event recorded there
    has fired; an eviction takes the coldest unpinned slot."""

    def __init__(self, slots: int, list_pad: int, rot_dim: int,
                 cache_dtype=torch.bfloat16, fetch_tile: int = 8,
                 registry: Optional[obs_metrics.Registry] = None,
                 label: Optional[str] = None, span_sink=None,
                 clock=time.perf_counter, device=None) -> None:
        if slots < 1:
            raise ValueError(f"arena needs >= 1 slot, got {slots}")
        self.slots = int(slots)
        self.list_pad = int(list_pad)
        self.rot_dim = int(rot_dim)
        self.cache_dtype = ivf_pq._dtype(cache_dtype, ivf_pq._FLOAT_DTYPES,
                                         "cache_dtype")
        self.fetch_tile = max(1, min(int(fetch_tile), self.slots))
        self.label = label or f"arena{next(_arena_seq)}"
        self.span_sink = span_sink
        self.clock = clock
        self.device = resolve_device(device)
        self.stats = TierStats(registry, self.label)
        dev = self.device
        d3, d2 = (slots, list_pad, rot_dim), (slots, list_pad)
        # the slots' contents, written by _fetch_locked under _lock
        self._dec = torch.zeros(  # guarded_by: _lock
            d3, dtype=self.cache_dtype, device=dev)
        self._norms = torch.zeros(  # guarded_by: _lock
            d2, dtype=torch.float32, device=dev)
        self._ids = torch.full(  # guarded_by: _lock
            d2, -1, dtype=torch.int32, device=dev)
        self._sizes = torch.zeros(  # guarded_by: _lock
            (slots,), dtype=torch.int32, device=dev)
        self._lock = threading.Lock()
        #: wakes a resolve waiting for scans to release their slots
        self._cond = threading.Condition(self._lock)
        # (namespace, cluster) -> slot, in LRU order (front = coldest)
        self._map: "OrderedDict" = OrderedDict()  # guarded_by: _lock
        self._prefetched = [False] * slots  # guarded_by: _lock
        self._free = list(range(slots - 1, -1, -1))  # guarded_by: _lock
        self._pins = [0] * slots  # guarded_by: _lock
        #: the event of the fetch that last wrote each slot (card only)
        self._ready: List[Optional[torch.cuda.Event]] = \
            [None] * slots  # guarded_by: _lock
        #: (completion event, slots) of scans not yet seen done
        self._inflight: "collections.deque" = \
            collections.deque()  # guarded_by: _lock
        self.counts = {  # guarded_by: _lock
            "hits": 0, "misses": 0, "evictions": 0, "inserts": 0,
            "resolved": 0, "prefetch_fetches": 0, "prefetch_hits": 0,
            "useful_prefetch": 0,
        }
        self._stream = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            # fetches write the zero-filled tensors after their fill
            self._stream.wait_stream(torch.cuda.current_stream(dev))

    @property
    def nbytes(self) -> int:
        """Device bytes of the four tensors (``solve_host_tier``'s
        ``arena_bytes``)."""
        return sum(t.numel() * t.element_size()
                   for t in (self._dec, self._norms, self._ids, self._sizes))

    def occupancy(self) -> int:
        with self._lock:
            return len(self._map)

    def snapshot_counts(self) -> Dict[str, int]:
        """The counters and the occupancy, read together: hits + misses +
        prefetch_hits + prefetch_fetches == resolved; inserts == misses +
        prefetch_fetches; evictions == inserts - occupancy."""
        with self._lock:
            out = dict(self.counts)
            out["occupancy"] = len(self._map)
            return out

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """(decoded [slots, pad, rot], norms, ids, sizes): the scan's
        operands. Only the slots a resolve returned (and pinned) are
        stable."""
        return self._dec, self._norms, self._ids, self._sizes

    def resolve_probes(self, owner: "TieredIvfPq", cluster_probes,
                       trace_id: Optional[str] = None
                       ) -> Tuple[np.ndarray, List[int]]:
        """Demand path: make every probed cluster resident, pin its slot and
        make the current stream wait for the fetches. Returns
        ``(slot_probes, pinned)``: the slot of each probe, shaped like
        ``cluster_probes``, and the slots to hand to :meth:`release`."""
        cp = np.asarray(cluster_probes)
        uniq = np.unique(cp)
        resolved = self._resolve(owner, uniq, "demand", trace_id)
        lut = np.zeros(int(uniq.max()) + 1 if uniq.size else 1, np.int32)
        for c, s in resolved.items():
            lut[c] = s
        return lut[cp].astype(np.int32), sorted(resolved.values())

    def prefetch(self, owner: "TieredIvfPq", clusters,
                 trace_id: Optional[str] = None) -> int:
        """Prefetch path: stage ``clusters`` without demand accounting.
        Returns the number of lists resolved."""
        uniq = np.unique(np.asarray(clusters))
        return len(self._resolve(owner, uniq, "prefetch", trace_id))

    def release(self, pinned: List[int]) -> None:
        """Unpin the slots of a scan once the work queued so far on the
        current stream (the scan) has run; at once on the CPU."""
        if not pinned:
            return
        if self._stream is None:
            with self._lock:
                for s in pinned:
                    self._pins[s] -= 1
                self._cond.notify_all()
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        with self._lock:
            self._inflight.append((ev, pinned))
            self._cond.notify_all()

    def _reap_locked(self) -> None:
        """Unpin the slots of finished scans, the oldest first."""
        while self._inflight:
            ev, pinned = self._inflight[0]
            if not ev.query():
                return
            self._inflight.popleft()
            for s in pinned:
                self._pins[s] -= 1

    def _room_locked(self, keep: set) -> int:
        """Slots a resolve may fill: the free ones, and the mapped ones no
        scan holds and the resolve does not use."""
        return len(self._free) + sum(
            1 for s in self._map.values()
            if self._pins[s] == 0 and s not in keep)

    def _victim_locked(self, keep: set) -> Tuple[object, int]:
        """The coldest mapped slot that no scan holds and this resolve does
        not use (``_resolve`` made sure there is one)."""
        for key, slot in self._map.items():
            if self._pins[slot] == 0 and slot not in keep:
                return key, slot
        raise AssertionError("no arena slot to evict")

    def _fetch_locked(self, owner: "TieredIvfPq", clusters: List[int],
                      slots: List[int], rows) -> Optional[torch.cuda.Event]:
        """Decode one group of host lists into their arena slots (on the
        copy stream on the card). The norms come from the host tier."""
        codes, ids, sizes, norms = rows
        dev = self.device
        stream = self._stream
        ctx = torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()
        with ctx:
            codes_d, ids_d, sizes_d, norms_d = (
                _h2d(t, dev) for t in (codes, ids, sizes, norms))
            slot_t = _h2d(torch.tensor(slots, dtype=torch.int64), dev)
            if owner.per_cluster:
                cl = _h2d(torch.tensor(clusters, dtype=torch.int64), dev)
                cb = owner.codebooks[cl]
            else:
                cb = owner.codebooks
            dec, _ = ivf_pq._decode_lists(cb, codes_d, owner.pq_dim,
                                          owner.pq_bits, owner.per_cluster,
                                          len(clusters), self.cache_dtype)
            valid = (torch.arange(self.list_pad, device=dev)[None, :]
                     < sizes_d[:, None])
            self._dec[slot_t] = dec
            self._norms[slot_t] = norms_d
            self._ids[slot_t] = torch.where(valid, ids_d, -1)
            self._sizes[slot_t] = sizes_d
            if stream is None:
                return None
            ev = torch.cuda.Event()
            ev.record(stream)
            return ev

    # the single mutation point
    def _resolve(self, owner: "TieredIvfPq", uniq: np.ndarray, path: str,
                 trace_id: Optional[str]) -> Dict[int, int]:
        ns = owner.namespace
        t0 = self.clock()
        fetched: List[Tuple[List[int], List[int]]] = []
        last_ev = None
        with self._lock:
            if len(uniq) > self.slots:
                raise TieredArenaError(
                    f"batch probes {len(uniq)} distinct lists but the "
                    f"arena has {self.slots} slots — size the arena with "
                    f"solve_host_tier (worst case max_batch * n_probes)")
            while True:
                # nothing changes until the misses fit: a demand resolve
                # whose misses need slots that scans in flight hold waits
                # for them (a prefetch stages what fits)
                self._reap_locked()
                keys = [(ns, int(c)) for c in uniq]
                hit = [k for k in keys if k in self._map]
                missing = [k[1] for k in keys if k not in self._map]
                keep = {self._map[k] for k in hit}
                room = self._room_locked(keep)
                if path == "prefetch":
                    missing = missing[:room]
                    break
                if len(missing) <= room:
                    break
                if self._inflight:
                    # wait for the oldest scan with the lock released, so
                    # that no resolve or prefetch blocks behind it
                    ev = self._inflight[0][0]
                    self._lock.release()
                    try:
                        ev.synchronize()
                    finally:
                        self._lock.acquire()
                elif not self._cond.wait(timeout=60.0):
                    raise TieredArenaError(
                        f"{len(missing)} lists to fetch, but scans in "
                        f"flight hold the arena's {self.slots} slots")
            if missing:
                # host reads before any map change: a TierReadError leaves
                # the arena as it was
                rows = owner.tier.read_lists(np.asarray(missing, np.int64))
            resolved: Dict[int, int] = {}
            n_useful = 0
            for key in hit:
                slot = self._map[key]
                self._map.move_to_end(key)
                resolved[key[1]] = slot
                if path == "demand" and self._prefetched[slot]:
                    self._prefetched[slot] = False
                    n_useful += 1
            n_hits, n_evict = len(hit), 0
            for c in missing:
                if self._free:
                    slot = self._free.pop()
                else:
                    key, slot = self._victim_locked(keep)
                    del self._map[key]
                    n_evict += 1
                keep.add(slot)
                self._map[(ns, c)] = slot
                self._prefetched[slot] = path == "prefetch"
                resolved[c] = slot
            ft = self.fetch_tile
            for a in range(0, len(missing), ft):
                grp = missing[a:a + ft]
                slots_g = [resolved[c] for c in grp]
                last_ev = self._fetch_locked(
                    owner, grp, slots_g, tuple(r[a:a + ft] for r in rows))
                for s in slots_g:
                    self._ready[s] = last_ev
                fetched.append((grp, slots_g))
            cnt = self.counts
            cnt["inserts"] += len(missing)
            cnt["evictions"] += n_evict
            cnt["resolved"] += n_hits + len(missing)
            if path == "demand":
                cnt["hits"] += n_hits
                cnt["misses"] += len(missing)
                cnt["useful_prefetch"] += n_useful
                for s in resolved.values():
                    self._pins[s] += 1
            else:
                cnt["prefetch_hits"] += n_hits
                cnt["prefetch_fetches"] += len(missing)
            events = list({id(e): e for e in
                           (self._ready[s] for s in resolved.values())
                           if e is not None}.values())
            occ = len(self._map)
        # telemetry and the stall wait run outside the lock
        self.stats.record_resolve(path, n_hits, len(missing), n_evict,
                                  n_useful, occ / self.slots)
        if path == "demand" and self._stream is not None:
            cur = torch.cuda.current_stream(self.device)
            for ev in events:
                cur.wait_event(ev)
        if fetched:
            if last_ev is not None:
                # the host waits for this resolve's fetches (the copy stream
                # runs in order): the stall the histogram records
                last_ev.synchronize()
            stall = self.clock() - t0
            self.stats.record_stall(path, stall)
            if self.span_sink is not None:
                obs_spans.safe_emit(self.span_sink, {
                    "kind": "tier_fetch",
                    "trace": trace_id or obs_spans.new_trace_id(),
                    "arena": self.label,
                    "namespace": ns,
                    "path": path,
                    "n_lists": len(missing),
                    "clusters": [c for g, _ in fetched for c in g],
                    "slots": [s for _, g in fetched for s in g],
                    "stall_s": stall,
                })
        return resolved


def _h2d(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; on the card copied from pinned memory
    without blocking (a copy from pageable memory would first wait for the
    stream)."""
    if device.type != "cuda":
        return t
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


# -------------------------------------------------------- tiered index


class TieredIvfPq:
    """IVF-PQ searcher with the coarse structures on the device and the
    lists in a :class:`HostTier`, resolved through a :class:`SlabArena`.
    ``namespace`` keys this index's slabs in a (possibly shared) arena."""

    def __init__(self, params: "ivf_pq.IndexParams", pq_dim: int,
                 centers, rotation, codebooks, tier: HostTier,
                 arena: SlabArena, n_rows: int,
                 overflow_decoded=None, overflow_norms=None,
                 overflow_indices=None, namespace: Optional[str] = None,
                 res: Optional[Resources] = None) -> None:
        if arena.list_pad != tier.list_pad:
            raise ValueError(f"arena list_pad {arena.list_pad} != tier "
                             f"list_pad {tier.list_pad}")
        if arena.rot_dim != rotation.shape[0]:
            raise ValueError(f"arena rot_dim {arena.rot_dim} != index "
                             f"rot_dim {rotation.shape[0]}")
        if arena.device != centers.device:
            raise ValueError(f"arena on {arena.device}, index on "
                             f"{centers.device}")
        self.params = params
        self.pq_dim = int(pq_dim)
        self.centers = centers
        self.rotation = rotation
        self.codebooks = codebooks
        self.tier = tier
        self.arena = arena
        self.n_rows = int(n_rows)
        self.overflow_decoded = overflow_decoded
        self.overflow_norms = overflow_norms
        self.overflow_indices = (
            overflow_indices if overflow_indices is not None
            else torch.zeros((0,), dtype=torch.int32, device=centers.device))
        self.namespace = namespace or f"tiered{id(self):x}"
        self.res = res

    @property
    def metric(self) -> DistanceType:
        return self.params.metric

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def n_lists(self) -> int:
        return self.tier.n_lists

    @property
    def list_pad(self) -> int:
        return self.tier.list_pad

    @property
    def pq_bits(self) -> int:
        return self.params.pq_bits

    @property
    def per_cluster(self) -> bool:
        return self.params.codebook_kind == CodebookGen.PER_CLUSTER

    @property
    def has_overflow(self) -> bool:
        return self.overflow_indices.shape[0] > 0

    @property
    def centers_rot(self) -> torch.Tensor:
        return dot_fp32(self.centers, self.rotation)

    # -- construction -------------------------------------------------
    @classmethod
    def from_index(cls, index: "ivf_pq.Index",
                   res: Optional[Resources] = None,
                   arena: Optional[SlabArena] = None,
                   arena_slots: Optional[int] = None,
                   namespace: Optional[str] = None,
                   cache_dtype=torch.bfloat16,
                   registry: Optional[obs_metrics.Registry] = None,
                   span_sink=None) -> "TieredIvfPq":
        """Demote an index: its lists to the host tier, the coarse
        structures and the decoded overflow block stay on its device; the
        arena sized by :func:`solve_host_tier` unless given."""
        res = ensure_resources(res, index.device)
        tier = host_tier_from_index(index, cache_dtype)
        od = on = oi = None
        if index.overflow_indices.shape[0] > 0:
            ivf_pq.ensure_overflow_decoded(index, cache_dtype)
            od, on = index.overflow_decoded, index.overflow_norms
            oi = index.overflow_indices
        if arena is None:
            dtype = ivf_pq._dtype(cache_dtype, ivf_pq._FLOAT_DTYPES,
                                  "cache_dtype")
            plan = solve_host_tier(
                tier.n_lists, tier.list_pad, index.rot_dim,
                tier.n_code_bytes, res.workspace_limit_bytes,
                cache_itemsize=dtype.itemsize)
            slots = arena_slots if arena_slots is not None \
                else plan["arena_slots"]
            arena = SlabArena(slots, tier.list_pad, index.rot_dim,
                              cache_dtype=dtype, registry=registry,
                              span_sink=span_sink, device=index.device)
        return cls(index.params, index.pq_dim, index.centers,
                   index.rotation, index.codebooks, tier, arena,
                   index.n_rows, od, on, oi, namespace=namespace, res=res)

    @classmethod
    def from_file(cls, path: str, params=None,
                  res: Optional[Resources] = None,
                  batch_rows: int = 1 << 18, dtype=None,
                  max_train_rows: Optional[int] = None,
                  device=None, **kwargs) -> "TieredIvfPq":
        """Streamed build straight into the tier (``ooc``'s file build,
        whose lists are then demoted to host memory)."""
        from raft_tpu_torch.neighbors import ooc
        res = ensure_resources(res, device)
        index = ooc.build_ivf_pq_from_file(
            path, params=params, res=res, batch_rows=batch_rows,
            dtype=dtype, max_train_rows=max_train_rows)
        return cls.from_index(index, res=res, **kwargs)

    # -- search -------------------------------------------------------
    def _route(self, k: int, scan_mode: str = "auto") -> str:
        """The resident cache engine's route for this request: ``"fused"``
        (``fused_ivf_topk``, L2; under ``"auto"`` on the card only where the
        measured ``ivf_pq`` verdict says it wins, as the resident search
        decides) or ``"scan"`` (``ivf_scan`` + select_k)."""
        ineligible = fused_ineligible_reason(
            self.metric, torch.uint8, int(k), False, False,
            require_float=False)
        if ineligible is not None or (
                scan_mode == "auto"
                and not gk.fused_crossover("ivf_pq", self.device)):
            return "scan"
        return "fused"

    def _coarse(self, queries, route: str, n_probes: int, q_tile: int,
                select_recall: float):
        """The probes the resident engine computes, with the same shapes:
        the whole batch at once on the fused route, per query tile on the
        scan route. Returns (per-tile (q_rot, probes, dots_c), centers_rot);
        probes int64."""
        if route == "fused":
            q_rot, centers_rot, probes = ivf_pq._coarse_probes_rot(
                queries, self, n_probes)
            return [(q_rot, probes.long(), None)], centers_rot
        centers_rot = self.centers_rot
        tiles = []
        for qs in range(0, queries.shape[0], q_tile):
            q_rot = dot_fp32(queries[qs:qs + q_tile], self.rotation)
            probes, dots_c = ivf_pq._coarse(q_rot, centers_rot, n_probes,
                                            self.metric, select_recall)
            tiles.append((q_rot, probes, dots_c))
        return tiles, centers_rot

    def _scan_tile(self, q_rot, probes, slotp, dots_c, centers_rot, k: int,
                   select_recall: float):
        """``ivf_pq._search_cache_core``'s body with ``use_scan`` over the
        arena: the slot of each probe for the slabs, its cluster for the
        centres."""
        dec, norms, ids, sizes = self.arena.tensors()
        metric = self.metric
        t = probes.shape[0]
        bad_fill = torch.inf if metric != DistanceType.InnerProduct \
            else -torch.inf
        sl = slotp.long()
        g_idx = ids[sl]
        d = ivf_pq._scan_distances(q_rot, probes, sl, dots_c, centers_rot,
                                   dec, norms, metric)
        ok = (torch.arange(self.list_pad, device=sl.device)[None, None, :]
              < sizes[sl][:, :, None])
        flat_d = torch.where(ok, d, bad_fill).reshape(t, -1)
        flat_i = g_idx.reshape(t, -1)
        if self.has_overflow:
            od, oi = ivf_pq._pq_overflow_scan(
                q_rot, self.overflow_decoded, self.overflow_norms,
                self.overflow_indices, None, metric, bad_fill)
            flat_d = torch.cat([flat_d, od], dim=1)
            flat_i = torch.cat([flat_i, oi], dim=1)
        return ivf_pq._finish(flat_d, flat_i, k, metric, select_recall)

    def search(self, queries, k: int,
               params: Optional[SearchParams] = None,
               res: Optional[Resources] = None):
        """Top-``k`` → ``(distances [nq, k], ids [nq, k])``, bitwise the
        resident cache search of the same batch (``ivf_pq.search`` with
        ``scan_mode="auto"`` and ``memory_mode="cache"``). ``scan_mode``
        may be ``"auto"`` or ``"cache"``: the tier has the cache regime
        only."""
        params = params or SearchParams()
        if params.scan_mode not in ("auto", "cache"):
            raise ValueError(
                f"tiered serving has only the cache engine; scan_mode="
                f"{params.scan_mode!r} is not tierable")
        if params.scan_cache_dtype != self.arena.cache_dtype:
            raise ValueError(
                f"scan_cache_dtype {params.scan_cache_dtype} != the arena's "
                f"{self.arena.cache_dtype}")
        res = ensure_resources(res if res is not None else self.res,
                               self.device)
        queries = as_query_array(queries, self.device, torch.float32)
        if queries.shape[1] != self.dim:
            raise ValueError(f"queries dim {queries.shape[1]} != index "
                             f"dim {self.dim}")
        k = int(k)
        n_probes = int(min(params.n_probes, self.n_lists))
        route = self._route(k, params.scan_mode)
        q_tile = ivf_pq.plan_cache_tiles(n_probes, self.list_pad,
                                         self.rot_dim,
                                         res.workspace_limit_bytes)
        select_recall = float(params.select_recall)
        tiles, centers_rot = self._coarse(queries, route, n_probes, q_tile,
                                          select_recall)
        cluster_probes = torch.cat([p for _, p, _ in tiles]).cpu().numpy()
        kernel = "fused_ivf_topk" if route == "fused" else "ivf_scan"
        plan = {"q_tile": q_tile, "arena_slots": self.arena.slots,
                "namespace": self.namespace, "route": route}
        plan.update(kernel_plan(self.device, kernel))
        obs_explain.record_dispatch(
            "tiered_ivf_pq", params.scan_mode, "cache", "only_engine",
            params={"n_probes": n_probes, "k": k}, plan=plan)
        slot_np, pinned = self.arena.resolve_probes(
            self, cluster_probes, trace_id=obs_spans.current_trace())
        try:
            slot_probes = _h2d(torch.from_numpy(slot_np), self.device)
            if route == "fused":
                dec, norms, ids, _ = self.arena.tensors()
                q_rot, probes, _ = tiles[0]
                return ivf_pq._search_fused_cache_core(
                    q_rot, centers_rot, probes, slot_probes, dec, norms, ids,
                    self, k, ivf_pq.fused_cache_q_chunk(
                        n_probes, self.rot_dim, res.workspace_limit_bytes))
            out_v, out_i = [], []
            row = 0
            for q_rot, probes, dots_c in tiles:
                t = q_rot.shape[0]
                v, i = self._scan_tile(q_rot, probes,
                                       slot_probes[row:row + t], dots_c,
                                       centers_rot, k, select_recall)
                row += t
                out_v.append(v)
                out_i.append(i)
            return torch.cat(out_v), torch.cat(out_i)
        finally:
            self.arena.release(pinned)

    def prefetch_queries(self, queries, params: Optional[SearchParams] = None,
                         depth: Optional[int] = None,
                         trace_id: Optional[str] = None, k: int = 10) -> int:
        """Stage the lists a later ``search(queries, k)`` would probe (the
        same coarse step). ``depth`` caps the lists staged; a cap is
        logged."""
        params = params or SearchParams()
        res = ensure_resources(self.res, self.device)
        queries = as_query_array(queries, self.device, torch.float32)
        n_probes = int(min(params.n_probes, self.n_lists))
        q_tile = ivf_pq.plan_cache_tiles(n_probes, self.list_pad,
                                         self.rot_dim,
                                         res.workspace_limit_bytes)
        tiles, _ = self._coarse(queries, self._route(k, params.scan_mode),
                                n_probes, q_tile,
                                float(params.select_recall))
        uniq = np.unique(torch.cat([p for _, p, _ in tiles]).cpu().numpy())
        if depth is not None and len(uniq) > depth:
            logger.warning(
                "tier prefetch capped at depth=%d (batch probes %d "
                "distinct lists) — coverage is partial, raise depth to "
                "stage the full peeked batch", depth, len(uniq))
            uniq = uniq[:depth]
        return self.arena.prefetch(self, uniq, trace_id=trace_id)


# ------------------------------------------------------------ prefetcher


class TierPrefetcher:
    """Peeks the engine batcher's next batch (``Batcher.peek()``,
    non-consuming) and stages its probed lists, so that the slab copies
    overlap the previous batch's device time. Its only wait is the budgeted
    ``Event.wait(poll_s)``; its counters have one writer (its thread)."""

    def __init__(self, engine, tiered: TieredIvfPq,
                 params: Optional[SearchParams] = None,
                 depth: Optional[int] = None,
                 poll_s: float = 0.0005) -> None:
        self.engine = engine
        self.tiered = tiered
        self.params = params or SearchParams()
        self.depth = depth
        self.poll_s = float(poll_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seen = None
        self.n_passes = 0
        self.n_capped = 0
        self.n_errors = 0

    def start(self) -> "TierPrefetcher":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(  # guarded_by: atomic
            target=self._loop, name=f"tier-prefetch-{self.tiered.namespace}",
            daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None  # guarded_by: atomic

    def __enter__(self) -> "TierPrefetcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _loop(self) -> None:
        t = self.tiered
        with _device_scope(t.device):
            while not self._stop.wait(self.poll_s):
                batch = self.engine.batcher.peek()
                if not batch:
                    continue
                head = batch[0]
                key = (id(head), head.trace_id, len(batch))
                if key == self._seen:
                    continue
                self._seen = key
                try:
                    # the engine's bucket-padded batch: the same coarse
                    # step as the search it will launch
                    qs = np.zeros((query_bucket(len(batch)), t.dim),
                                  np.float32)
                    for j, r in enumerate(batch):
                        qs[j] = np.asarray(r.query, np.float32).reshape(-1)
                    t.prefetch_queries(qs, params=self.params,
                                       depth=self.depth,
                                       trace_id=head.trace_id, k=head.k)
                    self.n_passes += 1
                except Exception as e:  # a prefetch never takes serving down
                    self.n_errors += 1
                    t.arena.stats.prefetch_event("error")
                    logger.warning("tier prefetch pass failed: %s: %s",
                                   type(e).__name__, e)


def _device_scope(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def attach_prefetcher(engine, tiered: TieredIvfPq,
                      params: Optional[SearchParams] = None,
                      depth: Optional[int] = None,
                      poll_s: float = 0.0005) -> TierPrefetcher:
    """Start a :class:`TierPrefetcher` on a running engine; the caller
    closes it (``close()`` or a ``with`` block)."""
    return TierPrefetcher(engine, tiered, params=params, depth=depth,
                          poll_s=poll_s).start()


# -------------------------------------------------------------- manifest


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as fh:
        while True:
            b = fh.read(chunk)
            if not b:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(b, crc)


def save_tiered(tiered: TieredIvfPq, dir_path: str,
                name: str = "default") -> str:
    """Persist a tiered index in the JAX package's layout: the host lists as
    ``.bin`` files (the streamed-IO format), the coarse structures as one
    ``.npz``, and a ``TIERED_MANIFEST_<name>.json`` with per-list spans and
    crc32s. Returns the manifest's path."""
    os.makedirs(dir_path, exist_ok=True)
    t = tiered.tier
    L, P, B = t.n_lists, t.list_pad, t.n_code_bytes
    rels = {
        "codes": f"tier_{name}_codes.bin",
        "ids": f"tier_{name}_ids.bin",
        "norms": f"tier_{name}_norms.bin",
        "sizes": f"tier_{name}_sizes.bin",
        "coarse": f"tier_{name}_coarse.npz",
    }
    native.write_bin(os.path.join(dir_path, rels["codes"]),
                     t.codes.numpy().reshape(L * P, B))
    native.write_bin(os.path.join(dir_path, rels["ids"]), t.ids.numpy())
    native.write_bin(os.path.join(dir_path, rels["norms"]), t.norms.numpy())
    native.write_bin(os.path.join(dir_path, rels["sizes"]),
                     t.sizes.numpy().reshape(L, 1))

    def host(a) -> np.ndarray:
        return a.detach().to(torch.float32).cpu().numpy()

    coarse = {"centers": host(tiered.centers),
              "rotation": host(tiered.rotation),
              "codebooks": host(tiered.codebooks)}
    if tiered.has_overflow:
        coarse["overflow_decoded"] = host(tiered.overflow_decoded)
        coarse["overflow_norms"] = host(tiered.overflow_norms)
        coarse["overflow_indices"] = tiered.overflow_indices.cpu().numpy(
        ).astype(np.int32)
    np.savez(os.path.join(dir_path, rels["coarse"]), **coarse)
    dtypes = {"codes": "uint8", "ids": "int32", "norms": "float32",
              "sizes": "int32"}
    dims = {"codes": B, "ids": P, "norms": P, "sizes": 1}
    n_rows_of = {"codes": L * P, "ids": L, "norms": L, "sizes": L}
    files = {}
    for key, rel in rels.items():
        entry = {"path": rel,
                 "crc32": _file_crc32(os.path.join(dir_path, rel))}
        if key != "coarse":
            entry.update(rows=n_rows_of[key], dim=dims[key],
                         dtype=dtypes[key])
        files[key] = entry
    sizes = t.sizes.numpy()
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "namespace": tiered.namespace,
        "n_lists": L, "list_pad": P, "n_code_bytes": B,
        "pq_dim": tiered.pq_dim, "pq_bits": tiered.pq_bits,
        "metric": int(tiered.metric),
        "codebook_kind": int(tiered.params.codebook_kind),
        "n_rows": tiered.n_rows, "dim": tiered.dim,
        "rot_dim": tiered.rot_dim,
        "files": files,
        "lists": [{"list": i, "row_start": i * P, "rows": P,
                   "size": int(sizes[i])} for i in range(L)],
    }
    mpath = os.path.join(dir_path, f"{MANIFEST_PREFIX}{name}.json")
    with open(mpath, "w") as fh:
        json.dump(manifest, fh, indent=1)
    return mpath


def validate_manifest(art: dict, base_dir: Optional[str] = None,
                      check_files: bool = False) -> None:
    """Schema and span validation; with ``check_files`` also the header and
    crc32 of every host file (the front half of :func:`load_tiered`)."""
    if art.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(f"schema {art.get('schema')!r} != "
                         f"{MANIFEST_SCHEMA!r}")
    for key in ("n_lists", "list_pad", "n_code_bytes", "pq_dim",
                "pq_bits", "n_rows", "dim", "rot_dim"):
        if not isinstance(art.get(key), int) or art[key] < 0:
            raise ValueError(f"manifest key {key!r} must be a "
                             f"non-negative int, got {art.get(key)!r}")
    L, P = art["n_lists"], art["list_pad"]
    files = art.get("files")
    if not isinstance(files, dict):
        raise ValueError("manifest has no 'files' dict")
    for key in ("codes", "ids", "norms", "sizes", "coarse"):
        entry = files.get(key)
        if not isinstance(entry, dict) or "path" not in entry \
                or "crc32" not in entry:
            raise ValueError(f"files[{key!r}] needs 'path' and 'crc32'")
    lists = art.get("lists")
    if not isinstance(lists, list) or len(lists) != L:
        raise ValueError(f"'lists' must enumerate all {L} lists")
    for row in lists:
        if not all(k in row for k in ("list", "row_start", "rows", "size")):
            raise ValueError(f"list span {row} lacks a "
                             f"list/row_start/rows/size key")
        if row["row_start"] + row["rows"] > L * P:
            raise ValueError(f"list span {row} overruns the codes file "
                             f"({L * P} rows)")
        if row["size"] > P:
            raise ValueError(f"list {row['list']} size {row['size']} "
                             f"exceeds list_pad {P}")
    if not check_files:
        return
    base = base_dir or "."
    for key, entry in files.items():
        full = os.path.join(base, entry["path"])
        if not os.path.exists(full):
            raise FileNotFoundError(f"manifest references missing host "
                                    f"file {entry['path']!r}")
        crc = _file_crc32(full)
        if crc != entry["crc32"]:
            raise ValueError(f"{entry['path']}: crc32 {crc:#010x} != "
                             f"manifest {entry['crc32']:#010x}")
        if key != "coarse":
            rows, dim = native.read_bin_header(full)
            if (rows, dim) != (entry["rows"], entry["dim"]):
                raise ValueError(
                    f"{entry['path']}: header [{rows}, {dim}] != "
                    f"manifest [{entry['rows']}, {entry['dim']}]")


def load_manifest(path: str) -> dict:
    with open(path) as fh:
        art = json.load(fh)
    validate_manifest(art, base_dir=os.path.dirname(path) or ".",
                      check_files=True)
    return art


def load_tiered(manifest_path: str, res: Optional[Resources] = None,
                arena: Optional[SlabArena] = None,
                arena_slots: Optional[int] = None,
                batch_rows: int = 1 << 16,
                registry: Optional[obs_metrics.Registry] = None,
                span_sink=None, device=None) -> TieredIvfPq:
    """A :class:`TieredIvfPq` from its manifest, on ``res``'s device (CUDA
    unless asked for the CPU): the packed codes stream in through
    ``native.iter_bin_batches_prefetch`` into the host tier (pinned on the
    card), the rest loads whole."""
    art = load_manifest(manifest_path)
    base = os.path.dirname(manifest_path) or "."
    res = ensure_resources(res, device)
    dev = res.device
    L, P, B = art["n_lists"], art["list_pad"], art["n_code_bytes"]
    files = art["files"]
    codes = torch.empty((L * P, B), dtype=torch.uint8,
                        pin_memory=dev.type == "cuda")
    codes_np = codes.numpy()
    for off, batch in native.iter_bin_batches_prefetch(
            os.path.join(base, files["codes"]["path"]), batch_rows,
            dtype=np.uint8):
        codes_np[off:off + len(batch)] = batch
    ids = native.read_bin(os.path.join(base, files["ids"]["path"]),
                          dtype=np.int32)
    norms = native.read_bin(os.path.join(base, files["norms"]["path"]),
                            dtype=np.float32)
    sizes = native.read_bin(os.path.join(base, files["sizes"]["path"]),
                            dtype=np.int32).reshape(-1)
    tier = HostTier(codes.view(L, P, B), ids, sizes, norms,
                    pin=dev.type == "cuda")
    with np.load(os.path.join(base, files["coarse"]["path"])) as z:
        def on_dev(key):
            return torch.from_numpy(np.asarray(z[key])).to(dev)
        centers = on_dev("centers")
        rotation = on_dev("rotation")
        codebooks = on_dev("codebooks")
        od = on = oi = None
        if "overflow_indices" in z:
            od = on_dev("overflow_decoded")
            on = on_dev("overflow_norms")
            oi = on_dev("overflow_indices")
    params = ivf_pq.IndexParams(
        n_lists=L, metric=DistanceType(art["metric"]),
        pq_bits=art["pq_bits"],
        codebook_kind=CodebookGen(art["codebook_kind"]))
    if arena is None:
        plan = solve_host_tier(L, P, art["rot_dim"], B,
                               res.workspace_limit_bytes)
        slots = arena_slots if arena_slots is not None \
            else plan["arena_slots"]
        arena = SlabArena(slots, P, art["rot_dim"], registry=registry,
                          span_sink=span_sink, device=dev)
    return TieredIvfPq(params, art["pq_dim"], centers, rotation,
                       codebooks, tier, arena, art["n_rows"], od, on, oi,
                       namespace=art.get("namespace"), res=res)
