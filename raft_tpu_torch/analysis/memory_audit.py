"""Tier B for the port — the memory audit of the canonical entries
(``--memory-audit``, rule B001).

The port's counterpart of ``raft_tpu.analysis.jaxpr_audit``. raft_tpu
abstract-evals each entry's traceable core and walks the jaxpr for a
peak-live-set bound. The port has no jaxpr; it runs the entry's torch
route under a ``TorchDispatchMode`` (:class:`LiveBytes`) that adds the
storage bytes of every op's outputs when the storage is created and
subtracts them when it is freed, so the peak is the route's workspace:

- only storages the route creates count; its inputs (the index, the
  queries) are resident data, not workspace, as a jaxpr's invars are;
- a storage lives until its last tensor or view is freed, so a view that
  outlives its base keeps the bytes counted;
- on the CPU the route runs under ``FakeTensorMode``: the canonical
  shapes (the sift-1M crash shape of raft_tpu's LUT_CRASH record, 1M × 128
  rows) allocate nothing, as JAX's abstract eval does. A kernel there is an
  opaque op (:func:`card_footprints`): it allocates what its wrapper
  allocates on the card (its outputs and its plan's scratch), since its
  plain version is the CPU's stand-in, not the card's route.

On the card, :func:`raft_tpu_torch.obs.costs.measure_entry` runs the same
entries on real indexes and reads the caching allocator's peak instead.

B001: an entry whose peak exceeds its workspace budget
(:data:`DEFAULT_BUDGET_BYTES`, the CPU-fallback ``workspace_limit_bytes``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from raft_tpu_torch.analysis.findings import Finding

#: the Resources CPU/unknown-device fallback (core.resources): the budget
#: every planner solves against when the device reports no memory
DEFAULT_BUDGET_BYTES = 2 << 30

AUDIT_RULE = "B001"
AUDIT_FILE = "memory-audit"


# --------------------------------------------------------------- the walker


def _storage_key(t: torch.Tensor) -> int:
    """One key per storage, the same for every view of it."""
    return t.untyped_storage()._cdata


def tensors_of(obj, depth: int = 3) -> List[torch.Tensor]:
    """The tensors an input holds: itself, its items, its attributes (an
    index's lists, norms, ids), ``depth`` levels down."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if depth == 0:
        return []
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for item in items for t in tensors_of(item, depth - 1)]


class LiveBytes(TorchDispatchMode):
    """Counts the bytes of the storages created under it: ``live`` now,
    ``peak`` the most at once. The storages of ``resident`` tensors (the
    inputs) are never counted, nor are views of them."""

    def __init__(self, resident=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._tracked: set = {_storage_key(t) for t in resident}

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._tracked.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._tracked:
                continue
            n = st.nbytes()
            self._tracked.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def peak_live_bytes(fn: Callable, *args, resident=(), **kwargs) -> int:
    """Peak simultaneously-live bytes of the storages ``fn(*args)``
    creates (its workspace and its results); the storages of ``args`` and
    of ``resident`` (tensors or objects holding them) are inputs, not
    workspace."""
    held = tensors_of(list(args)) + tensors_of(list(resident))
    mode = LiveBytes(held)
    with mode:
        out = fn(*args, **kwargs)
    del out
    return mode.peak


# ----------------------------------------------------------- the kernels


def _kernel_standins(gk) -> dict:
    """Each wrapper as its card footprint: the outputs and the scratch its
    plan gives it (``plan.scratch_bytes``, and ``fused_l2_topk``'s range
    partials), allocated and nothing computed."""
    n_sm = 132

    def empty(shape, dtype, like):
        return torch.empty(shape, dtype=dtype, device=like.device)

    def scratch(nbytes, like):
        return empty((max(int(nbytes), 0),), torch.uint8, like)

    def l2_topk(x, y, k, x_norms=None, y_norms=None):
        m, d = x.shape
        plan = gk.plan_fused_topk(m, y.shape[0], d, k, n_sm)
        keep = [scratch(plan.scratch_bytes, x)]
        if plan.splits > 1:
            rows = min(plan.q_chunk, m)
            keep.append(empty((rows, plan.splits, k), torch.float32, x))
            keep.append(empty((rows, plan.splits, k), torch.int32, x))
        return (empty((m, k), torch.float32, x),
                empty((m, k), torch.int32, x))

    def ivf_topk(probes, qres, qres_norms, list_data, row_norms,
                 list_indices, k, clamp=True):
        nq, n_probes, rot = qres.shape
        n_lists, pad = row_norms.shape
        plan = gk.plan_fused_ivf(nq, n_probes, n_lists, pad, rot, k,
                                 list_data.element_size(), n_sm)
        scratch(plan.scratch_bytes, qres)
        return (empty((nq, k), torch.float32, qres),
                empty((nq, k), torch.int32, qres))

    def pq_topk(probes, q_rot, centers_rot, codebooks, cb_norms, list_codes,
                list_indices, k):
        nq, n_probes = probes.shape
        n_lists, pad, pq_dim = list_codes.shape
        plan = gk.plan_fused_pq(nq, n_probes, n_lists, pad, pq_dim,
                                codebooks.shape[2], k)
        scratch(plan.scratch_bytes, q_rot)
        return (empty((nq, k), torch.float32, q_rot),
                empty((nq, k), torch.int32, q_rot))

    def cagra_topk(queries, dataset, graph, seed_ids, q_norms, k, itopk=64,
                   width=1, max_iter=0):
        nq = queries.shape[0]
        return (empty((nq, k), torch.float32, queries),
                empty((nq, k), torch.int32, queries))

    def l2_argmin(x, y, x_norms=None, y_norms=None, clamp=False, tile=None):
        plan = gk.plan_fused_argmin(x.shape[0], y.shape[0], x.shape[1])
        scratch(plan.scratch_bytes, x)
        return (empty((x.shape[0],), torch.float32, x),
                empty((x.shape[0],), torch.int32, x))

    def select_k(values, k, select_min=True):
        b = values.shape[0]
        return (empty((b, k), torch.float32, values),
                empty((b, k), torch.int32, values))

    def scan(probes, qres, list_data, row_norms):
        nq, n_probes = probes.shape
        n_lists, pad = row_norms.shape
        scratch(4 * gk.ivf_group_scratch(nq * n_probes, n_lists), qres)
        return empty((nq, n_probes, pad), torch.float32, qres)

    return {"fused_l2_topk": l2_topk, "fused_ivf_topk": ivf_topk,
            "fused_pq_topk": pq_topk, "fused_cagra_topk": cagra_topk,
            "fused_l2_argmin": l2_argmin, "streaming_select_k": select_k,
            "ivf_scan": scan}


@contextlib.contextmanager
def card_footprints():
    """Within it, every kernel wrapper of ``ops.gpu_kernels`` is its card
    footprint (:func:`_kernel_standins`), whatever device its tensors are
    on."""
    from raft_tpu_torch.ops import gpu_kernels as gk

    saved = {}
    try:
        for name, fn in _kernel_standins(gk).items():
            saved[name] = getattr(gk, name)
            setattr(gk, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(gk, name, fn)


# ------------------------------------------------------------ the entries


@dataclasses.dataclass(frozen=True)
class Sift1MCrashShape:
    """The shape of raft_tpu's LUT_CRASH record: SIFT-1M under the sift-1M
    bench conf (1M rows, dim 128, 1,024 lists of 1,464 slots at the 1.5×
    pad budget, pq_dim 64, pq_bits 8, 64 probes, k 100)."""

    nq: int = 1024
    dim: int = 128
    n_lists: int = 1024
    list_pad: int = 1464
    pq_dim: int = 64
    pq_bits: int = 8
    n_probes: int = 64
    k: int = 100
    n_rows: int = 1_000_000

    @property
    def book(self) -> int:
        return 1 << self.pq_bits

    @property
    def pq_len(self) -> int:
        return self.dim // self.pq_dim

    @property
    def n_code_bytes(self) -> int:
        return self.pq_dim * self.pq_bits // 8


def fake_inputs(shape: Optional[Sift1MCrashShape] = None,
                device="cpu") -> dict:
    """The entries' inputs at ``shape`` as empty tensors: call inside a
    ``FakeTensorMode`` (or on the ``meta`` device) so that nothing is
    allocated. Keys: ``queries``, ``bf`` (brute force), ``flat``
    (IVF-Flat), ``pq`` (IVF-PQ with its bf16 cache), ``cagra``."""
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops.distance import DistanceType

    s = shape or Sift1MCrashShape()

    def e(*dims, dtype=torch.float32):
        return torch.empty(dims, dtype=dtype, device=device)

    L, pad, d = s.n_lists, s.list_pad, s.dim
    i32 = torch.int32
    dataset = e(s.n_rows, d)
    flat = ivf_flat.Index(ivf_flat.IndexParams(n_lists=L), e(L, d),
                          e(L, pad, d), e(L, pad, dtype=i32), e(L, dtype=i32),
                          s.n_rows)
    pq = ivf_pq.Index(
        ivf_pq.IndexParams(n_lists=L, pq_bits=s.pq_bits, pq_dim=s.pq_dim),
        s.pq_dim, e(L, d), e(d, d), e(s.pq_dim, s.book, s.pq_len),
        e(L, pad, s.n_code_bytes, dtype=torch.uint8), e(L, pad, dtype=i32),
        e(L, dtype=i32), s.n_rows)
    pq.list_decoded = e(L, pad, d, dtype=torch.bfloat16)
    pq.decoded_norms = e(L, pad)
    return {
        "queries": e(s.nq, d),
        "bf": brute_force.Index(dataset, DistanceType.L2Expanded, 2.0,
                                e(s.n_rows)),
        "flat": flat, "pq": pq,
        "cagra": cagra.Index(cagra.IndexParams(graph_degree=64), dataset,
                             e(s.n_rows, 64, dtype=i32)),
    }


def _lut(budget, ctx, unbounded=False):
    from raft_tpu_torch.neighbors import ivf_pq

    pq, q = ctx["pq"], ctx["queries"]
    ivf_pq.ensure_overflow_decoded(pq)  # as the search does, before it
    pad = pq.list_codes.shape[1]
    n_probes, k = ctx.get("n_probes", 64), ctx.get("k", 100)
    if unbounded:
        # raft_tpu's planning before its LUT was tiled: one-axis q_tile
        # from the LUT + packed-code gather alone (about 1/5 of the true
        # live set) and all probes in one pass
        naive = n_probes * (pq.pq_dim * pq.pq_book_size * 12
                            + pad * pq.list_codes.shape[2])
        q_tile = int(np.clip(budget // max(naive, 1), 1, 1024))
        if q_tile >= 8:
            q_tile -= q_tile % 8
        probe_tile, planner, predicted = 0, None, None
    else:
        q_tile, probe_tile = ivf_pq.plan_lut_tiles(
            n_probes, pad, pq.pq_dim, pq.pq_bits, budget)
        planner = "ivf_pq.plan_lut_tiles"
        predicted = q_tile * probe_tile * ivf_pq.lut_bytes_per_query_probe(
            pad, pq.pq_dim, pq.pq_bits)

    def fn():
        return ivf_pq._search_lut_core(q, pq, None, k, n_probes, q_tile,
                                       torch.float32, torch.float32,
                                       probe_tile=probe_tile)
    return fn, {"family": "ivf_pq", "planner": planner,
                "predicted_bytes": predicted,
                "tiles": {"q_tile": q_tile, "probe_tile": probe_tile}}


def _cache(budget, ctx):
    from raft_tpu_torch.neighbors import ivf_pq

    pq, q = ctx["pq"], ctx["queries"]
    ivf_pq.ensure_overflow_decoded(pq)
    pad, rot = pq.list_decoded.shape[1:]
    n_probes, k = ctx.get("n_probes", 64), ctx.get("k", 100)
    q_tile = ivf_pq.plan_cache_tiles(n_probes, pad, rot, budget)

    def fn():
        return ivf_pq._search_cache_core(q, pq, None, k, n_probes, q_tile)
    return fn, {"family": "ivf_pq", "planner": "ivf_pq.plan_cache_tiles",
                "predicted_bytes": q_tile * ivf_pq.cache_bytes_per_query(
                    n_probes, pad, rot), "tiles": {"q_tile": q_tile}}


def _encode(budget, ctx):
    from raft_tpu_torch.neighbors import ivf_pq

    pq, x = ctx["pq"], ctx["bf"].dataset
    row_tile = int(np.clip(budget // max(pq.pq_dim * pq.pq_book_size * 16,
                                         1), 8, 4096))
    labels = ctx.get("labels")
    if labels is None:
        labels = torch.empty((x.shape[0],), dtype=torch.int32,
                             device=x.device)

    def fn():
        return ivf_pq._encode(x, labels, pq.centers, pq.rotation,
                              pq.codebooks, False, row_tile)
    return fn, {"family": "ivf_pq", "planner": None, "predicted_bytes": None,
                "tiles": {"row_tile": row_tile}}


def _flat(budget, ctx):
    from raft_tpu_torch.neighbors import ivf_flat

    flat, q = ctx["flat"], ctx["queries"]
    pad, dim = flat.list_data.shape[1:]
    n_probes, k = ctx.get("n_probes", 64), ctx.get("k", 100)
    q_tile = ivf_flat.plan_scan_tiles(n_probes, pad, dim, budget)

    def fn():
        return ivf_flat._search_core(q, flat, None, k, n_probes, q_tile)
    return fn, {"family": "ivf_flat", "planner": "ivf_flat.plan_scan_tiles",
                "predicted_bytes": q_tile * ivf_flat.scan_bytes_per_query(
                    n_probes, pad, dim), "tiles": {"q_tile": q_tile}}


def _bf_queries(ctx):
    """brute force's canonical 10,000 queries: the context's own when it
    has that many, else 10,000 rows like its first."""
    q = ctx.get("bf_queries")
    if q is not None:
        return q
    q = ctx["queries"]
    return torch.empty((10_000, q.shape[1]), dtype=q.dtype, device=q.device)


def _bf(budget, ctx):
    from raft_tpu_torch.neighbors import brute_force

    bf, q = ctx["bf"], _bf_queries(ctx)
    k = ctx.get("k", 100)
    nq, (n, dim) = q.shape[0], bf.dataset.shape
    q_tile, db_tile = brute_force._choose_tiles(nq, n, dim, k, budget)

    def fn():
        return brute_force._knn_tiled(q, bf, None, k, q_tile, db_tile, 1.0,
                                      budget=budget)
    return fn, {"family": "brute_force",
                "planner": "brute_force._choose_tiles",
                "predicted_bytes": brute_force.planned_peak_bytes(
                    nq, n, dim, k, budget),
                "tiles": {"q_tile": q_tile, "db_tile": db_tile}}


def _select(budget, ctx):
    import importlib

    sk = importlib.import_module("raft_tpu_torch.ops.select_k")
    like = ctx["queries"]
    v = ctx.get("select_values")
    if v is None:
        v = torch.empty((1024, 65536), dtype=torch.float32,
                        device=like.device)

    def fn():
        return sk.select_k(v, 64)
    return fn, {"family": "select_k", "planner": None,
                "predicted_bytes": None, "tiles": {}}


def _l2_nn(budget, ctx):
    from raft_tpu_torch.ops import fused_l2_nn as fl

    like = ctx["queries"]
    x = ctx.get("nn_x")
    y = ctx.get("nn_y")
    if x is None:
        x = torch.empty((100_000, 128), device=like.device)
        y = torch.empty((4096, 128), device=like.device)
    xn = torch.empty((x.shape[0],), device=x.device)
    yn = torch.empty((y.shape[0],), device=x.device)
    tile = fl.choose_tile_rows(x.shape[0], y.shape[0], budget)

    def fn():
        return fl.l2_nn_unfused(x, y, xn, yn, tile)
    return fn, {"family": "fused_l2_nn",
                "planner": "fused_l2_nn.choose_tile_rows",
                "predicted_bytes": fl.planned_peak_bytes(
                    x.shape[0], y.shape[0], budget),
                "tiles": {"row_tile": tile}}


def _bf_fused(budget, ctx):
    from raft_tpu_torch.ops import gpu_kernels as gk

    bf, q = ctx["bf"], _bf_queries(ctx)
    k = ctx.get("k", 100)
    n, dim = bf.dataset.shape
    plan = gk.plan_fused_topk(q.shape[0], n, dim, k, ctx.get("n_sm", 132))

    def fn():
        qn = (q * q).sum(-1)
        return gk.fused_l2_topk(q, bf.dataset, k, qn, bf.norms)
    return fn, {"family": "brute_force", "planner": "gpu_kernels."
                "plan_fused_topk", "predicted_bytes": plan.scratch_bytes,
                "tiles": {"route": plan.route, "q_chunk": plan.q_chunk,
                          "splits": plan.splits}}


def _flat_fused(budget, ctx):
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import gpu_kernels as gk

    flat, q = ctx["flat"], ctx["queries"]
    pad, dim = flat.list_data.shape[1:]
    n_probes, k = ctx.get("n_probes", 64), ctx.get("k", 100)
    plan = gk.plan_fused_ivf(q.shape[0], n_probes, flat.n_lists, pad, dim,
                             k, flat.list_data.element_size(),
                             ctx.get("n_sm", 132))
    flat.ensure_row_norms()
    flat.safe_ids()

    def fn():
        return ivf_flat._search_fused_core(q, flat, k, n_probes)
    return fn, {"family": "ivf_flat", "planner": "gpu_kernels.plan_fused_ivf",
                "predicted_bytes": plan.scratch_bytes,
                "tiles": {"route": plan.route, "runs": plan.runs,
                          "q_chunk": plan.q_chunk}}


def _pq_fused_lut(budget, ctx):
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import gpu_kernels as gk

    pq, q = ctx["pq"], ctx["queries"]
    pad = pq.list_codes.shape[1]
    n_probes, k = ctx.get("n_probes", 64), ctx.get("k", 100)
    plan = gk.plan_fused_pq(q.shape[0], n_probes, pq.n_lists, pad,
                            pq.pq_dim, pq.pq_len, k)
    pq.safe_ids()
    ivf_pq.ensure_overflow_decoded(pq)

    def fn():
        return ivf_pq._search_fused_lut_core(q, pq, k, n_probes)
    return fn, {"family": "ivf_pq", "planner": "gpu_kernels.plan_fused_pq",
                "predicted_bytes": plan.scratch_bytes,
                "tiles": {"route": plan.route, "warps": plan.warps,
                          "q_chunk": plan.q_chunk}}


def _pq_fused_cache(budget, ctx):
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import gpu_kernels as gk

    pq, q = ctx["pq"], ctx["queries"]
    pad, rot = pq.list_decoded.shape[1:]
    n_probes, k = ctx.get("n_probes", 64), ctx.get("k", 100)
    q_chunk = ivf_pq.fused_cache_q_chunk(n_probes, rot, budget)
    plan = gk.plan_fused_ivf(min(q_chunk, q.shape[0]), n_probes, pq.n_lists,
                             pad, rot, k, pq.list_decoded.element_size(),
                             ctx.get("n_sm", 132))
    ids = pq.safe_ids()
    ivf_pq.ensure_overflow_decoded(pq)

    def fn():
        q_rot, centers_rot, probes = ivf_pq._coarse_probes_rot(q, pq,
                                                               n_probes)
        return ivf_pq._search_fused_cache_core(
            q_rot, centers_rot, probes, probes, pq.list_decoded,
            pq.decoded_norms, ids, pq, k, q_chunk)
    return fn, {"family": "ivf_pq", "planner": "gpu_kernels.plan_fused_ivf",
                "predicted_bytes": plan.scratch_bytes,
                "tiles": {"route": plan.route, "q_chunk": q_chunk}}


def _cagra_fused(budget, ctx):
    from raft_tpu_torch.neighbors import cagra

    cg, q = ctx["cagra"], ctx["queries"]
    k = ctx.get("cagra_k", 10)
    params = cagra.SearchParams(itopk_size=64, search_width=1)
    itopk, width, max_iter, n_seeds = cagra.resolve_search_plan(
        params, k, cg.size)
    seeds = ctx.get("seeds")
    if seeds is None:
        seeds = torch.empty((q.shape[0], n_seeds), dtype=torch.int32,
                            device=q.device)

    def fn():
        return cagra.search_fused_core(q, cg.dataset, cg.graph, seeds,
                                       cg.metric, k, itopk, width, max_iter)
    return fn, {"family": "cagra", "planner": None, "predicted_bytes": None,
                "tiles": {"itopk": itopk, "width": width,
                          "max_iter": max_iter}}


#: the entries, by raft_tpu's names (``jaxpr_audit.default_entries``)
ENTRY_MAKERS = (
    ("ivf_pq.search[lut]@sift1m-crash", _lut),
    ("ivf_pq.search[cache]@sift1m", _cache),
    ("ivf_pq.encode_batch@1m", _encode),
    ("ivf_flat.search@1m", _flat),
    ("brute_force.knn@1m", _bf),
    ("select_k@1024x65536", _select),
    ("fused_l2_nn@100kx4096", _l2_nn),
    ("brute_force.knn[fused]@1m", _bf_fused),
    ("ivf_flat.search[fused]@sift1m", _flat_fused),
    ("ivf_pq.search[fused-lut]@sift1m-crash", _pq_fused_lut),
    ("ivf_pq.search[fused-cache]@sift1m", _pq_fused_cache),
    ("cagra.search[fused]@1m", _cagra_fused),
)


@dataclasses.dataclass
class AuditEntry:
    """One audited entry: ``make(budget, ctx)`` → ``(fn, meta)``, ``fn()``
    running the entry's route on the inputs of ``ctx``
    (:func:`fake_inputs`'s keys), planned against ``budget_bytes`` as the
    public API plans it; ``meta`` names the planner and its predicted
    workspace bytes (the C001 calibration's prediction)."""

    name: str
    budget_bytes: int
    make: Callable

    def run(self, shape: Optional[Sift1MCrashShape] = None
            ) -> "AuditResult":
        """The entry on the CPU, under ``FakeTensorMode`` at ``shape``."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode(), card_footprints():
            ctx = fake_inputs(shape)
            fn, meta = self.make(self.budget_bytes, ctx)
            peak = peak_live_bytes(fn, resident=[ctx])
        return AuditResult(self.name, peak, self.budget_bytes, meta)


@dataclasses.dataclass
class AuditResult:
    name: str
    peak_bytes: int
    budget_bytes: int
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.peak_bytes <= self.budget_bytes

    def format(self) -> str:
        status = "OK  " if self.ok else "FAIL"
        return (f"  {status} {self.name}: peak "
                f"{self.peak_bytes / 2**20:.1f} MiB / budget "
                f"{self.budget_bytes / 2**20:.0f} MiB")


def default_entries(budget_bytes: int = DEFAULT_BUDGET_BYTES) -> list:
    return [AuditEntry(name, budget_bytes, make)
            for name, make in ENTRY_MAKERS]


def run_audit(entries: Optional[list] = None,
              budget_bytes: int = DEFAULT_BUDGET_BYTES
              ) -> tuple[list, list]:
    """→ (results, findings): one :class:`AuditResult` per entry, one B001
    :class:`Finding` per entry whose peak exceeds its budget."""
    entries = default_entries(budget_bytes) if entries is None else entries
    results = [e.run() for e in entries]
    return results, budget_findings(results)


def budget_findings(results) -> List[Finding]:
    """B001 for each result (anything with ``name``, ``peak_bytes`` and
    ``budget_bytes``) above its budget."""
    return [Finding(AUDIT_RULE, AUDIT_FILE, r.name, 0,
                    f"peak live bytes {r.peak_bytes / 2**20:.0f} MiB exceed "
                    f"the workspace budget {r.budget_bytes / 2**20:.0f} MiB")
            for r in results if r.peak_bytes > r.budget_bytes]


def lut_itemized_peak(shape: Optional[Sift1MCrashShape] = None,
                      budget_bytes: int = DEFAULT_BUDGET_BYTES) -> int:
    """The itemized oracle: ``lut_bytes_per_query_probe`` at the planned
    tiles (raft_tpu's ``jaxpr_audit.lut_itemized_peak``)."""
    from raft_tpu_torch.neighbors import ivf_pq

    s = shape or Sift1MCrashShape()
    q_tile, probe_tile = ivf_pq.plan_lut_tiles(
        s.n_probes, s.list_pad, s.pq_dim, s.pq_bits, budget_bytes)
    return q_tile * probe_tile * ivf_pq.lut_bytes_per_query_probe(
        s.list_pad, s.pq_dim, s.pq_bits)


def lut_entry(budget_bytes: int = DEFAULT_BUDGET_BYTES,
              unbounded_variant: bool = False) -> AuditEntry:
    """The LUT entry; ``unbounded_variant`` plans it as raft_tpu did before
    its LUT was tiled (the ~19 GB live set of LUT_CRASH)."""
    name = "ivf_pq.search[lut]@sift1m-crash"
    if unbounded_variant:
        return AuditEntry(name + "[untiled]", budget_bytes,
                          lambda b, ctx: _lut(b, ctx, unbounded=True))
    return AuditEntry(name, budget_bytes, _lut)
