"""The spans and counters inside raft_tpu_torch's IVF searches, on the CPU.

``core.tracing``'s spans enter a ``torch.profiler.record_function`` only
while a capture is active and time themselves into
``raft_tpu_span_seconds`` only while span stats are on. Inside
``ivf_flat.search`` and ``ivf_pq.search`` they name the plan, the coarse
step, the scan, the overflow block and the host's waits; beside them the
registry counts the overflow rows scanned, each ``select_k`` by the
algorithm it resolved to, and each host wait. Every engine is covered: the
fused kernels (their plain versions here), the unfused tile loops and the
filtered search, on small indexes whose pad leaves an overflow block.
"""

import json
import math

import numpy as np
import pytest
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.obs.metrics import REGISTRY

N_ROWS, DIM, NQ, K = 3000, 16, 50, 5
#: small enough that the tile loops run four tiles of the 50 queries
WORKSPACE = 1 << 20
SPANS = ("plan", "coarse", "scan", "overflow")

# (name, family, params, filtered, memory_mode)
ENGINES = [
    ("flat-fused", "ivf_flat", {}, False, None),
    ("flat-tiled", "ivf_flat", {"scan_mode": "xla"}, False, None),
    ("flat-filtered", "ivf_flat", {}, True, None),
    ("pq-fused-lut", "ivf_pq", {}, False, "lut"),
    ("pq-fused-cache", "ivf_pq", {}, False, "cache"),
    ("pq-lut", "ivf_pq", {"scan_mode": "lut"}, False, "lut"),
    ("pq-cache", "ivf_pq", {"scan_mode": "cache"}, False, "cache"),
    ("pq-filtered", "ivf_pq", {}, True, "lut"),
]
ENGINE_IDS = [e[0] for e in ENGINES]
#: the engine each case must take (the explain record's)
EXPECTED_ENGINE = {"flat-fused": "pallas", "flat-tiled": "xla",
                   "flat-filtered": "xla", "pq-fused-lut": "pallas_lut",
                   "pq-fused-cache": "pallas_cache", "pq-lut": "lut",
                   "pq-cache": "cache", "pq-filtered": "lut"}


def _data(device):
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.standard_normal((N_ROWS, DIM))
                            .astype(np.float32)).to(device)
    keep = torch.from_numpy(rng.random(N_ROWS) > 0.1).to(device)
    res = Resources(device, seed=3)
    # a pad of the mean list size leaves the hot lists' rows spilled
    flat = ivf_flat.build(rows, ivf_flat.IndexParams(
        n_lists=16, list_pad_expansion=1.0), res=res)
    pq = ivf_pq.build(rows, ivf_pq.IndexParams(
        n_lists=16, pq_dim=8, pq_bits=8, list_pad_expansion=1.0), res=res)
    assert flat.overflow_indices.shape[0] > 0
    assert pq.overflow_indices.shape[0] > 0
    queries = rows[:NQ]
    return {"ivf_flat": flat, "ivf_pq": pq,
            "queries": queries.numpy() if queries.is_cpu else queries,
            "filter": Bitset.from_mask(keep)}


@pytest.fixture(scope="module")
def data():
    return _data(torch.device("cpu"))


@pytest.fixture(scope="module")
def card_data():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync check watches a card")
    return _data(torch.device("cuda"))


def _search(data, case, explain=False, queries=None):
    _, family, params, filtered, memory_mode = case
    index = data[family]
    q = data["queries"] if queries is None else queries
    res = Resources(index.device, workspace_limit_bytes=WORKSPACE)
    filt = data["filter"] if filtered else None
    if family == "ivf_flat":
        return ivf_flat.search(index, q, K,
                               ivf_flat.SearchParams(n_probes=4, **params),
                               filter=filt, res=res, explain=explain)
    return ivf_pq.search(index, q, K, ivf_pq.SearchParams(n_probes=4,
                                                          **params),
                         filter=filt, res=res, explain=explain,
                         memory_mode=memory_mode)


def _series(family: str) -> dict:
    fam = REGISTRY.get(family)
    if fam is None:
        return {}
    return {key: (child.count if hasattr(child, "count") else child.value)
            for key, child in fam.collect()}


def _delta(before: dict, after: dict) -> dict:
    out = {key: after[key] - before.get(key, 0) for key in after}
    return {key: v for key, v in out.items() if v}


def _tiles(record) -> int:
    """Query tiles of the search's loop: one for a fused engine."""
    q_tile = record.plan.get("q_tile")
    return 1 if q_tile is None else math.ceil(NQ / q_tile)


def _user_spans(trace_path, prefix):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(prefix)]


# ------------------------------------------------------------ core.tracing


def test_spans_are_free_when_off():
    assert tracing.span("a") is tracing.span("b")  # one shared no-op scope
    with tracing.span("a"):
        pass
    assert tracing.set_span_stats(True) is False
    try:
        assert tracing.span("a") is not tracing.span("a")
        with tracing.span_stats(False):
            assert tracing.span("a") is tracing.span("b")
        assert tracing.set_span_stats(True) is True  # restored on exit
    finally:
        tracing.set_span_stats(False)


def test_span_stats_time_ranges_and_decorators():
    @tracing.range("spans.test.outer")
    def outer():
        with tracing.range("spans.test.inner"):
            return 1

    before = _series("raft_tpu_span_seconds")
    outer()  # off: nothing observed
    with tracing.span_stats():
        outer()
        outer()
        with pytest.raises(KeyError):
            with tracing.span("spans.test.raises"):
                raise KeyError("propagates")
    got = _delta(before, _series("raft_tpu_span_seconds"))
    assert got == {("spans.test.outer",): 2, ("spans.test.inner",): 2,
                   ("spans.test.raises",): 1}
    child = REGISTRY.get("raft_tpu_span_seconds").labels("spans.test.outer")
    assert child.sum > 0


# ------------------------------------------------------- the IVF searches


@pytest.mark.parametrize("case", ENGINES, ids=ENGINE_IDS)
def test_trace_nests_the_search_spans_in_order(data, case, tmp_path):
    family = case[1]
    _, _, rec = _search(data, case, explain=True)
    assert rec.engine == EXPECTED_ENGINE[case[0]]
    with tracing.profile(str(tmp_path)):
        _search(data, case)
    spans = _user_spans(tmp_path / "trace.json", family + ".search")
    parents = [s for s in spans if s[0] == family + ".search"]
    assert len(parents) == 1
    _, t0, t1 = parents[0]
    first = {}
    for name, s, e in spans:
        assert t0 <= s <= e <= t1, name
        first.setdefault(name, (s, e))
    names = [f"{family}.search.{n}" for n in SPANS]
    assert all(n in first for n in names), sorted(first)
    starts = [first[n][0] for n in names]
    assert starts == sorted(starts)
    plan_end = first[names[0]][1]
    assert plan_end <= first[names[1]][0]  # the plan ends before any launch
    tiles = _tiles(rec)
    for n in names[1:]:
        assert sum(1 for s in spans if s[0] == n) == tiles, n


@pytest.mark.parametrize("case", ENGINES, ids=ENGINE_IDS)
def test_span_stats_observe_each_span_once_a_call_or_tile(data, case):
    family = case[1]
    _, _, rec = _search(data, case, explain=True)
    tiles = _tiles(rec)
    before = _series("raft_tpu_span_seconds")
    with tracing.span_stats():
        _search(data, case)
        _search(data, case)
    got = _delta(before, _series("raft_tpu_span_seconds"))
    want = {(f"{family}.search",): 2, (f"{family}.search.plan",): 2}
    for n in SPANS[1:]:
        want[(f"{family}.search.{n}",)] = 2 * tiles
    assert got == want


@pytest.mark.parametrize("case", ENGINES, ids=ENGINE_IDS)
def test_record_function_never_entered_when_off(data, case, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _search(data, case)
    assert entered == []
    with tracing.span_stats():
        _search(data, case)
    assert entered == []  # stats alone time the spans on the host clock
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _search(data, case)
    assert f"{case[1]}.search.plan" in entered


@pytest.mark.parametrize("case", ENGINES, ids=ENGINE_IDS)
def test_overflow_counter_counts_queries_times_rows(data, case):
    family = case[1]
    before = _series("raft_tpu_overflow_rows_scanned_total")
    _search(data, case)
    got = _delta(before, _series("raft_tpu_overflow_rows_scanned_total"))
    rows = data[family].overflow_indices.shape[0]
    assert got == {(family,): NQ * rows}


@pytest.mark.parametrize("case", ENGINES, ids=ENGINE_IDS)
def test_select_k_counter_matches_the_explain_notes(data, case):
    before = _series("raft_tpu_select_k_total")
    _, _, rec = _search(data, case, explain=True)
    got = _delta(before, _series("raft_tpu_select_k_total"))
    notes = {}
    for note in rec.notes:
        notes[(note["algo"],)] = notes.get((note["algo"],), 0) + 1
    assert notes and got == notes


@pytest.mark.parametrize("case", ENGINES, ids=ENGINE_IDS)
def test_results_bitwise_equal_with_spans_on_and_off(data, case, tmp_path):
    d0, i0 = _search(data, case)
    with tracing.span_stats():
        d1, i1 = _search(data, case)
    with tracing.span_stats(), tracing.profile(str(tmp_path)):
        d2, i2 = _search(data, case)
    for d, i in ((d1, i1), (d2, i2)):
        assert torch.equal(d, d0) and torch.equal(i, i0)


def test_no_host_wait_for_queries_already_on_the_index_device(data):
    before = _series("raft_tpu_host_sync_total")
    for case in ENGINES:
        _search(data, case, queries=torch.from_numpy(data["queries"]))
        _search(data, case)  # host arrays on a CPU index: no card to wait on
    assert _delta(before, _series("raft_tpu_host_sync_total")) == {}


def test_blocks_host_is_a_copy_between_host_and_card():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    host = np.zeros((2, 3), np.float32)
    assert brute_force.blocks_host(host, cuda)
    assert brute_force.blocks_host(torch.zeros(2), cuda)
    assert not brute_force.blocks_host(host, cpu)
    assert not brute_force.blocks_host(torch.zeros(2), cpu)


@pytest.mark.parametrize("case", ENGINES, ids=ENGINE_IDS)
def test_each_wait_site_spans_and_counts(data, case, monkeypatch, tmp_path):
    """The CPU has no card to wait on, so the staging is made to count as a
    wait: each site's span opens inside ``.plan`` and its counter rises
    once a call, and the answers do not change."""
    family, filtered = case[1], case[3]
    d0, i0 = _search(data, case)
    monkeypatch.setattr(brute_force, "blocks_host", lambda x, device: True)
    before = _series("raft_tpu_host_sync_total")
    stats_before = _series("raft_tpu_span_seconds")
    with tracing.span_stats():
        d1, i1 = _search(data, case)
    assert torch.equal(d1, d0) and torch.equal(i1, i0)
    want = {(f"{family}.queries",): 1}
    if filtered:
        want[(f"{family}.filter",)] = 1
    assert _delta(before, _series("raft_tpu_host_sync_total")) == want
    waits = _delta(stats_before, _series("raft_tpu_span_seconds"))
    assert waits[(f"{family}.search.wait",)] == len(want)
    with tracing.profile(str(tmp_path)):
        _search(data, case)
    spans = _user_spans(tmp_path / "trace.json", family + ".search")
    plan = next(s for s in spans if s[0] == f"{family}.search.plan")
    wait = [s for s in spans if s[0] == f"{family}.search.wait"]
    assert len(wait) == len(want)
    assert all(plan[1] <= s <= e <= plan[2] for _, s, e in wait)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ENGINES, ids=ENGINE_IDS)
def test_no_host_wait_inside_a_search_on_the_card(card_data, case):
    """With the queries and the filter on the card, no engine blocks the
    host: under ``torch.cuda.set_sync_debug_mode("error")`` any
    synchronizing call (an ``.item()``, a ``.cpu()``, a blocking copy, a
    mask's ``nonzero``) raises. The ``.wait`` sites, the only waits the
    program counts, stay at 0; the kernels' own launches hold no copy or
    synchronize."""
    d0, i0 = _search(card_data, case)  # builds the kernels, warms the path
    torch.cuda.synchronize()
    before = _series("raft_tpu_host_sync_total")
    torch.cuda.set_sync_debug_mode("error")
    try:
        d1, i1 = _search(card_data, case)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(d1, d0) and torch.equal(i1, i0)
    assert _delta(before, _series("raft_tpu_host_sync_total")) == {}
    assert d1.device.type == "cuda"
