"""``correct`` on the CPU at a tiny size: sound runs pass, each fault the
cells can have fails them, and so does the control.

The harness's look for a card is skipped (``execute`` on the CPU, where the
port runs its kernels' plain versions); the rest of a run is driven with
the timed path broken underneath it. The faults: a search that returns
its state unchanged (the previous call's answers), half of the batch left
out, an answer altered where it is produced; for the build, half of the
rows left out, the codes altered, and centres or codebooks never trained
(``vsbench/faults.py``). One chip: no exchange between chips to leave out.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from vsbench.faults import planted
from vsbench.run import execute, load_cell

SEARCH_CELLS = {"tiny-ivf_flat.batch": ivf_flat,
                "tiny-ivf_flat.filtered": ivf_flat,
                "tiny-ivf_pq.batch": ivf_pq}


def _run(root, cell, control=False):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return execute(load_cell(root, cell), bench, 2**31 + 11, 0.2, False,
                   "cpu", time.perf_counter(), control=control)


@pytest.mark.parametrize("cell", list(SEARCH_CELLS))
def test_a_sound_run_is_correct(tiny_root, cell):
    result = _run(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def _stale(search):
    first = {}

    def call(index, q, *a, **kw):
        out = search(index, q, *a, **kw)
        return first.setdefault("out", out)
    return call


def _half(search):
    def call(index, q, *a, **kw):
        d, i = search(index, q, *a, **kw)
        d, i = d.clone(), i.clone()
        d[d.shape[0] // 2:], i[i.shape[0] // 2:] = torch.inf, -1
        return d, i
    return call


def _altered(search):
    def call(index, q, *a, **kw):
        d, i = search(index, q, *a, **kw)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % index.n_rows
        return d, i
    return call


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("cell", list(SEARCH_CELLS))
def test_a_fault_in_the_search_is_not_correct(tiny_root, monkeypatch, cell,
                                               fault):
    module = SEARCH_CELLS[cell]
    monkeypatch.setattr(module, "search", fault(module.search))
    result = _run(tiny_root, cell)
    assert not result["correct"]


def _build_half(build):
    def call(dataset, *a, **kw):
        return build(dataset[:dataset.shape[0] // 2], *a, **kw)
    return call


def _codes_altered(build):
    def call(*a, **kw):
        index = build(*a, **kw)
        index.list_codes = index.list_codes ^ 1
        return index
    return call


@pytest.mark.parametrize("cell,fault", [
    ("tiny-ivf_flat.batch", _build_half), ("tiny-ivf_pq.batch", _build_half),
    ("tiny-ivf_pq.batch", _codes_altered)])
def test_a_fault_in_the_build_is_not_correct(tiny_root, monkeypatch, cell,
                                             fault):
    module = SEARCH_CELLS[cell]
    monkeypatch.setattr(module, "build", fault(module.build))
    result = _run(tiny_root, cell)
    assert not result["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-ivf_flat.batch", "coarse_untrained"),
    ("tiny-ivf_flat.filtered", "coarse_untrained"),
    ("tiny-ivf_pq.batch", "coarse_untrained"),
    ("tiny-ivf_pq.batch", "codebooks_untrained")])
def test_an_untrained_build_is_not_correct(tiny_root, cell, fault):
    """Centres or codebooks left at their start pass every check that
    follows the program's own state, and fail the build's quality."""
    with planted(fault):
        result = _run(tiny_root, cell)
    failed = {k for k, c in result["checks"].items() if not c["ok"]}
    assert failed & {"kmeans_excess", "pq_excess"}, result["checks"]


@pytest.mark.parametrize("cell", list(SEARCH_CELLS))
def test_the_control_is_not_correct(tiny_root, cell):
    """The control (TF32 products, or the program's bf16 LUT) in the
    program's place fails a limit that the program meets."""
    result = _run(tiny_root, cell, control=True)
    assert result["correct"]
    failed = [k for k, c in result["control"].items() if not c["ok"]]
    assert failed, result["control"]
