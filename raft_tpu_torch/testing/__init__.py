"""Test support shipped with the port: the comparison of two top-k results
(shared by the tests and chip_smoke.py), the fault injectors of the write
path and the serving device path (:mod:`raft_tpu_torch.testing.faults`) and
the seeded schedule amplifier of the concurrency tests
(:mod:`raft_tpu_torch.testing.interleave`); counterpart of
``raft_tpu.testing``."""

from __future__ import annotations

import numpy as np
import torch


def assert_topk_close(got, want, atol: float, rtol: float,
                      name: str = "top-k") -> dict:
    """Hold ``got = (values, ids)`` against ``want``, both [n, k]:

    - the same +inf pattern;
    - finite values within ``atol + rtol·|want|`` (sums taken in another
      order differ in the last bits);
    - the ids by tie runs of ``want``'s values: connected runs of
      neighbouring ranks whose gap is at most twice that tolerance (ranks
      within it of the k-th value are one run). A run that does not reach
      rank k holds the same ids in both, as a set. The run that does may
      continue past k: there the ids strictly better than the k-th value's
      tie level (further than twice the tolerance from it) in either
      result must be among the run's ids in the other, and the ids at the
      level may differ;
    - every id found in both rows at the same distance, within the same
      tolerance, at its rank in each (an id may move only within its tie
      run, never take another's distance).

    Raises AssertionError; returns ``{"max_abs_err", "id_agreement",
    "ids_differ"}``."""
    gv, gi = (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
              for t in got)
    wv, wi = (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
              for t in want)
    gv, wv = gv.to(torch.float32), wv.to(torch.float32).to(gv.device)
    gi, wi = gi.to(torch.int64), wi.to(torch.int64).to(gi.device)
    if gv.shape != wv.shape or gi.shape != wi.shape:
        raise AssertionError(f"{name}: shape {tuple(gv.shape)} != "
                             f"{tuple(wv.shape)}")
    finite = torch.isfinite(wv)
    if not torch.equal(finite, torch.isfinite(gv)):
        raise AssertionError(f"{name}: the +inf pattern differs")
    diff = torch.where(finite, (gv - wv).abs(), 0.0)
    max_err = float(diff.max()) if diff.numel() else 0.0
    tol = atol + rtol * torch.where(finite, wv.abs(), 0.0)
    if bool((diff > tol).any()):
        raise AssertionError(f"{name}: values differ by up to {max_err}")
    wvf = torch.where(finite, wv, torch.finfo(torch.float32).max)
    gap = (wvf[:, 1:] - wvf[:, :-1]).abs()  # descending for inner product
    boundary = (wvf - wvf[:, -1:]).abs() <= 2 * tol[:, -1:]
    link = ((gap <= 2 * torch.maximum(tol[:, 1:], tol[:, :-1]))
            | (boundary[:, 1:] & boundary[:, :-1]))
    run = torch.cat([torch.zeros_like(gi[:, :1]),
                     torch.cumsum((~link).to(torch.int64), 1)], 1)
    last = run == run[:, -1:]  # the run that reaches rank k
    alone = torch.ones_like(finite)  # a run of one rank
    alone[:, 1:] &= ~link
    alone[:, :-1] &= ~link
    differs = gi != wi
    if bool((differs & alone & ~last).any()):
        raise AssertionError(f"{name}: {int((differs & alone & ~last).sum())} "
                             "ids differ away from near-ties")
    for r in torch.nonzero(differs.any(dim=1)).flatten().tolist():
        g, w = gi[r].tolist(), wi[r].tolist()
        runs = run[r].tolist()
        core = (~boundary[r]).tolist()
        for rid in sorted(set(runs[c] for c in range(len(g)) if g[c] != w[c])):
            pos = [c for c in range(len(g)) if runs[c] == rid]
            gs, ws = {g[c] for c in pos}, {w[c] for c in pos}
            if rid != runs[-1]:
                ok = gs == ws
            else:
                ok = ({w[c] for c in pos if core[c]} <= gs
                      and {g[c] for c in pos if core[c]} <= ws)
            if not ok:
                raise AssertionError(f"{name}: row {r} differs in a near-tie "
                                     "run")
    _hold_shared_ids(gv, gi, wv, wi, finite, tol, name)
    return {"max_abs_err": max_err,
            "id_agreement": float((~differs).to(torch.float32).mean()),
            "ids_differ": int(differs.sum())}


def _hold_shared_ids(gv, gi, wv, wi, finite, tol, name: str) -> None:
    """Each id present in both rows (finite, not negative): at each of its
    ranks in one result, the other holds it at a distance within ``tol``
    (ids may repeat in a row, as in lists with shared ids). Rows are taken
    in blocks of about 2^22 id pairs."""
    n, k = gi.shape
    step = max(1, (1 << 22) // max(k * k, 1))
    for r0 in range(0, n, step):
        sl = slice(r0, r0 + step)
        g_ok = finite[sl] & (gi[sl] >= 0)
        w_ok = finite[sl] & (wi[sl] >= 0)
        same = ((gi[sl, :, None] == wi[sl, None, :])
                & g_ok[:, :, None] & w_ok[:, None, :])
        near = same & ((gv[sl, :, None] - wv[sl, None, :]).abs()
                       <= tol[sl, None, :])
        for side, (has, hit) in enumerate(((same.any(2), near.any(2)),
                                           (same.any(1), near.any(1)))):
            bad = has & ~hit
            if bool(bad.any()):
                r, c = (int(t[0]) for t in torch.nonzero(bad, as_tuple=True))
                ids, at = (gi, gv) if side == 0 else (wi, wv)
                raise AssertionError(
                    f"{name}: row {r0 + r}: id {int(ids[r0 + r, c])} at "
                    f"{float(at[r0 + r, c])} in {('got', 'want')[side]}, "
                    "not within tolerance in the other")


from raft_tpu_torch.testing import faults, interleave  # noqa: E402,F401
