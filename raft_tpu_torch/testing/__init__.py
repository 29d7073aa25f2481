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
    - equal ids wherever the value is further than twice that tolerance
      from its neighbouring ranks and from the k-th value; near-tied ranks
      are compared as sets per row, except the group tied with the k-th
      value, which may continue past k.

    Raises AssertionError; returns ``{"max_abs_err", "id_agreement"}``."""
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
    tied = torch.zeros_like(finite)
    tied[:, 1:] |= gap <= 2 * tol[:, 1:]
    tied[:, :-1] |= gap <= 2 * tol[:, :-1]
    boundary = (wvf - wvf[:, -1:]).abs() <= 2 * tol[:, -1:]
    bad = (gi != wi) & ~tied & ~boundary
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} ids differ away from "
                             "near-ties")
    inner = tied & ~boundary
    for r in torch.nonzero(((gi != wi) & inner).any(dim=1)).flatten().tolist():
        if sorted(gi[r][inner[r]].tolist()) != sorted(wi[r][inner[r]].tolist()):
            raise AssertionError(f"{name}: row {r} differs in a near-tie group")
    return {"max_abs_err": max_err,
            "id_agreement": float((gi == wi).to(torch.float32).mean())}


from raft_tpu_torch.testing import faults, interleave  # noqa: E402,F401
