"""Batch search: one caller in a closed loop over a pool of queries.

The index is the configuration's dataset built with its seed, the same in
every run, as a deployment serves one index. The mix gives ``batch``
(queries a call), ``pool`` (queries drawn from the run's seed out of the
dataset's distribution; the pool's ``pool // batch`` batches are searched
in turn),
``k``, ``filter_removed`` (the share of row ids a ``Bitset`` removes, drawn
from the seed and fixed for the run; 0 for none), ``judged_rows`` (rows of
each batch whose answers are judged in every call) and ``state_rows``
(rows whose list and codes are judged). Each call is timed from the call
until its distances and ids are on the host, as a raft-ann-bench
throughput run or an offline job calls an index. A traced run first runs
the window once without the profiler, for the host's own times.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vsbench import datagen
from vsbench.reference.build import BuildReference
from vsbench.reference.ivf import IvfReference, search_tf32


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run:
    def __init__(self, cell, family, seed: int, device: torch.device):
        self.cell, self.family, self.seed, self.dev = cell, family, seed, \
            device
        self.cfg, self.mix = cell.config, cell.traffic
        self.k = int(self.mix["k"])
        self.attempted = self.failed = self.n_steps = 0
        self.control_answers = None
        self.phases: Dict[str, float] = {}
        self.untraced_returned: List[float] = []

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        cfg, mix, dev = self.cfg, self.mix, self.dev
        n, b, dim = int(cfg["n_rows"]), int(mix["batch"]), int(cfg["dim"])
        t0 = time.perf_counter()
        # the deployment's rows and index are the same in every run; the
        # seed draws the queries, the filter and the judged samples
        self.rows = datagen.dataset(cfg["data"], n, dim, dev)
        pool = datagen.dataset(cfg["data"], int(mix["pool"]), dim, dev,
                               seed=self.seed)
        gen = datagen.generator(self.seed, dev)
        self.batches = [pool[i * b:(i + 1) * b]
                        for i in range(int(mix["pool"]) // b)]
        self.keep = None
        removed = int(float(mix["filter_removed"]) * n)
        if removed:
            self.keep = torch.ones(n, dtype=torch.bool, device=dev)
            self.keep[torch.randperm(n, generator=gen, device=dev)[:removed]] \
                = False
        judged = torch.randperm(b, generator=gen, device=dev)
        self.judged = torch.sort(judged[:int(mix["judged_rows"])]).values.cpu()
        self.state_sample = torch.randperm(
            n, generator=gen, device=dev)[:int(mix["state_rows"])]
        _sync(dev)
        t1 = time.perf_counter()
        self.index = self.family.build(self.rows, cfg,
                                       cfg["data"]["dataset_seed"])
        _sync(dev)
        t2 = time.perf_counter()
        self.search = self.family.searcher(self.index, cfg, self.k, self.keep)
        for q in self.batches:  # every shape and list the window meets
            d, i = self.search(q)
            d.cpu(), i.cpu()
        self.phases = {"data": t1 - t0, "build": t2 - t1,
                       "warm": time.perf_counter() - t2}

    # ------------------------------------------------------------ window

    def window(self, seconds: float, tracer) -> None:
        self.latency: List[float] = []
        self.returned: List[float] = []
        self.kept: List[Tuple[int, torch.Tensor, torch.Tensor]] = []
        nb = len(self.batches)
        step = 0
        start = time.perf_counter()
        while True:
            b = step % nb
            with tracer.span("batch.call"):
                t0 = time.perf_counter()
                d, i = self.search(self.batches[b])
                t1 = time.perf_counter()
            with tracer.span("batch.readback"):
                d_h, i_h = d.cpu(), i.cpu()
                t2 = time.perf_counter()
            self.latency.append(t2 - t0)
            self.returned.append(t1 - t0)
            self.kept.append((b, d_h[self.judged], i_h[self.judged]))
            step += 1
            if t2 - start >= seconds:
                break
        self.window_s = t2 - start
        self.n_steps = step
        self.attempted = step * self.batches[0].shape[0]
        if not tracer.enabled:
            self.untraced_returned = list(self.returned)

    def end_to_end(self) -> Dict[str, Tuple[float, str]]:
        return {"qps": (self.attempted / self.window_s, "queries/s"),
                "p95_ms": (1e3 * float(np.percentile(self.latency, 95)),
                           "ms")}

    def return_ms(self) -> Optional[float]:
        """Mean host ms from the search call to its return, over a window
        run without the profiler."""
        if not self.untraced_returned:
            return None
        return 1e3 * float(np.mean(self.untraced_returned))

    # ----------------------------------------------- after the window

    def release(self, control: bool = False) -> None:
        """Copy the index's state for the reference and free the index
        (``control``: first take the program's own lower-precision answers
        to the judged queries, where the configuration names such a
        search)."""
        if control and "control_search" in self.cfg:
            search = self.family.searcher(self.index, self.cfg, self.k,
                                          self.keep, control=True)
            answers = [search(q) for q in self.batches]
            self.control_answers = (
                torch.cat([d.cpu()[self.judged] for d, _ in answers]),
                torch.cat([i.cpu()[self.judged] for _, i in answers]))
        self.state = self.family.state(self.index)
        del self.index, self.search
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def work(self, kernel: str) -> Optional[Tuple[int, int]]:
        """(bytes, operations) of ``kernel`` over every call the window
        made."""
        runs = np.bincount([b for b, _, _ in self.kept],
                           minlength=len(self.batches))
        total = [0, 0]
        for b, q in enumerate(self.batches):
            if runs[b] == 0:
                continue
            w = self.family.work(kernel, self.state, q, self.cfg, self.k)
            if w is None:
                return None
            total[0] += int(runs[b]) * w[0]
            total[1] += int(runs[b]) * w[1]
        return total[0], total[1]

    def _reference(self) -> IvfReference:
        ref = IvfReference(self.rows, self.keep, self.state,
                           int(self.cfg["search"]["n_probes"]), self.k)
        ref.prepare(torch.cat([q[self.judged.to(self.dev)]
                               for q in self.batches]))
        return ref

    def judge(self) -> Dict[str, float]:
        """The numbers compared: every call's answers to the judged rows
        against the reference, the index's state on a sample, and the
        quality of its centres (and codebooks) against the reference's own
        build."""
        self.ref = ref = self._reference()
        s = len(self.judged)
        out = {"answers": 0, "invalid": 0, "dist_gap": 0.0, "rank_gap": 0.0}
        hits = 0.0
        for c0 in range(0, len(self.kept), 16):
            chunk = self.kept[c0:c0 + 16]
            u = torch.cat([b * s + torch.arange(s) for b, _, _ in chunk])
            r = ref.judge(u, torch.cat([d for _, d, _ in chunk]),
                          torch.cat([i for _, _, i in chunk]))
            out["answers"] += r["answers"]
            out["invalid"] += r["invalid"]
            out["dist_gap"] = max(out["dist_gap"], r["dist_gap"])
            out["rank_gap"] = max(out["rank_gap"], r["rank_gap"])
            hits += r["recall"] * r["answers"]
        out["recall"] = hits / max(out["answers"], 1)
        out.update(ref.state_gaps(self.state_sample))
        out["ids_once"] = ref.ids_once
        own = BuildReference(self.rows, self.cfg["index"], self.seed)
        out["kmeans_excess"] = own.kmeans_excess(self.state["centers"])
        if ref.pq:
            out["pq_excess"] = own.pq_excess(*ref.pq_errors(
                self.state_sample))
        return out

    def control(self) -> Dict[str, float]:
        """The control's numbers: the answers of the program's own
        lower-precision search where the configuration names one, else
        of the reference's search with TF32 products, put in the program's
        place; and the assignment and encoding with TF32 products."""
        ref = self.ref
        u = torch.arange(len(self.batches) * len(self.judged))
        if self.control_answers is not None:
            d, i = self.control_answers
        else:
            d, i = search_tf32(ref, torch.cat(
                [q[self.judged.to(self.dev)] for q in self.batches]),
                self.k, int(self.cfg["search"]["n_probes"]))
        out = ref.judge(u, d, i)
        labels, codes = ref.state_tf32(self.state_sample)
        out.update(ref.state_gaps(self.state_sample, labels, codes))
        return out
