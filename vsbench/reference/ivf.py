"""Plain reference of an IVF search, in float64, to judge the program by.

Plain PyTorch only: nothing here imports the program. The reference takes
the cell's rows, filter and queries, which the benchmark made, and the
state of the program's index (its centres, the row ids of each list, and
for IVF-PQ the rotation, codebooks and packed codes) as raw tensors. It
works out again from them what the program derived (each row's list, each
IVF-PQ row's reconstruction) and judges the program's answers:

- ``invalid``: answers with an id out of range, repeated, filtered out,
  or with a distance that is not finite or not in ascending order;
- ``dist_gap``: the widest gap between a returned distance and the float64
  distance of its id (IVF-PQ: the asymmetric distance to the row's
  reconstruction), over ``|q|² + |x|²``, the scale of the rounding of an
  expanded fp32 distance;
- ``rank_gap``: the widest amount by which the j-th returned row lies
  further than the j-th nearest row of the lists the query probes (the
  lists nearest it by float64), over ``|q|² + |x|²``. Queries whose last
  probed and first unprobed lists lie within ``AMBIGUOUS`` of each other
  are left out: fp32 may probe either;
- ``recall``: the share of the true 10 nearest allowed rows (float64, over
  all rows) that the answers hold;
- ``assign_gap``: on a sample of rows, the widest amount by which a row's
  list centre lies further than its nearest centre;
- ``code_gap`` (IVF-PQ): on the same rows, the widest amount by which a
  subspace's code lies further from the rotated residual than its nearest
  codebook entry;
- ``ids_once``: the number of row ids that the lists miss or hold twice.

These follow the program's own state; whether its centres and codebooks
were trained well is judged apart, against the reference's own build
(``vsbench/reference/build.py``).

``search_tf32`` is the control: the same search computed with TF32
rounding of the products' inputs, put in the program's place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

#: relative distance below which the last probed and the first unprobed
#: list count as tied: fp32 rounds about 1e-7 of ``|q|² + |c|²``
AMBIGUOUS = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    to even), as the tensor cores round a TF32 product's inputs."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def unpack_codes(code_bytes: torch.Tensor, pq_dim: int,
                 pq_bits: int) -> torch.Tensor:
    """[n, pq_dim·pq_bits/8] uint8, codes packed little-endian bit by bit
    → [n, pq_dim] int64."""
    shifts = torch.arange(8, device=code_bytes.device)
    bits = (code_bytes.to(torch.int64)[..., None] >> shifts) & 1
    bits = bits.reshape(code_bytes.shape[0], pq_dim, pq_bits)
    weights = 1 << torch.arange(pq_bits, device=code_bytes.device)
    return (bits * weights).sum(-1)


class no_tf32:
    """Keep a float32 product in float32 on the card (PyTorch may take
    TF32 for it where ``allow_tf32`` is set)."""

    def __enter__(self):
        self._saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._saved


class IvfReference:
    """The reference of one index: ``state`` holds ``centers`` [L, D],
    ``list_ids`` [L, pad] (-1 unused), ``list_sizes`` [L],
    ``overflow_ids`` [O] (rows every query scans); for IVF-PQ also
    ``rotation`` [R, D], ``codebooks`` [pq_dim, book, pq_len],
    ``list_codes`` [L, pad, bytes], ``overflow_codes``, ``overflow_labels``
    and ``pq_bits``."""

    def __init__(self, rows: torch.Tensor, keep: Optional[torch.Tensor],
                 state: Dict[str, torch.Tensor], n_probes: int, k: int,
                 block: int = 256):
        dev = rows.device
        self.n, self.k, self.n_probes, self.block = rows.shape[0], k, \
            n_probes, block
        self.rows = rows
        self.keep = (keep if keep is not None
                     else torch.ones(self.n, dtype=torch.bool, device=dev))
        self.centers = state["centers"].to(dev, torch.float64)
        n_lists = self.centers.shape[0]
        # each row's list (n_lists: the overflow block, always scanned;
        # -1: in no list) and the ids the lists miss or repeat
        sizes = state["list_sizes"].to(dev, torch.int64)
        ids = state["list_ids"].to(dev, torch.int64)
        filled = (torch.arange(ids.shape[1], device=dev)[None, :]
                  < sizes[:, None]) & (ids >= 0)
        lists = torch.arange(n_lists, device=dev)[:, None].expand_as(ids)
        over = state["overflow_ids"].to(dev, torch.int64)
        all_ids = torch.cat([ids[filled], over[over >= 0]])
        in_range = (all_ids >= 0) & (all_ids < self.n)
        counts = torch.bincount(all_ids[in_range], minlength=self.n)
        self.ids_once = int((counts != 1).sum() + (~in_range).sum())
        self.row_list = torch.full((self.n,), -1, dtype=torch.int64,
                                   device=dev)
        self.row_list[ids[filled].clamp(0, self.n - 1)] = lists[filled]
        self.row_list[over[over >= 0].clamp(0, self.n - 1)] = n_lists
        self.pq = "codebooks" in state
        if self.pq:
            self._init_pq(state, ids, filled, over)
        else:
            self.space = rows.to(torch.float64)
            self.space_centers = self.centers

    def _init_pq(self, state, ids, filled, over) -> None:
        """Each row's reconstruction in the rotated space: its list's
        rotated centre plus the codebook entries of its codes."""
        dev = self.rows.device
        self.rotation = state["rotation"].to(dev, torch.float64)
        self.codebooks = state["codebooks"].to(dev, torch.float64)
        pq_dim, _, pq_len = self.codebooks.shape
        bits = int(state["pq_bits"])
        n_bytes = state["list_codes"].shape[-1]
        codes = torch.zeros((self.n, pq_dim), dtype=torch.int64, device=dev)
        labels = torch.full((self.n,), -1, dtype=torch.int64, device=dev)
        lists = torch.arange(ids.shape[0], device=dev)[:, None].expand_as(ids)
        rows_in = ids[filled].clamp(0, self.n - 1)
        codes[rows_in] = unpack_codes(
            state["list_codes"].to(dev)[filled].reshape(-1, n_bytes),
            pq_dim, bits)
        labels[rows_in] = lists[filled]
        o_ok = over >= 0
        if bool(o_ok.any()):
            o_rows = over[o_ok].clamp(0, self.n - 1)
            codes[o_rows] = unpack_codes(
                state["overflow_codes"].to(dev)[o_ok], pq_dim, bits)
            labels[o_rows] = state["overflow_labels"].to(
                dev, torch.int64)[o_ok]
        self.codes, self.labels = codes, labels
        self.space_centers = self.centers @ self.rotation.T
        parts = self.codebooks[torch.arange(pq_dim, device=dev)[None, :],
                               codes]  # [n, pq_dim, pq_len]
        self.space = (self.space_centers[labels.clamp_min(0)]
                      + parts.reshape(self.n, pq_dim * pq_len))

    # ----------------------------------------------------------- queries

    def prepare(self, queries: torch.Tensor) -> None:
        """The reference's answers for ``queries`` [U, D]: the true k
        nearest allowed rows, and the k nearest distances over the probed
        lists in the index's space, with each query's ambiguity."""
        dev = self.rows.device
        q64 = queries.to(dev, torch.float64)
        sq = q64 @ self.rotation.T if self.pq else q64
        self.q_space = sq
        exact, probed_d, probed_scale, ambiguous = [], [], [], []
        rows64 = self.rows.to(torch.float64)
        rn = (rows64 * rows64).sum(1)
        sn = (self.space * self.space).sum(1)
        cn = (self.space_centers * self.space_centers).sum(1)
        in_index = self.row_list >= 0
        for b0 in range(0, q64.shape[0], self.block):
            qb, sb = q64[b0:b0 + self.block], sq[b0:b0 + self.block]
            d = (qb * qb).sum(1)[:, None] - 2.0 * (qb @ rows64.T) + rn[None]
            d = d.masked_fill(~self.keep[None], torch.inf)
            exact.append(torch.topk(d, self.k, dim=1, largest=False).indices)
            del d
            sbn = (sb * sb).sum(1)
            dc = sbn[:, None] - 2.0 * (sb @ self.space_centers.T) + cn[None]
            srt = torch.sort(dc, dim=1).values
            scale_c = sbn + cn.max()
            gap = srt[:, self.n_probes] - srt[:, self.n_probes - 1]
            ambiguous.append(gap < AMBIGUOUS * scale_c)
            probes = torch.topk(dc, self.n_probes, dim=1,
                                largest=False).indices
            hit = torch.zeros((sb.shape[0], self.centers.shape[0] + 1),
                              dtype=torch.bool, device=dev)
            hit.scatter_(1, probes, True)
            hit[:, -1] = True
            probed = hit.gather(1, self.row_list.clamp_min(0)[None].expand(
                sb.shape[0], -1)) & in_index[None] & self.keep[None]
            ds = sbn[:, None] - 2.0 * (sb @ self.space.T) + sn[None]
            ds = ds.masked_fill(~probed, torch.inf)
            top = torch.topk(ds, self.k, dim=1, largest=False)
            probed_d.append(top.values)
            probed_scale.append(sbn + sn[top.indices].max(1).values)
            del ds, probed
        self.exact = torch.cat(exact)
        self.probed_d = torch.cat(probed_d)
        self.probed_scale = torch.cat(probed_scale)
        self.ambiguous = torch.cat(ambiguous)

    def judge(self, u: torch.Tensor, ans_d: torch.Tensor,
              ans_i: torch.Tensor) -> Dict[str, float]:
        """Judge answers [m, k] (distances, ids) to prepared queries ``u``
        [m]. Returns invalid, dist_gap, rank_gap, recall and the answer
        count."""
        dev = self.rows.device
        u = u.to(dev)
        ans_d = ans_d.to(dev, torch.float64)
        ans_i = ans_i.to(dev, torch.int64)
        out_of_range = (ans_i < 0) | (ans_i >= self.n)
        ids = ans_i.clamp(0, self.n - 1)
        srt = torch.sort(ids, dim=1).values
        repeated = (srt[:, 1:] == srt[:, :-1]).any(1)
        bad = (out_of_range.any(1) | repeated | (~self.keep[ids]).any(1)
               | (~torch.isfinite(ans_d)).any(1)
               | (ans_d[:, 1:] < ans_d[:, :-1]).any(1))
        ok = ~bad
        result = {"answers": int(u.shape[0]), "invalid": int(bad.sum()),
                  "dist_gap": 0.0, "rank_gap": 0.0, "recall": 0.0}
        if not bool(ok.any()):
            return result
        u, ids, ans_d = u[ok], ids[ok], ans_d[ok]
        qs = self.q_space[u]
        x = self.space[ids]  # [m, k, R]
        d64 = ((qs[:, None, :] - x) ** 2).sum(-1)
        scale = (qs * qs).sum(1)[:, None] + (x * x).sum(-1)
        result["dist_gap"] = float(((ans_d - d64).abs() / scale).max())
        clear = ~self.ambiguous[u]
        if bool(clear.any()):
            g = (d64 - self.probed_d[u]) / self.probed_scale[u][:, None]
            result["rank_gap"] = max(float(g[clear].max()), 0.0)
        hits = (ids[:, :, None] == self.exact[u][:, None, :]).any(-1)
        # recall over every judged answer, an invalid one holding none
        result["recall"] = float(hits.sum()) / (self.k * result["answers"])
        return result

    # ------------------------------------------------------------- state

    def state_gaps(self, sample: torch.Tensor,
                   labels: Optional[torch.Tensor] = None,
                   codes: Optional[torch.Tensor] = None,
                   block: int = 2048) -> Dict[str, float]:
        """assign_gap (and code_gap) on the rows ``sample`` of the index;
        ``labels``/``codes`` [len(sample)] put another assignment and
        encoding in the program's place (the control)."""
        dev = self.rows.device
        sample = sample.to(dev)
        own = self.labels[sample] if self.pq else self.row_list[sample]
        labels = own if labels is None else labels.to(dev, torch.int64)
        listed = (labels >= 0) & (labels < self.centers.shape[0])
        if self.pq:
            codes = (self.codes[sample] if codes is None
                     else codes.to(dev, torch.int64))[listed]
        sample, labels = sample[listed], labels[listed]
        cn = (self.centers * self.centers).sum(1)
        gaps = {"assign_gap": 0.0}
        if self.pq:
            gaps["code_gap"] = 0.0
            pq_dim, book, pq_len = self.codebooks.shape
            cb_n = (self.codebooks ** 2).sum(-1)  # [pq_dim, book]
            sub = torch.arange(pq_dim, device=dev)[None]
        for b0 in range(0, sample.shape[0], block):
            lb = labels[b0:b0 + block]
            x = self.rows[sample[b0:b0 + block]].to(torch.float64)
            xn = (x * x).sum(1)
            d = xn[:, None] - 2.0 * (x @ self.centers.T) + cn[None]
            mine = d.gather(1, lb[:, None])[:, 0]
            gaps["assign_gap"] = max(gaps["assign_gap"], float(
                ((mine - d.min(1).values) / (xn + cn[lb])).max()))
            if not self.pq:
                continue
            cb = codes[b0:b0 + block]
            r = ((x - self.centers[lb]) @ self.rotation.T).reshape(
                -1, pq_dim, pq_len)
            dist = ((r[:, :, None, :] - self.codebooks[None]) ** 2).sum(-1)
            chosen = dist.gather(2, cb[:, :, None])[:, :, 0]
            gaps["code_gap"] = max(gaps["code_gap"], float(
                ((chosen - dist.min(2).values)
                 / ((r * r).sum(-1) + cb_n[sub, cb])).max()))
        return gaps

    def pq_errors(self, sample: torch.Tensor):
        """(rows, errors): the rows of ``sample`` that the index holds, and
        the squared error of the program's reconstruction of each (IVF-PQ:
        the rotated row less its list's rotated centre and code entries)."""
        sample = sample.to(self.rows.device)
        sample = sample[self.labels[sample] >= 0]
        x = self.rows[sample].to(torch.float64) @ self.rotation.T
        return sample, ((x - self.space[sample]) ** 2).sum(1)

    def state_tf32(self, sample: torch.Tensor, block: int = 2048):
        """(labels, codes) of the rows ``sample`` worked out with TF32
        products from the index's centres and codebooks: the control of
        the build's assignment and encoding (codes None for IVF-Flat)."""
        dev = self.rows.device
        sample = sample.to(dev)
        c = self.centers.to(torch.float32)
        cn = (c * c).sum(1)
        labels, codes = [], []
        if self.pq:
            pq_dim, book, pq_len = self.codebooks.shape
            rot = tf32(self.rotation.to(torch.float32))
            cb = self.codebooks.to(torch.float32)
            cb_n = (cb * cb).sum(-1)
        with no_tf32():
            for b0 in range(0, sample.shape[0], block):
                x = self.rows[sample[b0:b0 + block]].to(torch.float32)
                d = cn[None] - 2.0 * (tf32(x) @ tf32(c).T)
                lb = d.argmin(1)
                labels.append(lb)
                if self.pq:
                    r = (tf32(x - c[lb]) @ rot.T).reshape(-1, pq_dim, pq_len)
                    dd = cb_n[None] - 2.0 * torch.einsum(
                        "nsl,sbl->nsb", tf32(r), tf32(cb))
                    codes.append(dd.argmin(2))
        return torch.cat(labels), (torch.cat(codes) if self.pq else None)


def search_tf32(ref: IvfReference, queries: torch.Tensor, k: int,
                n_probes: int):
    """The control: an IVF-Flat search over the index's lists with TF32
    rounding of every product's inputs, in fp32 → (distances, ids) [U, k]."""
    dev = ref.rows.device
    q = queries.to(dev, torch.float32)
    rows = ref.rows.to(torch.float32)
    c = ref.centers.to(torch.float32)
    rn, cn = (rows * rows).sum(1), (c * c).sum(1)
    in_index = ref.row_list >= 0
    out_d, out_i = [], []
    with no_tf32():
        for b0 in range(0, q.shape[0], ref.block):
            qb = q[b0:b0 + ref.block]
            qn = (qb * qb).sum(1)
            dc = qn[:, None] - 2.0 * (tf32(qb) @ tf32(c).T) + cn[None]
            probes = torch.topk(dc, n_probes, dim=1, largest=False).indices
            hit = torch.zeros((qb.shape[0], c.shape[0] + 1),
                              dtype=torch.bool, device=dev)
            hit.scatter_(1, probes, True)
            hit[:, -1] = True
            probed = hit.gather(1, ref.row_list.clamp_min(0)[None].expand(
                qb.shape[0], -1)) & in_index[None] & ref.keep[None]
            d = qn[:, None] - 2.0 * (tf32(qb) @ tf32(rows).T) + rn[None]
            d = d.masked_fill(~probed, torch.inf)
            top = torch.topk(d, k, dim=1, largest=False)
            out_d.append(top.values)
            out_i.append(top.indices)
    return torch.cat(out_d), torch.cat(out_i)
