"""Plain reference of an IVF build, in float64, to judge the quality of the
program's centres and codebooks by.

Plain PyTorch only: nothing here imports the program or takes a table the
program made. From the cell's rows the reference trains its own index the
plain way, as the configuration states it: Lloyd's k-means of
``n_lists`` centres over a trainset of ``kmeans_trainset_fraction`` of the
rows, started from distinct random rows and run ``kmeans_n_iters`` times;
for IVF-PQ the residuals to those centres (in no rotation: the
configurations ask for none, and ``pq_dim`` divides their width) and a
codebook of ``2**pq_bits`` entries a subspace, trained the same way. Its
draws come from the run's seed. The numbers:

- ``kmeans_excess``: the program's k-means objective (the mean squared
  distance of every row to its nearest centre) over the reference's, less
  one;
- ``pq_excess``: the mean squared error of the program's reconstruction of
  a sample of rows over that of the reference's own encoding, less one.

A build whose centres or codebooks were never trained reads far above a
sound one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _budget_rows(device: torch.device, width: int) -> int:
    """Rows a block of float64 [rows, width] distances may hold: 1 GiB on
    a card, 64 MiB on the host."""
    budget = (1 << 30) if device.type == "cuda" else (1 << 26)
    return max(1, budget // (8 * width))


def nearest(x: torch.Tensor, centers: torch.Tensor) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """(labels [n], squared distances [n]) of each row of ``x`` to its
    nearest centre, in float64."""
    cn = (centers * centers).sum(1)
    labels, dist = [], []
    step = _budget_rows(x.device, centers.shape[0])
    for r0 in range(0, x.shape[0], step):
        xb = x[r0:r0 + step].to(torch.float64)
        d = cn[None] - 2.0 * (xb @ centers.T)
        best = d.min(1)
        labels.append(best.indices)
        dist.append((best.values + (xb * xb).sum(1)).clamp_min(0.0))
    return torch.cat(labels), torch.cat(dist)


def lloyd(gen: torch.Generator, x: torch.Tensor, k: int,
          n_iters: int) -> torch.Tensor:
    """Lloyd's k-means of ``x`` [n, d] float64 from ``k`` distinct random
    rows; an empty cluster takes a random row → centres [k, d]."""
    n = x.shape[0]
    dev = x.device
    centers = x[torch.randperm(n, generator=gen, device=dev)[:k]].clone()
    donors = torch.randint(0, n, (n_iters, k), generator=gen, device=dev)
    for it in range(n_iters):
        labels, _ = nearest(x, centers)
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        new = sums / counts.clamp_min(1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, x[donors[it]])
    return centers


def subspace_nearest(sub: torch.Tensor,
                     books: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(codes [S, n], squared errors [S, n]) of each subvector of ``sub``
    [S, n, l] at its subspace's nearest entry of ``books`` [S, book, l]."""
    bn = (books * books).sum(-1)  # [S, book]
    codes, errs = [], []
    step = _budget_rows(sub.device, books.shape[0] * books.shape[1])
    for r0 in range(0, sub.shape[1], step):
        sb = sub[:, r0:r0 + step]
        d = bn[:, None, :] - 2.0 * torch.bmm(sb, books.transpose(1, 2))
        best = d.min(2)
        codes.append(best.indices)
        errs.append((best.values + (sb * sb).sum(-1)).clamp_min(0.0))
    return torch.cat(codes, 1), torch.cat(errs, 1)


def train_codebooks(gen: torch.Generator, sub: torch.Tensor, book: int,
                    n_iters: int) -> torch.Tensor:
    """Lloyd's k-means of every subspace of ``sub`` [S, n, l] float64 at
    once, each from ``book`` distinct random subvectors → [S, book, l]."""
    s, n, l = sub.shape
    dev = sub.device
    keys = torch.rand((s, n), generator=gen, device=dev)
    start = torch.topk(keys, min(book, n), dim=1).indices
    start = start.repeat(1, -(-book // start.shape[1]))[:, :book]
    rows_s = torch.arange(s, device=dev)[:, None]
    books = sub[rows_s, start].clone()
    donors = torch.randint(0, n, (n_iters, s, book), generator=gen,
                           device=dev)
    flat_sub = sub.reshape(s * n, l)
    base = (torch.arange(s, device=dev) * book)[:, None]
    for it in range(n_iters):
        codes, _ = subspace_nearest(sub, books)
        flat = (codes + base).reshape(-1)
        sums = torch.zeros((s * book, l), dtype=sub.dtype,
                           device=dev).index_add_(0, flat, flat_sub)
        counts = torch.bincount(flat, minlength=s * book).to(sub.dtype)
        new = (sums / counts.clamp_min(1.0)[:, None]).reshape(s, book, l)
        empty = (counts == 0).reshape(s, book)
        books = torch.where(empty[:, :, None], sub[rows_s, donors[it]], new)
    return books


class BuildReference:
    """The reference's own index of ``rows`` under the configuration's
    ``index`` parameters (``pq_dim`` and ``pq_bits`` for IVF-PQ), trained
    from ``seed``."""

    def __init__(self, rows: torch.Tensor, index: dict, seed: int):
        dev = rows.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) % (1 << 64))
        self.rows = rows
        n, dim = rows.shape
        n_lists = int(index["n_lists"])
        n_iters = int(index.get("kmeans_n_iters", 20))
        n_train = min(max(int(n * float(index.get(
            "kmeans_trainset_fraction", 0.5))), n_lists), n)
        train = rows[torch.randperm(n, generator=gen, device=dev)[:n_train]]
        train = train.to(torch.float64)
        self.centers = lloyd(gen, train, n_lists, n_iters)
        self.objective = float(nearest(rows, self.centers)[1].mean())
        self.books: Optional[torch.Tensor] = None
        if "pq_dim" not in index:
            return
        pq_dim = int(index["pq_dim"])
        if dim % pq_dim or index.get("force_random_rotation", False):
            raise ValueError("the reference's IVF-PQ has no rotation: "
                             "pq_dim must divide the width")
        self.pq_len = dim // pq_dim
        labels, _ = nearest(train, self.centers)
        self.books = train_codebooks(
            gen, self._subvectors(train, labels), 1 << int(index["pq_bits"]),
            n_iters)

    def _subvectors(self, x: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
        """Residuals of ``x`` float64 to ``labels``' centres, as
        [pq_dim, n, pq_len]."""
        r = x - self.centers[labels]
        return r.reshape(x.shape[0], -1, self.pq_len).permute(1, 0, 2) \
            .contiguous()

    def kmeans_excess(self, centers: torch.Tensor) -> float:
        """The k-means objective of ``centers`` (a build's) over the
        reference's, less one."""
        _, d = nearest(self.rows, centers.to(self.rows.device,
                                             torch.float64))
        return float(d.mean()) / self.objective - 1.0

    def pq_excess(self, sample: torch.Tensor,
                  errors: torch.Tensor) -> float:
        """``errors`` [len(sample)]: a build's squared reconstruction
        errors of the rows ``sample``; their mean over the reference's own
        on the same rows, less one."""
        x = self.rows[sample.to(self.rows.device)].to(torch.float64)
        labels, _ = nearest(x, self.centers)
        _, err = subspace_nearest(self._subvectors(x, labels), self.books)
        return float(errors.mean()) / float(err.sum(0).mean()) - 1.0
