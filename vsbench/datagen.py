"""Synthetic rows with a low intrinsic dimension, made on the device.

A copy of ``raft_tpu_torch/bench/datagen.low_rank_clusters`` in torch:
gaussian clusters in an ``intrinsic``-dimensional latent space (unit
cluster spread, centres ~ N(0, spread²)), embedded in ``dim`` dimensions by
one shared random projection. Real embedding sets share the low intrinsic
dimension and the one connected neighbourhood manifold, which an index is
judged on; uniform noise has neither.
"""

from __future__ import annotations

from typing import Optional

import torch

from vsbench.reference.ivf import no_tf32


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` from any whole ``seed`` (taken mod 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def low_rank_clusters(gen: torch.Generator, n: int, dim: int,
                      n_centers: int = 96, intrinsic: int = 16,
                      spread: float = 1.5,
                      geometry_seed: Optional[int] = None) -> torch.Tensor:
    """[n, dim] float32 on the generator's device. With ``geometry_seed``
    the projection and the cluster centres come from that seed and only
    the rows' clusters and offsets from ``gen``: every run then samples one
    fixed distribution, as every query set of one dataset does."""
    dev = gen.device
    geo = gen if geometry_seed is None else generator(geometry_seed, dev)
    proj = torch.randn((intrinsic, dim), generator=geo, device=dev)
    centers = torch.randn((n_centers, intrinsic), generator=geo,
                          device=dev) * spread
    z = centers[torch.randint(0, n_centers, (n,), generator=gen, device=dev)]
    z += torch.randn((n, intrinsic), generator=gen, device=dev)
    with no_tf32():
        return z @ proj


def dataset(data: dict, n: int, dim: int, device,
            seed: Optional[int] = None) -> torch.Tensor:
    """``n`` rows of a configuration's dataset (``data``: the arguments of
    :func:`low_rank_clusters` and ``dataset_seed``). Without ``seed``, the
    dataset's own rows, as one fixed file holds them; with ``seed``, rows
    drawn from ``seed`` out of the dataset's distribution (its projection
    and centres)."""
    params = {k: v for k, v in data.items() if k != "dataset_seed"}
    if seed is None:
        return low_rank_clusters(generator(data["dataset_seed"], device), n,
                                 dim, **params)
    return low_rank_clusters(generator(seed, device), n, dim,
                             geometry_seed=data["dataset_seed"], **params)
