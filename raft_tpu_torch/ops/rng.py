"""Random row subsampling (counterpart of ``raft_tpu.ops.rng.subsample_rows``).

``jax.random`` keys become an explicit ``torch.Generator`` on the data's
device; the two give different numbers from one seed."""

from __future__ import annotations

import torch


def subsample_rows(generator: torch.Generator, x: torch.Tensor,
                   n_samples: int) -> torch.Tensor:
    """A uniform subsample of ``n_samples`` distinct rows, kept in row order
    (the trainset step of the IVF builds)."""
    if n_samples >= x.shape[0]:
        return x
    idx = torch.randperm(x.shape[0], generator=generator,
                         device=x.device)[:n_samples]
    return x[torch.sort(idx).values]
