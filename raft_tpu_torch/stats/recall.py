"""ANN recall (counterpart of ``raft_tpu.stats.recall``)."""

from __future__ import annotations

from typing import Optional

import torch


def neighborhood_recall(indices, ref_indices,
                        distances: Optional[torch.Tensor] = None,
                        ref_distances: Optional[torch.Tensor] = None,
                        eps: float = 0.001) -> torch.Tensor:
    """Mean recall of ``indices`` [n, k] against ``ref_indices`` [n, k].

    A prediction counts if its index is in the reference row or, when both
    distance arrays are given, if its distance is within ``eps`` of a
    reference distance (ties)."""
    indices = torch.as_tensor(indices)
    ref_indices = torch.as_tensor(ref_indices, device=indices.device)
    match = (indices[:, :, None] == ref_indices[:, None, :]).any(dim=-1)
    if distances is not None and ref_distances is not None:
        distances = torch.as_tensor(distances, device=indices.device)
        ref_distances = torch.as_tensor(ref_distances, device=indices.device)
        tie = ((distances[:, :, None] - ref_distances[:, None, :]).abs()
               <= eps).any(dim=-1)
        match = match | tie
    return match.to(torch.float32).mean()
