"""Shape and tile arithmetic shared by the planners and search paths."""

from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up_to(n: int, multiple: int) -> int:
    return cdiv(n, multiple) * multiple


def balanced_tile(total: int, tile: int, multiple: int) -> int:
    """Split ``total`` evenly over the tile count a budget-derived ``tile``
    implies, aligned up to ``multiple`` when that stays within the budget.

    Rounding a budget tile down to the multiple would turn total=10000 /
    tile=10000 into 9984, i.e. two tiles with the second almost all
    padding. The result never exceeds ``max(tile, 1)``; ``total == 0``
    gives 1."""
    tile = max(tile, 1)
    if total <= tile:
        return max(total, 1)
    n_tiles = cdiv(total, tile)
    balanced = cdiv(total, n_tiles)
    aligned = round_up_to(balanced, multiple)
    return aligned if aligned <= tile else balanced


def as_query_array(queries, device: torch.device,
                   dtype: torch.dtype = None) -> torch.Tensor:
    """Queries as a 2-D contiguous tensor on ``device`` (numpy arrays,
    lists and tensors on any device are accepted), cast to ``dtype`` when
    given."""
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.ascontiguousarray(queries))
    queries = queries.to(device=device, dtype=dtype)
    if queries.dim() != 2:
        raise ValueError(f"queries must be [n, dim], got {tuple(queries.shape)}")
    return queries.contiguous()
