"""Linear assignment (counterpart of ``raft_tpu.solver``; RAFT's
solver/linear_assignment.cuh).

``solve`` runs the JAX package's auction round for round: every unassigned
row bids for its best column (``torch.argmax``, the first maximum, as
``lax.top_k`` puts the lower column first among equal values; the second
value is the row's maximum with that column masked), the highest bid takes
each column (the lowest row among equal bids), prices rise on the winning
columns (distinct, so an indexed assignment) and the displaced owners bid
again. Scatters to the JAX package's dropped index land in a spare slot
that is sliced off. Every step is exact or a max/min, so the assignment is
the JAX package's bit for bit, on the CPU and on the card.

The JAX loop tests ``any(unassigned)`` every round, which in eager PyTorch
is a read back to the host each round. Once no row is unassigned a round
changes nothing, so the port reads the flag every ``CHECK_EVERY`` rounds
(capped at ``max_iters``) with the same result. ``solve_host`` is scipy's
Jonker-Volgenant, the exact oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensors

#: rounds between two reads of the "any row unassigned" flag
CHECK_EVERY = 32


def auction(cost: torch.Tensor, eps: float, maximize: bool, max_iters: int
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The auction on a square fp32 cost → ``(col_of_row [n] int32,
    unassigned [n] bool, rounds)``; ``rounds`` counts the rounds that had a
    bidder (the JAX loop's trip count)."""
    n, m = cost.shape
    dev = cost.device
    benefit = cost if maximize else -cost
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    row_of_col = torch.full((m + 1,), -1, dtype=torch.int64, device=dev)
    price = torch.zeros((m + 1,), dtype=torch.float32, device=dev)
    unassigned = torch.ones((n + 1,), dtype=torch.bool, device=dev)
    unassigned[n] = False
    active = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(int(max_iters)):
        if i % CHECK_EVERY == 0 and not bool(unassigned.any()):
            break
        bidding = unassigned[:n]
        active += bidding.any()
        value = benefit - price[None, :m]
        target = torch.argmax(value, dim=1)
        v1 = value.gather(1, target[:, None])[:, 0]
        v2 = value.scatter(1, target[:, None], -torch.inf).amax(1)
        bid_inc = v1 - v2 + eps_t
        # only unassigned rows bid; the others go to the spare column m
        bidder = torch.where(bidding, target, m)
        best_bid = torch.full((m + 1,), -torch.inf, device=dev
                              ).scatter_reduce_(0, bidder, bid_inc, "amax",
                                                include_self=True)
        is_best = bidding & (bid_inc >= best_bid[target])
        # the lowest row among a column's best bidders wins it
        winner = torch.full((m + 1,), n, dtype=torch.int64, device=dev
                            ).scatter_reduce_(
                                0, torch.where(is_best, target, m), rows,
                                "amin", include_self=True)
        won = is_best & (winner[target] == rows)
        won_col = torch.where(won, target, m)
        # the columns' previous owners bid again (row n: the spare)
        displaced = row_of_col[won_col]
        displaced = torch.where(won & (displaced >= 0), displaced, n)
        unassigned[:n] = bidding & ~won
        unassigned[displaced] = True
        unassigned[n] = False
        price[won_col] = price[won_col] + torch.where(won, bid_inc, 0.0)
        row_of_col[won_col] = rows
    col_of_row = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    owner = row_of_col[:m]
    col_of_row[torch.where(owner >= 0, owner, n)] = torch.arange(
        m, dtype=torch.int32, device=dev)
    return col_of_row[:n], unassigned[:n], int(active)


def solve(cost, maximize: bool = False, eps: Optional[float] = None,
          max_iters: int = 0, device=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the square dense assignment problem by auction
    (LinearAssignmentProblem::solve) → ``(col_of_row [n] int32, total
    cost)``. With ``eps < 1/n`` (the default) the result is optimal for
    integer costs and within n·eps of optimal for float costs. Tensors stay
    on their device; host arrays go to ``device`` (CUDA unless the caller
    asks for the CPU)."""
    cost, = as_tensors(cost, device=device)
    cost = cost.to(torch.float32)
    n, m = cost.shape
    if n != m:
        raise ValueError(f"cost must be square, got {tuple(cost.shape)}")
    if eps is None:
        eps = 1.0 / (n + 1)
    if max_iters <= 0:
        max_iters = 50 * n + 1000
    assign, _, _ = auction(cost, float(eps), bool(maximize), int(max_iters))
    picked = cost.gather(1, torch.clamp_min(assign, 0).to(torch.int64)[:, None])
    total = (picked[:, 0] * (assign >= 0)).sum()
    return assign, total


def solve_host(cost, maximize: bool = False) -> Tuple[np.ndarray, float]:
    """Exact host solve (scipy's Jonker-Volgenant), the oracle for tests and
    small problems."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost)
    rows, cols = linear_sum_assignment(cost, maximize=maximize)
    out = np.full(cost.shape[0], -1, np.int64)
    out[rows] = cols
    return out, float(cost[rows, cols].sum())
