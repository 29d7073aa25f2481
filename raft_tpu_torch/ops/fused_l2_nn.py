"""Fused L2 nearest neighbour (1-NN), the core of k-means assignment.

Counterpart of ``raft_tpu.ops.fused_l2_nn`` (the reference's ``fusedL2NN``
and ``pylibraft.distance.fused_l2_nn_argmin``): for each row of x, the min
and argmin of its L2 distance to the rows of y, without the [m, n] distance
matrix in device memory. ``fused_l2_nn_core`` (the k-means E-step) runs
the hand-written kernel ``ops.gpu_kernels.fused_l2_argmin`` on the card;
``fused_l2_nn_argmin`` runs it where the measured ``l2_argmin`` verdict
says it beats the unfused route (``gpu_kernels.fused_crossover``: an
expanded-L2 product and a first-minimum per row tile), as the JAX package
does; on the CPU both run the kernel's plain version, in row chunks of
``choose_tile_rows`` from the workspace budget.

``fused_l2_nn_core`` is the clamped form (``l2_expanded`` then the first
argmin) that the k-means E-step uses; ``fused_l2_nn_argmin`` compares the
unclamped distances, as the JAX kernel path does, and clamps only under the
square root. ``masked_l2_nn_argmin`` has no kernel and is plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.ops.distance import dot_fp32, l2_expanded, row_norms_sq
from raft_tpu_torch.utils.shape import as_query_array, balanced_tile


def choose_tile_rows(m: int, n: int, budget_bytes: int) -> int:
    tile = max(1, budget_bytes // (8 * max(n, 1) * 4))
    tile = min(tile, m, 65536)
    return balanced_tile(m, tile, 128)


def planned_peak_bytes(m: int, n: int, budget_bytes: int) -> int:
    """The peak live set ``choose_tile_rows`` solves for: about 8 fp32
    [tile, n] intermediates of the expanded-L2 + argmin chain."""
    return choose_tile_rows(m, n, budget_bytes) * max(n, 1) * 8 * 4


def fused_l2_nn_core(x, y, x_norms, y_norms, sqrt: bool = False,
                     tile: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min distance [m], argmin [m] int32) of the clamped squared distances
    ``max(‖x‖² + ‖y‖² − 2·x·y, 0)``, ties to the lowest y index; square-rooted
    if asked. x, y float32 with their squared norms, on one device."""
    val, idx = gk.fused_l2_argmin(x, y, x_norms, y_norms, clamp=True,
                                  tile=tile)
    return (torch.sqrt(val) if sqrt else val), idx


def fused_l2_nn_argmin(x, y, sqrt: bool = False, x_norms=None, y_norms=None,
                       res: Optional[Resources] = None, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each x row, ``(min L2 distance [m], argmin [m] int32)`` into y's
    rows: squared unless ``sqrt``, whose argument is clamped at 0. Given
    norms are used as they are. Runs on CUDA unless ``device="cpu"`` (or
    ``res``) says otherwise."""
    res = ensure_resources(res, device)
    x = as_query_array(x, res.device, torch.float32)
    y = as_query_array(y, res.device, torch.float32)
    xn = row_norms_sq(x) if x_norms is None else torch.as_tensor(
        x_norms, dtype=torch.float32, device=res.device).contiguous()
    yn = row_norms_sq(y) if y_norms is None else torch.as_tensor(
        y_norms, dtype=torch.float32, device=res.device).contiguous()
    tile = choose_tile_rows(x.shape[0], y.shape[0], res.workspace_limit_bytes)
    if gk.fused_crossover("l2_argmin", res.device):
        val, idx = gk.fused_l2_argmin(x, y, xn, yn, clamp=False, tile=tile)
    else:
        val, idx = l2_nn_unfused(x, y, xn, yn, tile)
    if sqrt:
        val = torch.sqrt(torch.clamp_min(val, 0.0))
    return val, idx


def l2_nn_unfused(x, y, x_norms, y_norms, tile: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused route of ``fused_l2_nn_argmin``: per tile of x rows the
    [tile, n] squared distances (``l2_expanded``, unclamped) and their
    first minimum, lowest y index on ties."""
    out_v, out_i = [], []
    for s in range(0, x.shape[0], tile):
        d = (x_norms[s:s + tile, None] + y_norms[None, :]) \
            - 2.0 * dot_fp32(x[s:s + tile], y)
        v, i = torch.min(d, dim=1)
        out_v.append(v)
        out_i.append(i.to(torch.int32))
    if not out_v:
        return x.new_empty((0,)), x.new_empty((0,), dtype=torch.int32)
    return torch.cat(out_v), torch.cat(out_i)


def masked_l2_nn_argmin(x, y, adj, group_idxs, sqrt: bool = False,
                        x_norms=None, y_norms=None,
                        res: Optional[Resources] = None, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked L2 1-NN (the reference's ``masked_nn.cuh``). ``adj`` is a
    [m, num_groups] boolean adjacency; ``group_idxs`` [num_groups] holds each
    group's end offset into y's rows (group g spans y rows
    [group_idxs[g-1], group_idxs[g])). An x row with no allowed group gets
    distance inf and index 0. Distances are clamped at 0."""
    res = ensure_resources(res, device)
    dev = res.device
    x = as_query_array(x, dev, torch.float32)
    y = as_query_array(y, dev, torch.float32)
    adj = torch.as_tensor(adj, device=dev).to(torch.bool)
    group_idxs = torch.as_tensor(group_idxs, device=dev).to(torch.int64)
    # each y row's group: the count of group ends at or before it
    y_rows = torch.arange(y.shape[0], device=dev)
    group_of_y = (y_rows[:, None] >= group_idxs[None, :]).sum(1)
    group_of_y = torch.clamp_max(group_of_y, adj.shape[1] - 1)
    xn = row_norms_sq(x) if x_norms is None else torch.as_tensor(
        x_norms, dtype=torch.float32, device=dev)
    yn = row_norms_sq(y) if y_norms is None else torch.as_tensor(
        y_norms, dtype=torch.float32, device=dev)
    tile = choose_tile_rows(x.shape[0], y.shape[0], res.workspace_limit_bytes)
    out_v, out_i = [], []
    for s in range(0, x.shape[0], tile):
        d = l2_expanded(x[s:s + tile], y, sqrt=False,
                        x_norms=xn[s:s + tile], y_norms=yn)
        d = torch.where(adj[s:s + tile][:, group_of_y], d, torch.inf)
        v, i = torch.min(d, dim=1)
        out_v.append(v)
        out_i.append(i.to(torch.int32))
    if not out_v:
        return (x.new_empty((0,)), x.new_empty((0,), dtype=torch.int32))
    val, idx = torch.cat(out_v), torch.cat(out_i)
    if sqrt:
        val = torch.sqrt(torch.clamp_min(val, 0.0))
    return val, idx
