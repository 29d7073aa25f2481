"""The yardstick of the kernels' roofline shares.

The least time the card could take for a kernel's work is the larger of
its bytes over the memory rate and its operations over the arithmetic
rate. The formulas are copies of ``raft_tpu_torch/obs/costs.py``'s, with
two corrections, so that the count depends on the cell's inputs alone and
not on the program's layout:

- each probed list is counted at its filled rows, not at the program's
  padded slab, and ``rows_scanned`` is the sum over every (query, probe) of
  that list's row count;
- each count is of the whole batch, read once, whatever query chunks the
  program splits it into; the queries are read once, not once a probe.

Operations are divided by 165 TFLOP/s, three TF32 products at the H100
SXM's 495 TFLOP/s dense rate: the rate at which the port computes its
fp32-accurate products, so a kernel on the tensor cores cannot read above
100%. Bytes are divided by 3.35 TB/s (NVIDIA's data sheet, at 700 W).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vsbench.reference.ivf import no_tf32

#: three TF32 products at the H100 SXM's dense 495 TFLOP/s
PEAK_OPS_PER_S = 495e12 / 3
#: HBM3 of the H100 SXM
PEAK_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time for the work."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def coarse_probes(queries: torch.Tensor, centers: torch.Tensor,
                  n_probes: int) -> torch.Tensor:
    """[nq, n_probes] the lists nearest each query by squared L2, in fp32
    (no TF32): the lists an IVF search of these queries scans."""
    q, c = queries.to(torch.float32), centers.to(torch.float32)
    with no_tf32():
        d = (c * c).sum(1)[None, :] - 2.0 * (q @ c.T)
    return torch.topk(d, n_probes, dim=1, largest=False).indices


def probed_rows(list_sizes: torch.Tensor,
                probes: torch.Tensor) -> Tuple[int, int]:
    """(rows_probed, rows_scanned) of a whole batch's probes [nq, P]: the
    filled rows of the distinct lists probed (each read once), and the sum
    over every (query, probe) of the list's filled rows."""
    sizes = list_sizes.to(torch.int64)
    rows_scanned = int(sizes[probes.reshape(-1)].sum())
    rows_probed = int(sizes[torch.unique(probes)].sum())
    return rows_probed, rows_scanned


def ivf_topk_work(nq: int, n_probes: int, dim: int, elem_bytes: int, k: int,
                  rows_probed: int, rows_scanned: int) -> Tuple[int, int]:
    """``fused_ivf_topk``: the queries and their norms, the probes, each
    probed list's filled rows with their norms and ids once, the result;
    2·dim operations a row scanned."""
    return (4 * (nq * dim + nq + nq * n_probes)
            + rows_probed * (dim * elem_bytes + 8) + 8 * nq * k,
            2 * dim * rows_scanned)


def pq_topk_work(nq: int, n_probes: int, rot: int, n_lists: int,
                 pq_dim: int, pq_len: int, book: int, code_bytes: int,
                 k: int, rows_probed: int,
                 rows_scanned: int) -> Tuple[int, int]:
    """``fused_pq_topk``: the probes, rotated queries, rotated centres,
    codebooks and their norms, each probed list's filled rows of codes and
    ids once, the result; each (query, probe)'s LUT (2·pq_len + 2
    operations an entry) and one add a (row, subspace) scanned."""
    return (4 * (nq * n_probes + nq * rot + n_lists * rot
                 + pq_dim * book * pq_len + pq_dim * book)
            + rows_probed * (code_bytes + 4) + 8 * nq * k,
            nq * n_probes * pq_dim * book * (2 * pq_len + 2)
            + rows_scanned * pq_dim)


def ivf_scan_work(nq: int, n_probes: int, dim: int, elem_bytes: int,
                  rows_probed: int, rows_scanned: int) -> Tuple[int, int]:
    """``ivf_scan``: the probes and queries, each probed list's filled rows
    with their norms once, a partial distance written a row scanned; 2·dim
    operations a row scanned."""
    return (4 * (nq * n_probes + nq * dim)
            + rows_probed * (dim * elem_bytes + 4) + 4 * rows_scanned,
            2 * dim * rows_scanned)

