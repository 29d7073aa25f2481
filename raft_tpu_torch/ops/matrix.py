"""Matrix manipulation primitives (counterpart of ``raft_tpu.ops.matrix``).

RAFT's ``raft::matrix``: gather/scatter/slice/argmax/argmin/sorts/
linewise_op/reverse/init/triangular, as thin torch wrappers that run where
their tensors are (host arrays go to the card unless the caller passes CPU
tensors). ``select_k`` and ``SelectAlgo`` are re-exported from
``ops.select_k``, as the JAX package re-exports them; importing this module
leaves ``raft_tpu_torch.ops.select_k`` the function.

The sorts are stable (``jnp.sort``/``jnp.argsort`` are), so ``return_keys``
gives the same ids on ties. ``sample_rows`` draws its rows through the
module-level helper ``_sample_row_ids``, which a test may replace with the
JAX package's draw.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.resources import as_tensors, resolve_device
from raft_tpu_torch.ops.select_k import SelectAlgo, select_k  # noqa: F401


def gather(matrix, indices, axis: int = 0):
    """Row (or column) gather (matrix/gather.cuh)."""
    m, idx = as_tensors(matrix, indices)
    return torch.index_select(m, axis, idx.to(torch.int64).reshape(-1)
                              ).reshape(m.shape[:axis] + idx.shape
                                        + m.shape[axis + 1:])


def gather_if(matrix, indices, mask, fill=0):
    """Conditional gather (matrix/gather.cuh gather_if): rows whose mask is
    False get ``fill``."""
    out = gather(matrix, indices)
    mask, = as_tensors(mask, device=out.device)
    return torch.where(mask[:, None], out, fill)


def scatter(matrix, indices, updates):
    """Row scatter (matrix/scatter.cuh): a copy of matrix with
    ``matrix[indices] = updates``."""
    m, idx, upd = as_tensors(matrix, indices, updates)
    out = m.clone()
    out[idx.to(torch.int64)] = upd.to(m.dtype)
    return out


def slice(matrix, row_start: int, row_end: int, col_start: int = 0,  # noqa: A001
          col_end: Optional[int] = None):
    """Submatrix [row_start:row_end, col_start:col_end] (matrix/slice.cuh)."""
    m, = as_tensors(matrix)
    col_end = m.shape[1] if col_end is None else col_end
    return m[row_start:row_end, col_start:col_end]


def argmax(matrix, axis: int = 1):
    """Per-row argmax, int32, the first of equal maxima (matrix/argmax.cuh)."""
    m, = as_tensors(matrix)
    return torch.argmax(m, dim=axis).to(torch.int32)


def argmin(matrix, axis: int = 1):
    """Per-row argmin, int32, the first of equal minima (matrix/argmin.cuh)."""
    m, = as_tensors(matrix)
    return torch.argmin(m, dim=axis).to(torch.int32)


def _sort(matrix, dim: int, return_keys: bool):
    m, = as_tensors(matrix)
    values, keys = torch.sort(m, dim=dim, stable=True)
    return (values, keys.to(torch.int32)) if return_keys else values


def col_wise_sort(matrix, return_keys: bool = False):
    """Sort each column ascending (matrix/col_wise_sort.cuh)."""
    return _sort(matrix, 0, return_keys)


def row_wise_sort(matrix, return_keys: bool = False):
    """Sort each row ascending."""
    return _sort(matrix, 1, return_keys)


def linewise_op(matrix, vec, op: Callable, along_lines: bool = True):
    """op(matrix, vec) with vec broadcast along rows (``along_lines``) or
    columns (matrix/linewise_op.cuh)."""
    m, v = as_tensors(matrix, vec)
    return op(m, v[None, :] if along_lines else v[:, None])


def reverse(matrix, axis: int = 0):
    """Flip rows or columns (matrix/reverse.cuh)."""
    m, = as_tensors(matrix)
    return torch.flip(m, dims=(axis,))


def init(shape, value, dtype=torch.float32, device=None):
    """Constant fill (matrix/init.cuh), on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    return torch.full(tuple(shape) if not isinstance(shape, int) else
                      (shape,), value, dtype=dtype,
                      device=resolve_device(device))


def eye(n: int, dtype=torch.float32, device=None):
    return torch.eye(n, dtype=dtype, device=resolve_device(device))


def diagonal(matrix):
    """The main diagonal (matrix/diagonal.cuh)."""
    m, = as_tensors(matrix)
    return torch.diagonal(m)


def set_diagonal(matrix, values):
    """A copy of matrix with its main diagonal set to ``values``."""
    m, v = as_tensors(matrix, values)
    out = m.clone()
    torch.diagonal(out).copy_(v)
    return out


def upper_triangular(matrix):
    """matrix/triangular.cuh."""
    m, = as_tensors(matrix)
    return torch.triu(m)


def lower_triangular(matrix):
    m, = as_tensors(matrix)
    return torch.tril(m)


def ratio(matrix):
    """Scale so the elements sum to 1, in fp32 (matrix/ratio.cuh)."""
    m, = as_tensors(matrix)
    m = m.to(torch.float32)
    return m / torch.clamp_min(torch.sum(m), 1e-20)


def weighted_mean(matrix, weights, along_rows: bool = True):
    """Weighted mean of each row (weights over columns) or, with
    ``along_rows=False``, of each column, in fp32."""
    m, w = as_tensors(matrix, weights)
    m, w = m.to(torch.float32), w.to(torch.float32)
    if along_rows:
        return (m * w[None, :]).sum(1) / torch.clamp_min(w.sum(), 1e-20)
    return (m * w[:, None]).sum(0) / torch.clamp_min(w.sum(), 1e-20)


def _sample_row_ids(generator: torch.Generator, n: int, n_samples: int,
                    replace: bool) -> torch.Tensor:
    """``n_samples`` uniform row ids in [0, n), distinct unless ``replace``,
    on the generator's device (the JAX package draws them with
    ``jax.random.choice``, which torch cannot replay; a test hands both
    packages the same ids)."""
    if replace:
        return torch.randint(0, n, (n_samples,), generator=generator,
                             device=generator.device)
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:n_samples]


def sample_rows(generator: torch.Generator, matrix, n_samples: int,
                replace: bool = False):
    """A uniform random subset of the rows (matrix/sample_rows.cuh), drawn
    from ``generator``; a tensor's rows stay on its device, host rows go to
    the generator's."""
    m, = (as_tensors(matrix) if isinstance(matrix, torch.Tensor)
          else as_tensors(matrix, device=generator.device))
    idx = _sample_row_ids(generator, m.shape[0], int(n_samples), replace)
    return m[idx.to(m.device)]
