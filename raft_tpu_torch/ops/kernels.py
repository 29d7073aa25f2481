"""Gram (kernel) matrices: linear, polynomial, tanh and RBF (counterpart of
``raft_tpu.ops.kernels``).

RAFT's ``GramMatrixBase`` (distance/detail/kernels/gram_matrix.cuh:53) and
its Polynomial/Tanh/RBF subclasses (kernel_matrices.cuh:153,329,497), with
``KernelParams{kernel, degree, gamma, coef0}`` (distance/kernels.cuh), over
dense tensors and ``sparse.CSR`` operands.

The inner product of two dense operands is one full fp32 product
(``ops.distance.dot_fp32``, the JAX package's ``Precision.HIGHEST``): on the
card it raises while ``torch.backends.cuda.matmul.allow_tf32`` is on. CSR
operands take the JAX package's branches: a CSR against a dense operand
goes through ``sparse.linalg.spmm``, and of a CSR × CSR pair the smaller
operand is densified and the other multiplies it by ``spmm``. RBF is the
expanded L2 with optional cached squared row norms, clamped at 0.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import torch

from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.ops.distance import dot_fp32
from raft_tpu_torch.sparse import convert as sparse_convert
from raft_tpu_torch.sparse import linalg as sparse_linalg
from raft_tpu_torch.sparse.types import CSR


class KernelType(enum.IntEnum):
    """RAFT's ``kernel_type`` (distance/kernels.cuh)."""

    LINEAR = 0
    POLYNOMIAL = 1
    RBF = 2
    TANH = 3


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """``raft::distance::kernels::KernelParams``."""

    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


ArrayOrCSR = Union[torch.Tensor, CSR]


def _dense(x, like: Optional[CSR] = None) -> torch.Tensor:
    if like is None:
        return as_tensors(x)[0]
    return as_tensors(x, device=like.data.device)[0]


def _inner_product(x: ArrayOrCSR, y: ArrayOrCSR) -> torch.Tensor:
    """x @ yᵀ: one fp32 product for dense operands, ``spmm`` for CSR."""
    if isinstance(x, CSR) and isinstance(y, CSR):
        # densify the smaller operand, as the JAX package does
        if x.shape[0] <= y.shape[0]:
            return sparse_linalg.spmm(y, sparse_convert.csr_to_dense(x).T).T
        return sparse_linalg.spmm(x, sparse_convert.csr_to_dense(y).T)
    if isinstance(x, CSR):
        return sparse_linalg.spmm(x, _dense(y, x).T)
    if isinstance(y, CSR):
        return sparse_linalg.spmm(y, _dense(x, y).T).T
    x, y = as_tensors(x, y)
    return dot_fp32(x, y).to(x.dtype)


def _row_sq_norms(x: ArrayOrCSR) -> torch.Tensor:
    if isinstance(x, CSR):
        return sparse_linalg.row_norm(x, ord="l2")
    x = _dense(x)
    return torch.sum(x.to(torch.float32) ** 2, dim=-1).to(x.dtype)


def linear_kernel(x: ArrayOrCSR, y: ArrayOrCSR) -> torch.Tensor:
    """K[i,j] = <x_i, y_j> (GramMatrixBase's default)."""
    return _inner_product(x, y)


def polynomial_kernel(x: ArrayOrCSR, y: ArrayOrCSR, degree: int = 3,
                      gamma: float = 1.0, coef0: float = 0.0) -> torch.Tensor:
    """K[i,j] = (gamma <x_i, y_j> + coef0)^degree (kernel_matrices.cuh:153)."""
    k = _inner_product(x, y)
    return (gamma * k + coef0) ** degree


def tanh_kernel(x: ArrayOrCSR, y: ArrayOrCSR, gamma: float = 1.0,
                coef0: float = 0.0) -> torch.Tensor:
    """K[i,j] = tanh(gamma <x_i, y_j> + coef0) (kernel_matrices.cuh:329)."""
    k = _inner_product(x, y)
    return torch.tanh(gamma * k + coef0)


def rbf_kernel(x: ArrayOrCSR, y: ArrayOrCSR, gamma: float = 1.0,
               norm_x=None, norm_y=None) -> torch.Tensor:
    """K[i,j] = exp(-gamma ||x_i - y_j||²) (kernel_matrices.cuh:497), the
    squared distance in expanded form from the squared row norms, given or
    computed (RAFT's norm-caching evaluate() overloads)."""
    k = _inner_product(x, y)
    norm_x = _row_sq_norms(x) if norm_x is None else \
        as_tensors(norm_x, device=k.device)[0]
    norm_y = _row_sq_norms(y) if norm_y is None else \
        as_tensors(norm_y, device=k.device)[0]
    sq = norm_x[:, None] + norm_y[None, :] - 2.0 * k
    sq = torch.clamp_min(sq, 0.0)  # cancellation clamp, as in expanded L2
    return torch.exp(-gamma * sq)


def gram_matrix(x: ArrayOrCSR, y: ArrayOrCSR,
                params: Optional[KernelParams] = None,
                norm_x=None, norm_y=None) -> torch.Tensor:
    """The kernel matrix K(x, y) that ``params.kernel`` names (RAFT's
    ``evaluate()``)."""
    params = params or KernelParams()
    if params.kernel == KernelType.LINEAR:
        return linear_kernel(x, y)
    if params.kernel == KernelType.POLYNOMIAL:
        return polynomial_kernel(x, y, params.degree, params.gamma,
                                 params.coef0)
    if params.kernel == KernelType.TANH:
        return tanh_kernel(x, y, params.gamma, params.coef0)
    if params.kernel == KernelType.RBF:
        return rbf_kernel(x, y, params.gamma, norm_x, norm_y)
    raise ValueError(f"unknown kernel type: {params.kernel}")
