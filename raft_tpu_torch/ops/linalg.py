"""Dense linear-algebra primitives (counterpart of ``raft_tpu.ops.linalg``).

RAFT's ``raft::linalg``: the BLAS wrappers (gemm, gemv, axpy, dot), the
kernel primitives (map, map_reduce, the reductions, norms, reductions by
key, ...), the decompositions (QR, Cholesky, eigh, SVD, least squares) over
``torch.linalg``, the randomized SVD and the Lanczos eigensolver.

None of these is a hand-written kernel: they are torch glue, as they are
XLA glue in the JAX package. Each runs where its tensors are; host arrays
go to the card unless the caller passes CPU tensors
(``core.resources.as_tensors``).

- ``gemm`` and ``gemv`` of fp32 operands are full fp32 products, the
  JAX package's ``Precision.HIGHEST``: on the card they raise while
  ``torch.backends.cuda.matmul.allow_tf32`` is on. The other products
  (``rsvd``, ``lanczos``) are plain ``torch.matmul``, as the JAX package
  leaves them to XLA's default.
- Sums by key (``reduce_rows_by_key``, ``reduce_cols_by_key``) add each
  key's rows in row order, after a stable sort by key, through
  ``torch.segment_reduce``: the same bits on every run, on the CPU and the
  card (no float atomics).
- Reductions take torch's convention: ``op(tensor, dim=axis)``
  (``torch.sum``, ``torch.amax``, ...).
- The random draws (``rsvd``'s test matrix, ``lanczos``' start vector) are
  made by module-level helpers, ``_gaussian_test_matrix`` and
  ``_start_vector``, which a test may replace with the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.resources import as_tensors, resolve_device
from raft_tpu_torch.ops.distance import _check_fp32_products


def _fp32_product_check(a: torch.Tensor) -> None:
    if a.dtype == torch.float32:
        _check_fp32_products(a)


# ------------------------------------------------------------- BLAS wrappers


def gemm(a, b, trans_a: bool = False, trans_b: bool = False,
         alpha: float = 1.0, beta: float = 0.0, c=None):
    """alpha·op(A)·op(B) [+ beta·C] (linalg/gemm.cuh); full fp32 for fp32
    operands."""
    a, b, c = as_tensors(a, b, c)
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    _fp32_product_check(a)
    out = alpha * torch.matmul(a, b)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


def gemv(a, x, trans: bool = False, alpha: float = 1.0):
    """Matrix-vector product (linalg/gemv.cuh); full fp32 for fp32."""
    a, x = as_tensors(a, x)
    if trans:
        a = a.T
    _fp32_product_check(a)
    return alpha * torch.matmul(a, x)


def axpy(alpha: float, x, y):
    """y + alpha·x (linalg/axpy.cuh)."""
    x, y = as_tensors(x, y)
    return y + alpha * x


def dot(x, y):
    """Dot product of the flattened operands (linalg/dot.cuh)."""
    x, y = as_tensors(x, y)
    return torch.dot(x.reshape(-1), y.reshape(-1))


# ------------------------------------------------------ elementwise / reduce


def map(fn: Callable, *arrays):  # noqa: A001 — RAFT's name
    """Elementwise map over same-shape arrays (linalg/map.cuh)."""
    return fn(*as_tensors(*arrays))


def map_reduce(map_fn: Callable, reduce_fn: Callable, *arrays, axis=None):
    """map, then ``reduce_fn(mapped, dim=axis)`` (linalg/map_reduce.cuh);
    ``axis=None`` reduces everything."""
    m = map(map_fn, *arrays)
    return reduce_fn(m) if axis is None else reduce_fn(m, dim=axis)


def coalesced_reduction(x, op=torch.sum):
    """Reduce along the contiguous (last) axis
    (linalg/coalesced_reduction.cuh)."""
    x, = as_tensors(x)
    return op(x, dim=-1)


def strided_reduction(x, op=torch.sum):
    """Reduce along the strided (first) axis
    (linalg/strided_reduction.cuh)."""
    x, = as_tensors(x)
    return op(x, dim=0)


def _sum_rows_by_key(x: torch.Tensor, keys: torch.Tensor,
                     n_keys: int) -> torch.Tensor:
    """out[key] = Σ of x's rows with that key, each key's rows in row order
    (stable sort, then a segment sum). Keys lie in [0, n_keys)."""
    k = keys.to(torch.int64)
    if not x.dtype.is_floating_point:  # integer sums are exact in any order
        return x.new_zeros((n_keys,) + tuple(x.shape[1:])).index_add_(0, k, x)
    order = torch.argsort(k, stable=True)
    bounds = torch.arange(n_keys + 1, device=x.device, dtype=torch.int64)
    offsets = torch.searchsorted(k[order], bounds)
    return torch.segment_reduce(x[order], "sum", offsets=offsets, axis=0)


def reduce_rows_by_key(x, keys, n_keys: int, weights=None):
    """Per-key row sums (linalg/reduce_rows_by_key.cuh, the k-means M-step
    primitive): x [n, d], keys [n] → out [n_keys, d]."""
    x, keys, weights = as_tensors(x, keys, weights)
    if weights is not None:
        x = x * weights[:, None]
    return _sum_rows_by_key(x, keys, int(n_keys))


def reduce_cols_by_key(x, keys, n_keys: int):
    """Per-key column sums (linalg/reduce_cols_by_key.cuh): x [n, d],
    keys [d] → out [n, n_keys]."""
    x, keys = as_tensors(x, keys)
    return _sum_rows_by_key(x.T, keys, int(n_keys)).T


def matrix_vector_op(m, v, op: Callable = torch.add, along_rows: bool = True):
    """Broadcast a vector op over rows or columns
    (linalg/matrix_vector_op.cuh)."""
    m, v = as_tensors(m, v)
    return op(m, v[None, :] if along_rows else v[:, None])


def norm(x, ord: str = "l2", axis: int = -1, sqrt: bool = False):
    """Row or column norms in fp32 (linalg/norm.cuh): 'l1' | 'l2' | 'linf';
    for 'l2', ``sqrt`` selects the rooted norm."""
    x, = as_tensors(x)
    x = x.to(torch.float32)
    if ord == "l1":
        return torch.sum(torch.abs(x), dim=axis)
    if ord == "l2":
        s = torch.sum(x * x, dim=axis)
        return torch.sqrt(s) if sqrt else s
    if ord == "linf":
        return torch.amax(torch.abs(x), dim=axis)
    raise ValueError(f"unknown norm {ord!r}")


def normalize(x, axis: int = -1, eps: float = 1e-10):
    """Scale to unit L2 norm along ``axis`` (linalg/normalize.cuh)."""
    x, = as_tensors(x)
    n = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp_min(n, eps)


def add(a, b):
    a, b = as_tensors(a, b)
    return a + b


def subtract(a, b):
    a, b = as_tensors(a, b)
    return a - b


def multiply_scalar(x, scalar):
    x, = as_tensors(x)
    return x * scalar


def binary_op(a, b, op: Callable):
    return op(*as_tensors(a, b))


def unary_op(x, op: Callable):
    return op(*as_tensors(x))


def transpose(x):
    """All axes reversed, as ``jnp.ndarray.T``."""
    x, = as_tensors(x)
    return x.permute(*reversed(range(x.dim())))


# --------------------------------------------------------------- decompositions


def qr_get_q(a):
    """Q factor of the reduced QR (linalg/qr.cuh qrGetQ)."""
    a, = as_tensors(a)
    return torch.linalg.qr(a).Q


def qr_get_qr(a):
    """(Q, R) of the reduced QR."""
    a, = as_tensors(a)
    q, r = torch.linalg.qr(a)
    return q, r


def cholesky(a, lower: bool = True):
    """Cholesky factor (cuSOLVER potrf); the upper factor when
    ``lower=False``."""
    a, = as_tensors(a)
    c = torch.linalg.cholesky(a)
    return c if lower else c.mT


def eig_dc(a):
    """Symmetric eigendecomposition (linalg/eig.cuh eigDC): (eigenvalues
    ascending, eigenvectors)."""
    a, = as_tensors(a)
    w, v = torch.linalg.eigh(a)
    return w, v


def eig_jacobi(a, tol: float = 1e-7):
    """eigJacobi's signature; ``torch.linalg.eigh`` solves it (tol unused,
    as in the JAX package)."""
    return eig_dc(a)


def svd(a, full_matrices: bool = False):
    """(U, S, V) of a (linalg/svd.cuh): V, not Vᵀ."""
    a, = as_tensors(a)
    u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
    return u, s, vh.mT


def svd_qr(a):
    return svd(a)


def _gaussian_test_matrix(generator: torch.Generator, n: int, l: int
                          ) -> torch.Tensor:
    """rsvd's random test matrix Ω [n, l] ~ N(0, 1) in fp32 on the
    generator's device (the JAX package draws it with
    ``jax.random.normal``, which torch cannot replay; a test hands both
    packages the same matrix)."""
    return torch.randn((n, l), generator=generator, device=generator.device,
                       dtype=torch.float32)


def rsvd(generator: torch.Generator, a, k: int, p: int = 10,
         n_iter: int = 4):
    """Randomized SVD (linalg/rsvd.cuh): a range finder with ``n_iter``
    power iterations, each re-orthogonalised (Halko et al.). Returns
    (U [m, k], S [k], V [n, k]). ``generator`` draws the test matrix and
    sets the device (``a`` moves there)."""
    a, = as_tensors(a, device=generator.device)
    a = a.to(torch.float32)
    m, n = a.shape
    l = min(k + p, min(m, n))
    omega = _gaussian_test_matrix(generator, n, l)
    y = a @ omega
    for _ in range(n_iter):
        y = a @ (a.T @ y)
        y = torch.linalg.qr(y).Q  # re-orthogonalise each power iteration
    q = torch.linalg.qr(y).Q
    b = q.T @ a  # [l, n]
    ub, s, vbh = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :k], s[:k], vbh.mT[:, :k]


def lstsq(a, b):
    """Least-squares solution of a·x = b (linalg/lstsq.cuh)."""
    a, b = as_tensors(a, b)
    return torch.linalg.lstsq(a, b).solution


# ----------------------------------------------------------------- lanczos


def _start_vector(generator: torch.Generator, n: int) -> torch.Tensor:
    """Lanczos' start vector [n] ~ N(0, 1) in fp32 on the generator's device
    (the JAX package draws it with ``jax.random.normal``, from
    ``jax.random.key(0)`` when no key is given; a test hands both packages
    the same vector)."""
    return torch.randn((n,), generator=generator, device=generator.device,
                       dtype=torch.float32)


def lanczos(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    k: int,
    generator: Optional[torch.Generator] = None,
    ncv: Optional[int] = None,
    which: str = "smallest",
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanczos eigensolver for a symmetric operator given by ``matvec``
    (linalg/lanczos.cuh computeSmallestEigenvectors /
    computeLargestEigenvectors).

    ``ncv`` steps (default max(2k+1, 20), at most n) of Krylov
    tridiagonalisation with full reorthogonalisation and no restart, as the
    JAX package runs them, then the small tridiagonal problem by eigh.
    Returns (eigenvalues [k], eigenvectors [n, k]). Without a ``generator``
    the start vector comes from a generator seeded with 0 on ``device``
    (CUDA unless the caller asks for the CPU)."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    ncv = int(min(n, ncv if ncv is not None else max(2 * k + 1, 20)))
    v0 = _start_vector(generator, n)
    v0 = v0 / torch.linalg.vector_norm(v0)

    vs = v0.new_zeros((ncv, n))
    vs[0] = v0
    alphas = v0.new_zeros((ncv,))
    betas = v0.new_zeros((ncv,))
    for j in range(ncv):
        v = vs[j]
        w = matvec(v)
        alpha = torch.dot(v, w)
        w = w - alpha * v
        if j > 0:
            w = w - betas[j - 1] * vs[j - 1]
        # full reorthogonalisation against every vector so far
        basis = vs[:j + 1]
        w = w - basis.T @ (basis @ w)
        beta = torch.linalg.vector_norm(w)
        if j + 1 < ncv:
            vs[j + 1] = w / torch.clamp_min(beta, 1e-20)
        alphas[j] = alpha
        betas[j] = beta

    t = (torch.diag(alphas) + torch.diag(betas[:ncv - 1], 1)
         + torch.diag(betas[:ncv - 1], -1))
    w, u = torch.linalg.eigh(t)
    key = -w if which == "largest" else w
    sel = torch.argsort(key, stable=True)[:k]
    eigvals = w[sel]
    eigvecs = vs.T @ u[:, sel]  # [n, k]
    eigvecs = eigvecs / torch.clamp_min(
        torch.linalg.vector_norm(eigvecs, dim=0, keepdim=True), 1e-20)
    return eigvals, eigvecs
