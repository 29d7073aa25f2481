"""Random draws (counterpart of ``raft_tpu.ops.rng``).

``jax.random`` keys become an explicit ``torch.Generator`` on the data's
device; the two give different numbers from one seed, so the draws here
are held to their laws and to their determinism per seed, not to jax's
bits. ``RngState`` (a seed and a subsequence) hands out generators; every
function takes a ``RngState``, an int seed or a ``torch.Generator`` as its
``key``, and draws on ``device``: the CUDA device unless the caller asks
for the CPU (``core.resources.resolve_device``), or a generator key's own
device. The one draw whose bits the port must reproduce is CAGRA's
per-query seed offset (``cagra_seed_offsets``): it decides which nodes a
search starts from, so the port replays jax's threefry2x32 for it, in
numpy on ``uint32``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device


@dataclasses.dataclass
class RngState:
    """A seed and a subsequence: each (seed, subsequence) pair names its
    own stream, and ``advance`` moves to the next one."""

    seed: int = 0
    subsequence: int = 0

    def generator(self, device=None) -> torch.Generator:
        """A fresh generator at the start of this state's stream."""
        mixed = np.random.SeedSequence(
            [int(self.seed) & 0xFFFFFFFF, int(self.subsequence) & 0xFFFFFFFF]
        ).generate_state(1, np.uint64)[0]
        g = torch.Generator(device=resolve_device(device))
        g.manual_seed(int(mixed))
        return g

    def advance(self, n: int = 1) -> "RngState":
        return RngState(self.seed, self.subsequence + n)


Key = Union[RngState, int, torch.Generator]


def _gen(key: Key, device=None) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    if isinstance(key, RngState):
        return key.generator(device)
    return RngState(int(key)).generator(device)


def _dev(key: Key, device) -> torch.device:
    if device is None and isinstance(key, torch.Generator):
        return key.device
    return resolve_device(device)


def _open_unit(g: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform draws in [tiny, 1), for the inverse-CDF laws."""
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return torch.clamp_min(u, torch.finfo(torch.float32).tiny)


def uniform(key: Key, shape, low=0.0, high=1.0, dtype=torch.float32,
            device=None) -> torch.Tensor:
    dev = _dev(key, device)
    u = torch.rand(shape, generator=_gen(key, dev), device=dev)
    return (low + (high - low) * u).to(dtype)


def normal(key: Key, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
           device=None) -> torch.Tensor:
    dev = _dev(key, device)
    z = torch.randn(shape, generator=_gen(key, dev), device=dev)
    return (mu + sigma * z).to(dtype)


def laplace(key: Key, shape, mu=0.0, scale=1.0, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """By the inverse CDF: mu − scale·sign(u)·log(1 − 2|u|), u uniform in
    (−½, ½)."""
    dev = _dev(key, device)
    u = _open_unit(_gen(key, dev), shape, dev) - 0.5
    return (mu - scale * torch.sign(u) * torch.log1p(-2.0 * u.abs())
            ).to(dtype)


def gumbel(key: Key, shape, mu=0.0, beta=1.0, dtype=torch.float32,
           device=None) -> torch.Tensor:
    dev = _dev(key, device)
    u = _open_unit(_gen(key, dev), shape, dev)
    return (mu - beta * torch.log(-torch.log(u))).to(dtype)


def lognormal(key: Key, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
              device=None) -> torch.Tensor:
    return torch.exp(normal(key, shape, mu, sigma, torch.float32,
                            device)).to(dtype)


def exponential(key: Key, shape, lam=1.0, dtype=torch.float32,
                device=None) -> torch.Tensor:
    dev = _dev(key, device)
    e = torch.empty(shape, device=dev).exponential_(1.0,
                                                    generator=_gen(key, dev))
    return (e / lam).to(dtype)


def rayleigh(key: Key, shape, sigma=1.0, dtype=torch.float32,
             device=None) -> torch.Tensor:
    dev = _dev(key, device)
    u = _open_unit(_gen(key, dev), shape, dev)
    return (sigma * torch.sqrt(-2.0 * torch.log(u))).to(dtype)


def bernoulli(key: Key, shape, p=0.5, device=None) -> torch.Tensor:
    dev = _dev(key, device)
    return torch.rand(shape, generator=_gen(key, dev), device=dev) < p


def permute(key: Key, n: int, device=None) -> torch.Tensor:
    """A uniform permutation of [0, n), int64."""
    dev = _dev(key, device)
    return torch.randperm(n, generator=_gen(key, dev), device=dev)


def sample_without_replacement(key: Key, n_population: int, n_samples: int,
                               device=None) -> torch.Tensor:
    """``n_samples`` distinct indices drawn uniformly from
    [0, n_population), int64."""
    if n_samples > n_population:
        raise ValueError("n_samples > n_population")
    return permute(key, n_population, device)[:n_samples]


def subsample_rows(generator: torch.Generator, x: torch.Tensor,
                   n_samples: int) -> torch.Tensor:
    """A uniform subsample of ``n_samples`` distinct rows, kept in row order
    (the trainset step of the IVF builds)."""
    if n_samples >= x.shape[0]:
        return x
    idx = torch.randperm(x.shape[0], generator=generator,
                         device=x.device)[:n_samples]
    return x[torch.sort(idx).values]


def make_blobs(key: Key, n_rows: int, n_cols: int, n_clusters: int = 5,
               cluster_std: float = 1.0, center_box=(-10.0, 10.0),
               dtype=torch.float32, shuffle: bool = True,
               return_centers: bool = False, device=None):
    """Isotropic Gaussian blobs: centers uniform in ``center_box``, each
    row a center chosen uniformly plus N(0, cluster_std²) noise. Returns
    (x [n_rows, n_cols], labels [n_rows] int32) and, with
    ``return_centers``, the centers."""
    dev = _dev(key, device)
    g = _gen(key, dev)
    lo, hi = float(center_box[0]), float(center_box[1])
    centers = lo + (hi - lo) * torch.rand((n_clusters, n_cols), generator=g,
                                          device=dev)
    labels = torch.randint(0, n_clusters, (n_rows,), generator=g, device=dev)
    x = centers[labels] + cluster_std * torch.randn(
        (n_rows, n_cols), generator=g, device=dev)
    if shuffle:
        perm = torch.randperm(n_rows, generator=g, device=dev)
        x, labels = x[perm], labels[perm]
    out = (x.to(dtype), labels.to(torch.int32))
    return (*out, centers.to(dtype)) if return_centers else out


def make_regression(key: Key, n_rows: int, n_cols: int,
                    n_informative: Optional[int] = None, noise: float = 0.0,
                    bias: float = 0.0, dtype=torch.float32, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A linear model's data: x ~ N(0, 1), the first ``n_informative``
    coefficients uniform in [0, 100) and the rest 0, y = x·coef + bias (+
    N(0, noise²)). Returns (x, y, coef)."""
    dev = _dev(key, device)
    g = _gen(key, dev)
    n_informative = n_cols if n_informative is None else n_informative
    x = torch.randn((n_rows, n_cols), generator=g, device=dev)
    coef = torch.zeros(n_cols, device=dev)
    coef[:n_informative] = 100.0 * torch.rand(n_informative, generator=g,
                                              device=dev)
    y = x @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(n_rows, generator=g, device=dev)
    return x.to(dtype), y.to(dtype), coef.to(dtype)


def rmat(key: Key, r_scale: int, c_scale: int, n_edges: int, theta=None,
         device=None) -> torch.Tensor:
    """R-MAT edges [n_edges, 2] int32 (src < 2^r_scale, dst < 2^c_scale):
    at each level, from the most significant bit down, each edge picks a
    quadrant by ``theta`` (a, b, c, d; one tuple for every level or one a
    level; default (0.57, 0.19, 0.19, 0.05)), which sets that level's
    source bit (c, d) and destination bit (b, d); a side whose scale is
    smaller takes no bit at the levels above it."""
    dev = _dev(key, device)
    g = _gen(key, dev)
    if theta is None:
        theta = (0.57, 0.19, 0.19, 0.05)
    max_scale = max(r_scale, c_scale)
    th = torch.as_tensor(theta, dtype=torch.float64).reshape(-1, 4)
    if th.shape[0] == 1:
        th = th.expand(max_scale, 4)
    probs = (th / th.sum(1, keepdim=True)).to(dev)
    src = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    dst = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    for lvl in range(max_scale):
        bit = max_scale - 1 - lvl
        q = torch.multinomial(probs[lvl], n_edges, replacement=True,
                              generator=g)
        if bit < r_scale:
            src |= ((q >> 1) & 1) << bit
        if bit < c_scale:
            dst |= (q & 1) << bit
    return torch.stack([src, dst], 1).to(torch.int32)


def multi_variable_gaussian(key: Key, mean, cov, n_samples: int,
                            device=None) -> torch.Tensor:
    """Samples [n_samples, dim] of N(mean, cov), through the Cholesky factor
    of cov + 1e-6·I."""
    dev = _dev(key, device)
    mean = torch.as_tensor(mean, device=dev)
    cov = torch.as_tensor(cov, dtype=mean.dtype, device=dev)
    dim = mean.shape[0]
    chol = torch.linalg.cholesky(
        cov + 1e-6 * torch.eye(dim, dtype=cov.dtype, device=dev))
    z = torch.randn((n_samples, dim), generator=_gen(key, dev), device=dev,
                    dtype=mean.dtype)
    return mean[None, :] + z @ chol.T


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (the block cipher of jax's default PRNG):
    key words ``(k0, k1)``, counter words ``(x0, x1)``, all uint32 arrays
    broadcast together. Returns the two output words."""
    with np.errstate(over="ignore"):
        k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
        ks = (k0, k1, k0 ^ k1 ^ _PARITY)
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _bits32(k0, k1) -> np.ndarray:
    """32 random bits of a key at shape () (jax's partitionable threefry)."""
    b0, b1 = threefry2x32(k0, k1, np.uint32(0), np.uint32(0))
    return b0 ^ b1


def _randint_scalar(k0, k1, size: int) -> np.ndarray:
    """``jax.random.randint(key, (), 0, size, int32)`` for a batch of keys."""
    zero = np.zeros_like(k0)
    a0, a1 = threefry2x32(k0, k1, zero, zero)      # split: first key
    b0, b1 = threefry2x32(k0, k1, zero, zero + 1)  # split: second key
    hi, lo = _bits32(a0, a1), _bits32(b0, b1)
    span = np.uint32(max(int(size), 1))
    with np.errstate(over="ignore"):
        # jax squares in uint32, which wraps to 0 for span >= 65536
        mult = np.uint32((1 << 16) % int(span))
        mult = (mult * mult) % span
        off = (hi % span) * mult + (lo % span)
    return (off % span).astype(np.int64)


def cagra_seed_offsets(rand_xor_mask: int, n_rows: int, size: int
                       ) -> np.ndarray:
    """Per-row rotations of CAGRA's stratified seed lattice, as
    ``raft_tpu.neighbors.cagra.search`` draws them: row r's offset is
    ``randint(fold_in(key(mask & 0x7FFFFFFF), r), (), 0, size)``. Bitwise
    equal to jax's draw; [n_rows] int64 in [0, size)."""
    seed = np.uint32(int(rand_xor_mask) & 0x7FFFFFFF)
    rows = np.arange(n_rows, dtype=np.uint32)
    k0, k1 = threefry2x32(np.uint32(0), seed, np.zeros_like(rows), rows)
    return _randint_scalar(k0, k1, size)
