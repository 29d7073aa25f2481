"""Random draws (counterpart of ``raft_tpu.ops.rng``).

``jax.random`` keys become an explicit ``torch.Generator`` on the data's
device; the two give different numbers from one seed. The one draw whose
bits the port must reproduce is CAGRA's per-query seed offset
(``cagra_seed_offsets``): it decides which nodes a search starts from, so
the port replays jax's threefry2x32 for it, in numpy on ``uint32``."""

from __future__ import annotations

import numpy as np
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
