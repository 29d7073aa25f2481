"""Packed bitset — the ``filter=`` argument of the searches.

Counterpart of ``raft_tpu.core.bitset``: bit ``i`` lives in word ``i // 32``
at position ``i % 32``; a set bit means the row may be returned. The words
are kept as int64 tensors holding 32-bit values, since torch's uint32 has
few operators; the bit layout is the JAX package's, so its ``words`` carry
over with ``np.asarray(words).astype(np.int64)``."""

from __future__ import annotations

import torch

_WORD_BITS = 32
_WORD_MASK = (1 << _WORD_BITS) - 1


def _n_words(n_bits: int) -> int:
    return (n_bits + _WORD_BITS - 1) // _WORD_BITS


class Bitset:
    """Immutable packed bitset over ``n_bits`` positions."""

    def __init__(self, words: torch.Tensor, n_bits: int):
        self.words = words.to(torch.int64)
        self.n_bits = int(n_bits)

    @staticmethod
    def create(n_bits: int, default: bool = True,
               device="cpu") -> "Bitset":
        """New bitset, all set by default (every row passes)."""
        fill = _WORD_MASK if default else 0
        words = torch.full((_n_words(n_bits),), fill, dtype=torch.int64,
                           device=device)
        return Bitset(words, n_bits)._mask_tail()

    @staticmethod
    def from_mask(mask) -> "Bitset":
        """From a boolean vector of length n_bits."""
        mask = torch.as_tensor(mask, dtype=torch.bool)
        n_bits = mask.shape[0]
        padded = torch.zeros(_n_words(n_bits) * _WORD_BITS, dtype=torch.int64,
                             device=mask.device)
        padded[:n_bits] = mask.to(torch.int64)
        shifts = torch.arange(_WORD_BITS, dtype=torch.int64, device=mask.device)
        words = (padded.view(-1, _WORD_BITS) << shifts).sum(dim=1)
        return Bitset(words, n_bits)

    def _mask_tail(self) -> "Bitset":
        tail = self.n_bits % _WORD_BITS
        if tail == 0 or self.words.numel() == 0:
            return self
        words = self.words.clone()
        words[-1] &= (1 << tail) - 1
        return Bitset(words, self.n_bits)

    def set(self, indices, value: bool = True) -> "Bitset":
        """Set (or clear) the bits at ``indices``."""
        touched = torch.zeros(self.n_bits, dtype=torch.bool,
                              device=self.words.device)
        touched[torch.as_tensor(indices, device=self.words.device)] = True
        mask_words = Bitset.from_mask(touched).words
        if value:
            return Bitset(self.words | mask_words, self.n_bits)
        return Bitset(self.words & ~mask_words & _WORD_MASK, self.n_bits)

    def test(self, indices) -> torch.Tensor:
        """Bit values at ``indices`` as a bool tensor."""
        return filter_mask(torch.as_tensor(indices, device=self.words.device),
                           self.words)

    def flip(self) -> "Bitset":
        return Bitset(~self.words & _WORD_MASK, self.n_bits)._mask_tail()

    def count(self) -> int:
        return int(self.to_mask().sum())

    def to_mask(self) -> torch.Tensor:
        shifts = torch.arange(_WORD_BITS, dtype=torch.int64,
                              device=self.words.device)
        bits = (self.words[:, None] >> shifts[None, :]) & 1
        return bits.reshape(-1)[: self.n_bits].to(torch.bool)

    def __len__(self) -> int:
        return self.n_bits


def filter_mask(ids: torch.Tensor, filter_words: torch.Tensor) -> torch.Tensor:
    """Membership of candidate ids in a bitset's words. Negative ids (padding)
    read word 0 and must be masked by the caller's validity mask."""
    safe = ids.clamp_min(0).to(torch.int64)
    words = filter_words[safe // _WORD_BITS]
    return ((words >> (safe % _WORD_BITS)) & 1).to(torch.bool)
