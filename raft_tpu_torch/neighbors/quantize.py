"""Scalar quantization — fp32 → int8 datasets for bandwidth-bound search
(a copy of ``raft_tpu.neighbors.quantize``: pure numpy, host only).

Reference analog: the legacy quantized-kNN path (spatial/knn/detail/
ann_quantized.cuh), 8-bit scalar quantization in front of the ANN indexes.
Quantization is a host-side transform: per-dimension affine codes with
quantile-trimmed ranges (outliers saturate instead of stretching the grid).
The int8 codes are searched by brute force and by IVF-Flat over int8 lists
(on the card, ``fused_ivf_topk`` reads the narrow rows).

Typical use::

    sq = quantize.ScalarQuantizer.fit(train, quantile=0.99)
    db_i8 = sq.transform(dataset)
    index = brute_force.build(db_i8, metric="sqeuclidean")
    d, i = brute_force.search(index, sq.transform(queries), k)

Distances come back in the quantized domain; rank order is what matters
(recall vs the fp32 ground truth is the acceptance metric, as for PQ).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ScalarQuantizer:
    """Per-dimension affine int8 quantizer: code = round((x - lo)/scale) - 128."""

    lo: np.ndarray  # [dim] f32
    scale: np.ndarray  # [dim] f32 (width / 255)

    @classmethod
    def fit(cls, train, quantile: float = 1.0) -> "ScalarQuantizer":
        """Learn per-dim ranges from a training sample. ``quantile`` < 1
        trims tails symmetrically (e.g. 0.99 ignores the extreme 1%), so a
        few outliers don't waste code space."""
        x = np.asarray(train, np.float32)
        if not (0.5 < quantile <= 1.0):
            # quantile is the UPPER tail point; ≤ 0.5 would invert lo/hi
            raise ValueError(
                f"quantile must be in (0.5, 1], got {quantile}")
        if quantile < 1.0:
            lo = np.quantile(x, 1.0 - quantile, axis=0)
            hi = np.quantile(x, quantile, axis=0)
        else:
            lo = x.min(axis=0)
            hi = x.max(axis=0)
        scale = np.maximum((hi - lo).astype(np.float32), 1e-12) / 255.0
        return cls(lo=lo.astype(np.float32), scale=scale)

    @property
    def dim(self) -> int:
        return self.lo.shape[0]

    def transform(self, x) -> np.ndarray:
        """fp32 [n, dim] → int8 codes (out-of-range values saturate)."""
        x = np.asarray(x, np.float32)
        q = np.rint((x - self.lo) / self.scale) - 128.0
        return np.clip(q, -128, 127).astype(np.int8)

    def inverse_transform(self, codes) -> np.ndarray:
        """int8 codes → fp32 reconstruction (grid centers)."""
        c = np.asarray(codes, np.float32)
        return (c + 128.0) * self.scale + self.lo
