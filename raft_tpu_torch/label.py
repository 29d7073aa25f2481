"""Label utilities (counterpart of ``raft_tpu.label``; RAFT's
label/classlabels.cuh and merge_labels.cuh).

``get_unique_labels`` and ``make_monotonic`` keep the JAX package's static
capacity: ``jnp.unique(size=max_labels, fill_value=...)`` keeps the first
``max_labels`` sorted values and pads the rest with the fill, which is
reproduced here over ``torch.unique``. ``merge_labels`` is the same bounded
fixpoint of scatter-mins as the JAX package's ``while_loop``, reading the
"changed" flag back once a round. Negative labels index from the end, as
JAX's indexing does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.resources import as_tensors

_INT32_MAX = torch.iinfo(torch.int32).max


def _unique_padded(values: torch.Tensor, size: int, fill: int
                   ) -> torch.Tensor:
    """The first ``size`` sorted unique values, padded with ``fill``."""
    u = torch.unique(values, sorted=True)[:size]
    pad = u.new_full((size - u.shape[0],), fill)
    return torch.cat([u, pad])


def get_unique_labels(labels, max_labels: int, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique labels padded to ``max_labels`` with -1, and the count
    of non-negative ones (classlabels.cuh getUniquelabels; the capacity is
    static). Tensors stay on their device; host arrays go to ``device``
    (CUDA unless the caller asks for the CPU)."""
    labels, = as_tensors(labels, device=device)
    labels = labels.to(torch.int32).reshape(-1)
    uniq = _unique_padded(labels, int(max_labels), -1)
    return uniq, (uniq >= 0).sum().to(torch.int32)


def make_monotonic(labels, max_labels: int, device=None) -> torch.Tensor:
    """Each label's rank among the (first ``max_labels``) unique labels
    (classlabels.cuh make_monotonic); negative labels pass through."""
    labels, = as_tensors(labels, device=device)
    labels = labels.to(torch.int32)
    keyed = torch.where(labels < 0, _INT32_MAX, labels)
    uniq = _unique_padded(keyed.reshape(-1), int(max_labels), _INT32_MAX)
    rank = torch.searchsorted(uniq, labels.contiguous()).to(torch.int32)
    return torch.where(labels < 0, labels, rank)


def merge_labels(labels_a, labels_b, max_iters: int = 32, device=None
                 ) -> torch.Tensor:
    """The finest common coarsening of two labelings: rows that share a
    label in either input end up with the same (smallest) output label
    (merge_labels.cuh). Min-propagation through both label tables until
    nothing changes, at most ``max_iters`` rounds."""
    a, b = as_tensors(labels_a, labels_b, device=device)
    n = a.shape[0]
    # JAX's indexing takes a negative label from the end
    a = torch.where(a < 0, a + n, a).to(torch.int64)
    b = torch.where(b < 0, b + n, b).to(torch.int64)
    out = torch.arange(n, dtype=torch.int32, device=a.device)

    def propagate(cur, lab):
        gmin = torch.full((n,), _INT32_MAX, dtype=torch.int32,
                          device=cur.device).scatter_reduce_(
                              0, lab, cur, "amin", include_self=True)
        return torch.minimum(cur, gmin[lab])

    for _ in range(int(max_iters)):
        new = propagate(propagate(out, a), b)
        changed = bool((new != out).any())
        out = new
        if not changed:
            break
    return out
