"""Distances, selection, the fused 1-NN, random draws and the hand-written
kernels (counterpart of ``raft_tpu.ops``, with the same public names).

As in the JAX package, ``ops.select_k`` is the function: a module that
needs the ``select_k`` module itself imports it by its full path
(``importlib.import_module("raft_tpu_torch.ops.select_k")``). The kernels
live in ``ops.gpu_kernels``; ``kernels`` (Gram matrices), ``linalg`` and
``matrix`` are torch glue, as they are XLA glue in the JAX package."""

from raft_tpu_torch.ops.distance import (DistanceType, is_min_close,
                                         pairwise_distance, resolve_metric,
                                         row_norms_sq)
from raft_tpu_torch.ops.fused_l2_nn import (fused_l2_nn_argmin,
                                            masked_l2_nn_argmin)
from raft_tpu_torch.ops.select_k import (SelectAlgo, merge_topk_dedup,
                                         select_k, select_k_filtered)
from raft_tpu_torch.ops import kernels, linalg, matrix, rng

__all__ = [
    "DistanceType",
    "pairwise_distance",
    "resolve_metric",
    "is_min_close",
    "row_norms_sq",
    "SelectAlgo",
    "select_k",
    "select_k_filtered",
    "merge_topk_dedup",
    "fused_l2_nn_argmin",
    "masked_l2_nn_argmin",
    "kernels",
    "linalg",
    "matrix",
    "rng",
]
