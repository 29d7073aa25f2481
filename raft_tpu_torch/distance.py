"""pylibraft-shaped namespace ``raft_tpu_torch.distance`` (counterpart of
``raft_tpu.distance``; ``pylibraft.distance``: pairwise_distance,
fused_l2_nn_argmin). The functions live in ``ops.distance``,
``ops.fused_l2_nn`` and ``ops.kernels``."""

from raft_tpu_torch.ops import kernels  # noqa: F401  (distance::kernels)
from raft_tpu_torch.ops.distance import (  # noqa: F401
    DistanceType,
    is_min_close,
    pairwise_distance,
    resolve_metric,
)
from raft_tpu_torch.ops.fused_l2_nn import (  # noqa: F401
    fused_l2_nn_argmin,
    masked_l2_nn_argmin,
)

DISTANCE_TYPES = [t.name for t in DistanceType]

__all__ = ["DistanceType", "DISTANCE_TYPES", "pairwise_distance",
           "fused_l2_nn_argmin", "masked_l2_nn_argmin", "is_min_close",
           "resolve_metric", "kernels"]
