"""pylibraft-parity alias: pylibraft.neighbors.rbc (random ball cover)."""

from raft_tpu_torch.neighbors.ball_cover import *  # noqa: F401,F403
from raft_tpu_torch.neighbors.ball_cover import (BallCoverIndex,  # noqa: F401
                                                 build, knn)

__all__ = ["BallCoverIndex", "build", "knn"]
