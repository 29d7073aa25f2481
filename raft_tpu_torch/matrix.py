"""pylibraft-parity namespace: ``raft_tpu_torch.matrix`` (counterpart of
``raft_tpu.matrix``, mirroring ``pylibraft.matrix``: select_k); the whole
matrix surface is in ``ops.matrix``."""

from raft_tpu_torch.ops.matrix import *  # noqa: F401,F403
from raft_tpu_torch.ops.matrix import SelectAlgo, select_k  # noqa: F401

__all__ = ["select_k", "SelectAlgo"]
