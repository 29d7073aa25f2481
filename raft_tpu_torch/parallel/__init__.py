"""The sharded path (counterpart of ``raft_tpu.parallel``): a communicator
over a list of devices driven from one process, and sharded index builds
and searches with the cross-rank top-k merge ladder."""

from raft_tpu_torch.parallel import comms, sharded
from raft_tpu_torch.parallel.comms import (Comms, ReduceOp, init_comms,
                                           init_distributed, inject_comms)

__all__ = ["comms", "sharded", "Comms", "ReduceOp", "init_comms",
           "init_distributed", "inject_comms"]
