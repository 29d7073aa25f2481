"""The sharded path (counterpart of ``raft_tpu.parallel``): a communicator
over a list of devices driven from one process, sharded index builds and
searches with the cross-rank top-k merge ladder, and sharded checkpoints
with their strict and elastic restores."""

from raft_tpu_torch.parallel import comms, sharded
from raft_tpu_torch.parallel.comms import (Comms, ReduceOp, init_comms,
                                           init_distributed, inject_comms)
from raft_tpu_torch.parallel.sharded import (ElasticIvfFlat, ElasticIvfPq,
                                             SearchResult)

__all__ = ["comms", "sharded", "Comms", "ElasticIvfFlat", "ElasticIvfPq",
           "ReduceOp", "SearchResult", "init_comms", "init_distributed",
           "inject_comms"]
