"""The sharded path (counterpart of ``raft_tpu.parallel``): a communicator
over a list of devices driven from one process, sharded index builds and
searches with the cross-rank top-k merge ladder, sharded checkpoints
with their strict and elastic restores, and the host point-to-point
channel (``HostP2P``) the remote serving replicas ride."""

from raft_tpu_torch.parallel import comms, host_p2p, sharded
from raft_tpu_torch.parallel.comms import (Comms, ReduceOp, init_comms,
                                           init_distributed, inject_comms)
from raft_tpu_torch.parallel.host_p2p import HostP2P, PeerDrained
from raft_tpu_torch.parallel.sharded import (ElasticIvfFlat, ElasticIvfPq,
                                             SearchResult)

__all__ = ["comms", "host_p2p", "sharded", "Comms", "ElasticIvfFlat",
           "ElasticIvfPq", "HostP2P", "PeerDrained", "ReduceOp",
           "SearchResult", "init_comms", "init_distributed", "inject_comms"]
