"""Resources, tracing ranges and the filter bitset."""

from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources, ensure_resources
