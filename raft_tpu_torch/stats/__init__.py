"""Search quality metrics."""

from raft_tpu_torch.stats.recall import neighborhood_recall
