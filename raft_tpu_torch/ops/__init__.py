"""Distances, selection and the hand-written kernels."""

from raft_tpu_torch.ops.select_k import select_k_filtered

__all__ = ["select_k_filtered"]
