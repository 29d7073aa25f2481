"""R003 clean twin: the build is hoisted out of the loop."""
from raft_tpu_torch.ops import gpu_kernels as gk


def run_batches(batches, k):
    gk.build_all(["select_k"])
    out = []
    for batch in batches:
        out.append(gk.streaming_select_k(batch, k))
    return out
