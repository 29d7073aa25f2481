"""R003 bad twin: the kernel library is built inside the batch loop."""
from raft_tpu_torch.ops import gpu_kernels as gk


def run_batches(batches, k):
    out = []
    for batch in batches:
        gk.build_all(["select_k"])
        out.append(gk.streaming_select_k(batch, k))
    return out
