"""R005 bad twin: the probed slabs are gathered whole, unplanned."""
import torch


def search(queries, lists, probes, k):
    t, p = probes.shape
    pad, dim = lists.shape[1], lists.shape[2]
    slabs = lists[probes].reshape(t, p, pad, dim)
    d = (slabs * queries[:, None, None, :]).sum(-1)
    return torch.topk(d.reshape(t, p * pad), k)
