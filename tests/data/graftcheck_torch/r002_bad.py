"""R002 bad twin: a Python branch on a tensor value on the request path."""
import torch


def search(dataset, queries, k):
    d = torch.cdist(queries, dataset)
    if torch.any(d < 0):
        d = d.clamp_min(0)
    return torch.topk(d, k, largest=False)
