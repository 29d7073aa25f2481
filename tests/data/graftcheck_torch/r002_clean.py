"""R002 clean twin: the clamp is a tensor op, the branch on a shape."""
import torch


def search(dataset, queries, k):
    d = torch.cdist(queries, dataset).clamp_min(0)
    if d.shape[1] < k:
        raise ValueError("k exceeds the rows")
    return torch.topk(d, k, largest=False)
