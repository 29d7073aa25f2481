"""R001 bad twin: a search entry point whose helper reads a tensor back."""
import torch


def _scores(queries, dataset):
    return queries @ dataset.T


def _pick(d, k):
    kth = torch.topk(d, k, dim=1).values[:, -1].max().item()
    return d <= kth


def search(dataset, queries, k):
    return _pick(_scores(queries, dataset), k)
