"""R005 clean twin: the query tile is solved from the workspace budget."""
import torch

from raft_tpu_torch.neighbors.ivf_flat import plan_scan_tiles


def _tile(queries, lists, probes, k):
    t, p = probes.shape
    pad, dim = lists.shape[1], lists.shape[2]
    slabs = lists[probes].reshape(t, p, pad, dim)
    d = (slabs * queries[:, None, None, :]).sum(-1)
    return torch.topk(d.reshape(t, p * pad), k)


def search(queries, lists, probes, k, workspace_limit_bytes):
    q_tile = plan_scan_tiles(probes.shape[1], lists.shape[1],
                             lists.shape[2], workspace_limit_bytes)
    return [_tile(queries[s:s + q_tile], lists, probes[s:s + q_tile], k)
            for s in range(0, queries.shape[0], q_tile)]
