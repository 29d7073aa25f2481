"""pylibraft-shaped namespace ``raft_tpu_torch.common`` (counterpart of
``raft_tpu.common``; ``pylibraft.common``: DeviceResources,
device_ndarray, the auto-sync decorators). The handle is ``Resources``;
``device_ndarray`` is a tensor on the card."""

from __future__ import annotations

import functools

import numpy as np
import torch

from raft_tpu_torch.core.resources import (Resources, default_resources,
                                           resolve_device, tensor_leaves)
from raft_tpu_torch.sparse.types import _narrow

#: pylibraft.common.DeviceResources → Resources
DeviceResources = Resources


def device_ndarray(array_like, dtype=None, device=None) -> torch.Tensor:
    """``array_like`` as a tensor on ``device`` (the current CUDA device
    unless the caller asks for the CPU). Host float64 and int64 data narrow
    to 32 bits as ``jnp.asarray`` narrows them; ``dtype`` (a numpy dtype)
    converts first."""
    dev = resolve_device(device)
    if isinstance(array_like, torch.Tensor) and dtype is None:
        return array_like.to(dev)
    a = np.asarray(array_like.cpu() if isinstance(array_like, torch.Tensor)
                   else array_like, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(
        a if dtype is not None else _narrow(a))).to(dev)


def auto_sync_resources(fn):
    """Decorator: pass the default Resources where ``res`` is None and wait
    for the result's tensors (the @auto_sync_handle pattern,
    neighbors/ivf_pq/ivf_pq.pyx:310-312)."""

    @functools.wraps(fn)
    def wrapper(*args, res=None, **kwargs):
        res = res or default_resources()
        out = fn(*args, res=res, **kwargs)
        res.sync(*tensor_leaves(out))
        return out

    return wrapper


def to_host(x) -> np.ndarray:
    """Device → host copy (auto_convert_output)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


__all__ = ["DeviceResources", "Resources", "device_ndarray",
           "auto_sync_resources", "to_host"]
