"""Pooled Resources per device for multi-threaded servers (counterpart of
``raft_tpu.core.resources_manager``; RAFT's
core/device_resources_manager.hpp:36-95).

A process-wide pool hands out Resources round-robin, so that server
threads share a few generators and budgets instead of each building its
own. The options are frozen at the first hand-out, as the reference
ignores later changes. Seeds are ``1000 + device_index·101 + i`` (the JAX
package's, the device index 0 on the CPU); the default device is the
current CUDA device, ``device="cpu"`` a CPU pool.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from raft_tpu_torch.core.resources import Resources, resolve_device


class _Manager:
    def __init__(self):
        self._lock = threading.Lock()
        self._pools: Dict[torch.device, List[Resources]] = {}  # guarded_by: _lock
        self._next: Dict[torch.device, int] = {}  # guarded_by: _lock
        self._pool_size = 1  # guarded_by: _lock
        self._workspace_limit: Optional[int] = None  # guarded_by: _lock
        self._frozen = False  # guarded_by: _lock

    def set_resources_per_device(self, n: int) -> None:
        """The pool's width per device (``set_streams_per_device``); no
        effect after the first hand-out."""
        with self._lock:
            if not self._frozen:
                self._pool_size = max(int(n), 1)

    def set_workspace_limit(self, n_bytes: int) -> None:
        """Every pooled Resources' workspace budget; no effect after the
        first hand-out."""
        with self._lock:
            if not self._frozen:
                self._workspace_limit = int(n_bytes)

    def get_resources(self, device=None) -> Resources:
        """The next pooled Resources of ``device`` (the current CUDA device
        unless the caller asks for the CPU), round-robin
        (``get_device_resources``)."""
        device = resolve_device(device)
        did = device.index or 0
        with self._lock:
            self._frozen = True
            pool = self._pools.get(device)
            if pool is None:
                pool = [Resources(device=device, seed=1000 + did * 101 + i,
                                  workspace_limit_bytes=self._workspace_limit)
                        for i in range(self._pool_size)]
                self._pools[device] = pool
                self._next[device] = 0
            i = self._next[device]
            self._next[device] = (i + 1) % len(pool)
            return pool[i]

    def reset(self) -> None:
        """Drop every pool and unfreeze the options (for tests)."""
        with self._lock:
            self._pools.clear()
            self._next.clear()
            self._pool_size = 1
            self._workspace_limit = None
            self._frozen = False


_manager = _Manager()

set_resources_per_device = _manager.set_resources_per_device
set_workspace_limit = _manager.set_workspace_limit
get_resources = _manager.get_resources
reset = _manager.reset
