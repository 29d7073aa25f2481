"""Resources — the per-call context: device, random generator, workspace.

Counterpart of ``raft_tpu.core.resources``. The JAX package's key stream
becomes an explicit ``torch.Generator`` on the resources' device. The
device is CUDA unless the caller asks for the CPU; with no GPU and no CPU
request, construction raises instead of carrying on quietly on the CPU.
(``solve_vmem_tiles`` sized TPU VMEM tiles; the kernels' own planners in
``ops.gpu_kernels`` take its place.)
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; ``"cpu"`` runs the plain
    PyTorch versions of the kernels on the CPU."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "raft_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (or Resources(device='cpu')) to run the "
                "plain PyTorch versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: expected cuda or cpu")
    return device


class Resources:
    """Device, seeded generator and memory budgets for one caller.

    ``workspace_limit_bytes`` is the soft budget that sizes the tiles of the
    unfused search paths; by default a quarter of the card's memory, or
    2 GiB on the CPU.

    ``device_memory_bytes`` is the device memory this caller may hold, the
    counterpart of XLA's ``bytes_limit`` that a JAX process reads from its
    client memory fraction. Engine choices that must not run the card out of
    memory read it (``ivf_pq`` ``scan_mode="auto"``). PyTorch has no
    per-process limit that could be read without also capping every
    allocation, so a caller that holds only a share of the card states it
    here. By default: the card's memory times PyTorch's per-process memory
    fraction on CUDA, and None (unknown) on the CPU."""

    def __init__(self, device: DeviceLike = None, seed: int = 0,
                 workspace_limit_bytes: Optional[int] = None,
                 device_memory_bytes: Optional[int] = None):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._workspace_limit = workspace_limit_bytes
        self._device_memory = device_memory_bytes

    @property
    def device_memory_bytes(self) -> Optional[int]:
        if self._device_memory is not None:
            return int(self._device_memory)
        if self.device.type != "cuda":
            return None
        total = torch.cuda.get_device_properties(self.device).total_memory
        fraction = getattr(torch.cuda, "get_per_process_memory_fraction", None)
        if fraction is None:
            return int(total)
        return int(total * fraction(self.device))

    @property
    def workspace_limit_bytes(self) -> int:
        if self._workspace_limit is not None:
            return int(self._workspace_limit)
        if self.device.type == "cuda":
            props = torch.cuda.get_device_properties(self.device)
            return int(props.total_memory * 0.25)
        return 2 << 30


def solve_joint_tiles(budget_bytes: int, bytes_per_cell: int, inner_max: int,
                      outer_cap: int = 256, outer_multiple: int = 8
                      ) -> Tuple[int, int]:
    """Size an (outer_tile, inner_tile) loop nest so that the peak live set
    ``outer_tile · inner_tile · bytes_per_cell`` stays within
    ``budget_bytes`` (the same solve as ``raft_tpu.core.resources``).

    The full inner extent with the largest outer tile is preferred; when
    even a minimal outer tile cannot hold the full inner extent the inner
    tile shrinks instead, down to (1, 1) when a single cell exceeds the
    budget (the loop still runs; past that point the budget is a target).
    ``outer_tile`` is a multiple of ``outer_multiple`` (when >= it) capped at
    ``outer_cap``; ``1 <= inner_tile <= inner_max``."""
    budget = max(int(budget_bytes), 1)
    cell = max(int(bytes_per_cell), 1)
    inner_max = max(int(inner_max), 1)
    outer = budget // (cell * inner_max)
    if outer >= outer_multiple:
        outer = min(outer, outer_cap)
        outer -= outer % outer_multiple
        return outer, inner_max
    outer = outer_multiple if budget // (outer_multiple * cell) >= 1 else 1
    inner = int(np.clip(budget // (outer * cell), 1, inner_max))
    return outer, inner


def ensure_resources(res: Optional[Resources] = None,
                     device: DeviceLike = None) -> Resources:
    """``res`` as given, or fresh Resources on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    if res is None:
        return Resources(device=device)
    if device is not None and resolve_device(device) != res.device:
        raise ValueError(f"device={device} disagrees with res.device={res.device}")
    return res
