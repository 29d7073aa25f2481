"""Resources — the per-call context: device, random generator, workspace.

Counterpart of ``raft_tpu.core.resources``. The JAX package's key stream
becomes an explicit ``torch.Generator`` on the resources' device. The
device is CUDA unless the caller asks for the CPU; with no GPU and no CPU
request, construction raises instead of carrying on quietly on the CPU.
(``solve_vmem_tiles`` sized TPU VMEM tiles; the kernels' own planners in
``ops.gpu_kernels`` take its place.)
"""

from __future__ import annotations

from typing import Optional, Union

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
    """Device, seeded generator and workspace budget for one caller.

    ``workspace_limit_bytes`` is the soft budget that sizes the tiles of the
    unfused search paths; by default a quarter of the card's memory, or
    2 GiB on the CPU."""

    def __init__(self, device: DeviceLike = None, seed: int = 0,
                 workspace_limit_bytes: Optional[int] = None):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._workspace_limit = workspace_limit_bytes

    @property
    def workspace_limit_bytes(self) -> int:
        if self._workspace_limit is not None:
            return int(self._workspace_limit)
        if self.device.type == "cuda":
            props = torch.cuda.get_device_properties(self.device)
            return int(props.total_memory * 0.25)
        return 2 << 30


def ensure_resources(res: Optional[Resources] = None,
                     device: DeviceLike = None) -> Resources:
    """``res`` as given, or fresh Resources on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    if res is None:
        return Resources(device=device)
    if device is not None and resolve_device(device) != res.device:
        raise ValueError(f"device={device} disagrees with res.device={res.device}")
    return res
