"""Resources — the per-call context: device, random generator, workspace.

Counterpart of ``raft_tpu.core.resources``. The JAX package's key stream
becomes an explicit ``torch.Generator`` on the resources' device. The
device is CUDA unless the caller asks for the CPU; with no GPU and no CPU
request, construction raises instead of carrying on quietly on the CPU.
(``solve_vmem_tiles`` sized TPU VMEM tiles; the kernels' own planners in
``ops.gpu_kernels`` take its place.)
"""

from __future__ import annotations

import threading
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
        self._comms = None  # set by parallel.comms.inject_comms

    @property
    def comms(self):
        """The injected communicator (``parallel.comms.Comms``); raises when
        none was injected."""
        if self._comms is None:
            raise RuntimeError(
                "No communicator injected into this Resources; call "
                "raft_tpu_torch.parallel.comms.inject_comms(res, ...) first.")
        return self._comms

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

    def sync(self, *tensors) -> None:
        """Wait for the work queued on the resources' device
        (``resource::sync_stream``): the whole CUDA device, whatever
        ``tensors`` are given (the JAX package waits for those arrays); on
        the CPU, where every op has finished when it returns, nothing."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


_default_resources: Optional[Resources] = None
_default_lock = threading.Lock()


def default_resources() -> Resources:
    """The process-wide default Resources on the current CUDA device
    (core/device_resources_manager.hpp:36-95), made at the first call;
    raises where there is no CUDA device."""
    global _default_resources
    with _default_lock:
        if _default_resources is None:
            _default_resources = Resources()
        return _default_resources


def tensor_leaves(out) -> list:
    """The tensors of a result: a tensor, or tensors nested in tuples, lists
    and dicts (the leaves ``jax.tree_util.tree_leaves`` would give)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensor_leaves(o)]
    return []


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


def as_tensors(*arrays, device: DeviceLike = None):
    """The arrays as tensors on one device: ``device`` when given, else the
    device of the first tensor among them, else CUDA (unless the caller asks
    for the CPU). A tensor already there is returned as it is; ``None``
    stays ``None``. Host arrays keep their dtype. Returns a tuple."""
    if device is None:
        dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
                   None) or resolve_device(None)
    else:
        dev = resolve_device(device)
    out = []
    for a in arrays:
        if a is None or (isinstance(a, torch.Tensor) and a.device == dev):
            out.append(a)
        elif isinstance(a, torch.Tensor):
            out.append(a.to(dev))
        else:
            out.append(torch.as_tensor(np.asarray(a)).to(dev))
    return tuple(out)


def solve_merge_bytes(size: int, nq: int, kk: int, k_out: int,
                      val_bytes: int = 4, idx_bytes: int = 4,
                      pos_bytes: int = 4) -> dict:
    """Predicted bytes each rank receives in each sharded top-k merge engine
    (``parallel.sharded`` ``merge_mode``; the same model as
    ``raft_tpu.core.resources``):

    - ``allgather``: every rank holds the whole [nq, size·kk] value + id
      slab; (size-1)/size of it comes from the other ranks.
    - ``tree``: log₂(size) hypercube rounds; round r receives a
      min(k_out, kk·2^r)-wide (value, pos, id) carry from the partner.
    - ``ring``: size-1 hops of the fixed [nq, kk] (value, pos, id) block.

    A size that is not a power of two never takes the tree (dispatch falls
    back to allgather), so its tree entry is the allgather cost."""
    size, nq, kk, k_out = int(size), int(nq), int(kk), int(k_out)
    pair = val_bytes + idx_bytes
    triple = pair + pos_bytes
    out = {
        "allgather": (size - 1) * nq * kk * pair,
        "ring": (size - 1) * nq * kk * triple,
    }
    tree = 0
    width, step = kk, 1
    while step < size:
        tree += nq * width * triple
        width = min(k_out, 2 * width)
        step *= 2
    out["tree"] = tree if size >= 2 and (size & (size - 1)) == 0 \
        else out["allgather"]
    return out


def solve_host_tier(n_lists: int, list_pad: int, rot_dim: int,
                    n_code_bytes: int, workspace_limit_bytes: int,
                    n_probes: int = 20, max_batch: int = 64,
                    cache_itemsize: int = 2, arena_fraction: float = 0.5,
                    host_bw_bytes_per_s: float = 8e9) -> dict:
    """Byte model of the tiered IVF-PQ index (``neighbors.tiered``), the
    same as ``raft_tpu.core.resources.solve_host_tier``: the slab arena's
    size from the workspace budget, the host tier's bytes and a slab
    fetch's cost.

    One arena slot holds a decoded list:
    ``slab_bytes = list_pad·(rot_dim·cache_itemsize + 4 + 4) + 4`` (decoded
    residuals, f32 norms, int32 ids, the int32 size), exactly the ``nbytes``
    of ``SlabArena``'s four tensors a slot. ``arena_fraction`` of the
    workspace goes to slots, at least ``n_probes`` (one query's probes) and
    at most ``n_lists``. The host keeps the packed codes, ids and norms of
    every list and the sizes. ``worst_batch_distinct`` is what one batch
    may probe (``max_batch·n_probes`` lists at most), which the arena must
    hold at once or the resolve raises ``TieredArenaError``."""
    n_lists = max(int(n_lists), 1)
    list_pad = max(int(list_pad), 1)
    slab_bytes = list_pad * (rot_dim * cache_itemsize + 4 + 4) + 4
    arena_budget = int(max(workspace_limit_bytes, 0) * arena_fraction)
    floor_slots = min(n_lists, max(int(n_probes), 1))
    arena_slots = int(np.clip(arena_budget // max(slab_bytes, 1),
                              floor_slots, n_lists))
    host_bytes_per_list = list_pad * (n_code_bytes + 4 + 4)
    fetch_bytes = list_pad * (n_code_bytes + 4 + 4) + 4
    worst = min(n_lists, int(max_batch) * max(int(n_probes), 1))
    return {
        "arena_slots": arena_slots,
        "slab_bytes": slab_bytes,
        "arena_bytes": arena_slots * slab_bytes,
        "host_bytes": n_lists * host_bytes_per_list + 4 * n_lists,
        "fetch_bytes_per_slab": fetch_bytes,
        "predicted_fetch_s": fetch_bytes / max(host_bw_bytes_per_s, 1.0),
        "worst_batch_distinct": worst,
    }
