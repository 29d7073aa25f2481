"""Runtime-checked execution, opt in (counterpart of
``raft_tpu.utils.debug``, whose ``checkify`` and ``jax_debug_nans`` play
the part of RAFT's sanitizers and ``RAFT_EXPECTS`` checks).

    from raft_tpu_torch.utils import debug

    checked_search = debug.checked(ivf_flat.search)
    dists, ids = checked_search(index, q, 10)   # raises on a NaN or Inf

    with debug.debug_mode():                    # every torch op checked
        cagra.build(db)

``checked(fn)`` checks the floating tensors that ``fn`` returns (the JAX
package's ``checkify`` checks each value produced inside). ``debug_mode``
is a scoped ``torch.overrides.TorchFunctionMode`` that checks the float
result of every torch function called in its scope, removed on exit. The
CUDA kernels are called through ctypes, so the mode does not see inside
them: only their outputs, once a torch op reads them. An out-of-bounds
gather raises ``IndexError`` on the CPU; on the card it is a device-side
assert that poisons the CUDA context, so there only the NaN and Inf checks
are usable.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.overrides import TorchFunctionMode

from raft_tpu_torch.core.resources import tensor_leaves

#: the checks ``checked`` runs by default: NaN and Inf in float outputs
DEFAULT_CHECKS = frozenset({"nan", "inf"})


def _check(out, nans: bool, infs: bool, where: str) -> None:
    for t in (t for t in tensor_leaves(out) if t.is_floating_point()):
        if nans and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"{where}: NaN in a float result")
        if infs and bool(torch.isinf(t).any()):
            raise FloatingPointError(f"{where}: Inf in a float result")


def checked(fn, checks=None):
    """``fn`` wrapped so that a NaN or Inf in a float tensor it returns
    raises ``FloatingPointError`` (``checks``: a subset of
    ``DEFAULT_CHECKS``); errors ``fn`` raises itself, such as an
    out-of-bounds index on the CPU, pass through."""
    checks = DEFAULT_CHECKS if checks is None else frozenset(checks)
    name = getattr(fn, "__qualname__", repr(fn))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        _check(out, "nan" in checks, "inf" in checks, name)
        return out

    return wrapper


class _CheckMode(TorchFunctionMode):
    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        _check(out, self.nans, self.infs, getattr(func, "__name__", str(func)))
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = False):
    """Check the float result of every torch function in the scope (the
    counterpart of ``jax_debug_nans`` / ``jax_debug_infs``): the first op
    that makes a NaN (or an Inf) raises ``FloatingPointError`` naming it.
    Heavy: wrap only the region under investigation."""
    with _CheckMode(nans, infs):
        yield
