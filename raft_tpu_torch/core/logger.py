"""Logging and named trace ranges.

Counterpart of ``raft_tpu.core.logger``: the stdlib logger ``raft_tpu``
with an optional callback sink that receives ``(level, message)`` (the
reference's capture of C++ logs into Python), levels from ``trace`` to
``error``, and :func:`annotate`, a named range on the host timeline of a
``torch.profiler`` capture (``core.tracing.range``), where the JAX package
opens a ``jax.named_scope`` and a profiler annotation.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from raft_tpu_torch.core import tracing

_logger = logging.getLogger("raft_tpu")
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] [%(asctime)s] %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.WARNING)

_callback: Optional[Callable[[int, str], None]] = None


def get_logger() -> logging.Logger:
    return _logger


def set_level(level: int) -> None:
    """Set the log level (reference: logger::set_level)."""
    _logger.setLevel(level)


def set_callback(cb: Optional[Callable[[int, str], None]]) -> None:
    """Install a capture callback receiving (level, message); None removes
    it."""
    global _callback
    _callback = cb


def _emit(level: int, msg: str, *args) -> None:
    if args:
        msg = msg % args
    if _callback is not None:
        _callback(level, msg)
    _logger.log(level, msg)


def trace(msg, *args):
    _emit(logging.DEBUG - 5, msg, *args)


def debug(msg, *args):
    _emit(logging.DEBUG, msg, *args)


def info(msg, *args):
    _emit(logging.INFO, msg, *args)


def warn(msg, *args):
    _emit(logging.WARNING, msg, *args)


def error(msg, *args):
    _emit(logging.ERROR, msg, *args)


def annotate(name: str) -> tracing.range:
    """A named range (reference: common::nvtx::range) on the host timeline
    of a ``torch.profiler`` capture: ``with annotate("build"): ...``. It is
    :class:`raft_tpu_torch.core.tracing.range`, which owns the profiler
    scope."""
    return tracing.range(name)
