"""Core layer: resources, the filter bitset, errors, logging, tracing and
the index file format (``serialize``)."""

from raft_tpu_torch.core import errors, logger, serialize, tracing
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import (IntegrityError, LogicError, RaftError,
                                        expects, fail)
from raft_tpu_torch.core.resources import Resources, ensure_resources

__all__ = ["Bitset", "IntegrityError", "LogicError", "RaftError", "Resources",
           "ensure_resources", "errors", "expects", "fail", "logger",
           "serialize", "tracing"]
