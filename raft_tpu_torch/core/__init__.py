"""Core layer: resources (and their round-robin pool,
``resources_manager``), the filter bitset, errors, logging, tracing,
cross-thread cancellation (``interruptible``), the index file format
(``serialize``) and the composable operators (``operators``)."""

from raft_tpu_torch.core import (errors, interruptible, logger, operators,
                                 resources_manager, serialize, tracing)
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import (IntegrityError, LogicError, RaftError,
                                        expects, fail)
from raft_tpu_torch.core.resources import (Resources, default_resources,
                                           ensure_resources)

__all__ = ["Bitset", "IntegrityError", "LogicError", "RaftError", "Resources",
           "default_resources", "ensure_resources", "errors", "expects",
           "fail", "interruptible", "logger", "operators",
           "resources_manager", "serialize", "tracing"]
