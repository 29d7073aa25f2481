"""Error types and validation helpers.

Counterpart of ``raft_tpu.core.errors`` (the reference's ``raft::exception``,
``logic_error``, ``RAFT_EXPECTS``, ``RAFT_FAIL``), with the same names and
fields, so that code written against one package classifies the other's
failures the same way. PyTorch raises its own exceptions for device errors.
"""

from __future__ import annotations


class RaftError(RuntimeError):
    """Base exception (raft::exception analog)."""


class LogicError(RaftError):
    """Precondition violation (raft::logic_error / RAFT_EXPECTS)."""


class IntegrityError(RaftError):
    """A checkpoint file failed validation: missing, truncated, or corrupt.

    ``path`` names the file, ``record`` the 0-based framed record inside it
    (None when the fault is file-level), and ``reason`` is one of
    ``"missing"``, ``"truncated"``, ``"corrupt"``, ``"torn_tail"``, so that
    callers (degraded-mode restore, pre-flight verification, log recovery)
    can branch without parsing messages. ``"torn_tail"`` belongs to
    append-only logs: the LAST frame is damaged and nothing follows it (a
    crash mid-append, recoverable by truncation), where the same damage
    mid-file is ``"corrupt"``.
    """

    def __init__(self, message: str, *, path=None, record=None, reason=None):
        super().__init__(message)
        self.path = path
        self.record = record
        self.reason = reason


def expects(condition: bool, message: str = "precondition violated") -> None:
    """``RAFT_EXPECTS(cond, msg)``: raise LogicError unless ``condition``.
    Host-side validation of shapes and parameters."""
    if not condition:
        raise LogicError(message)


def fail(message: str) -> None:
    """``RAFT_FAIL(msg)``: unconditional LogicError."""
    raise LogicError(message)
