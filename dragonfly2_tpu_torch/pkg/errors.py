"""Coded errors: the port's own copy of ``Code``, ``DfError``,
``StorageError``, ``SourceError`` and ``describe``
(``dragonfly2_tpu/pkg/errors.py``).

The daemon reports a failed task as a wire dict (``progress.error``); the
port decodes it with ``DfError.from_wire`` and must land on the same code
the JAX package would, so every numeric value here equals the JAX
package's.
"""

from __future__ import annotations

import enum
from typing import Any


class Code(enum.IntEnum):
    """Error and status codes (commonv1.Code semantics)."""

    Success = 200

    ServerUnavailable = 500
    ResourceLacked = 501
    BadRequest = 400
    Unauthorized = 401
    PeerTaskNotFound = 404
    NotFound = 404              # alias: generic REST not-found
    InvalidArgument = 422
    UnknownError = 1000
    RequestTimeout = 1001

    SchedError = 5000
    SchedNeedBackSource = 5001
    SchedPeerGone = 5002
    SchedPeerNotFound = 5004
    SchedPeerPieceResultReportFail = 5005
    SchedTaskStatusError = 5006
    SchedReregister = 5007

    CDNTaskRegistryFail = 6001
    CDNTaskNotFound = 6404

    ClientError = 4000
    ClientPieceRequestFail = 4001
    ClientScheduleTimeout = 4002
    ClientContextCanceled = 4003
    ClientWaitPieceReady = 4004
    ClientPieceDownloadFail = 4005
    ClientRequestLimitFail = 4006
    ClientConnectionError = 4007
    ClientBackSourceError = 4008
    ClientPieceNotFound = 4404

    ManagerError = 7000
    InvalidResourceType = 7001

    StorageError = 8000
    StoragePieceNotFound = 8404
    StorageTaskNotFound = 8405

    BackToSourceAborted = 9000
    UnsupportedProtocol = 9001
    SourceNotFound = 9404
    SourceForbidden = 9403
    SourceRangeUnsupported = 9416


def describe(e: BaseException) -> str:
    """Never-empty error text: a bare TimeoutError or CancelledError
    stringifies to ''."""
    return str(e) or type(e).__name__


class DfError(Exception):
    """A coded error: ``code``, a human ``message`` and JSON-safe
    ``metadata``. An unknown code (a newer peer) decodes as
    ``UnknownError`` and keeps the raw value in ``metadata["raw_code"]``."""

    def __init__(self, code: Code | int, message: str = "",
                 metadata: dict[str, Any] | None = None):
        try:
            parsed = Code(code)
        except ValueError:
            parsed = Code.UnknownError
            metadata = dict(metadata or {})
            metadata["raw_code"] = int(code)
        super().__init__(message or parsed.name)
        self.code = parsed
        self.message = message or parsed.name
        self.metadata = metadata or {}

    def to_wire(self) -> dict[str, Any]:
        return {"code": int(self.code), "message": self.message,
                "metadata": self.metadata}

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "DfError":
        return cls(d.get("code", Code.UnknownError), d.get("message", ""),
                   d.get("metadata") or {})


class StorageError(DfError):
    def __init__(self, message: str = "", code: Code = Code.StorageError):
        super().__init__(code, message)


class SourceError(DfError):
    """An origin fetch failed; ``temporary`` says whether a retry may
    succeed."""

    def __init__(self, message: str = "",
                 code: Code = Code.BackToSourceAborted,
                 temporary: bool = False):
        super().__init__(code, message, {"temporary": temporary})
        self.temporary = temporary
