"""Structured, per-subsystem logging.

Reference: internal/dflog (zap loggers with per-concern rotating files —
logcore.go, logger.go:34-37). We use stdlib logging with a compact
structured formatter and optional per-subsystem rotating files.

The PyTorch port keeps its own copy of the JAX package's logger: the port
imports nothing from ``dragonfly2_tpu``. Both write under the ``df``
logger, so a process that runs both packages gets one log stream.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
import time
from typing import Any

_CONFIGURED = False
_LOG_DIR: str | None = None


class _KVFormatter(logging.Formatter):
    """``ts level subsystem msg key=value...`` single-line format."""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(record.created))
        base = f"{ts}.{int(record.msecs):03d} {record.levelname:<5} {record.name} {record.getMessage()}"
        extras = getattr(record, "df_kv", None)
        if extras:
            kv = " ".join(f"{k}={v}" for k, v in extras.items())
            base = f"{base} {kv}"
        if record.exc_info:
            base = f"{base}\n{self.formatException(record.exc_info)}"
        return base


def configure(log_dir: str | None = None, console: bool = True, level: str = "INFO") -> None:
    """Initialize (or re-initialize) root logging. A later call with a
    log_dir upgrades an earlier default console-only setup, so import-time
    loggers never freeze the config."""
    global _CONFIGURED, _LOG_DIR
    if _CONFIGURED and (log_dir is None or log_dir == _LOG_DIR):
        # Never downgrade: argless calls (e.g. from get()) keep whatever a
        # real configure(log_dir=...) already installed.
        return
    root = logging.getLogger("df")
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False
    if console:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_KVFormatter())
        root.addHandler(h)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        _LOG_DIR = log_dir
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "core.log"), maxBytes=64 << 20, backupCount=3
        )
        fh.setFormatter(_KVFormatter())
        root.addHandler(fh)
    _CONFIGURED = True


class Logger:
    """Subsystem logger with bound key=value context, like zap's With()."""

    def __init__(self, subsystem: str, **ctx: Any):
        self._log = logging.getLogger(f"df.{subsystem}")
        self._ctx = ctx

    def with_values(self, **ctx: Any) -> "Logger":
        merged = dict(self._ctx)
        merged.update(ctx)
        out = Logger.__new__(Logger)
        out._log = self._log
        out._ctx = merged
        return out

    def _emit(self, level: int, msg: str, kv: dict[str, Any], exc_info=None) -> None:
        merged = dict(self._ctx)
        merged.update(kv)
        self._log.log(level, msg, extra={"df_kv": merged}, exc_info=exc_info)

    def debug(self, msg: str, **kv: Any) -> None:
        self._emit(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._emit(logging.INFO, msg, kv)

    def warning(self, msg: str, **kv: Any) -> None:
        self._emit(logging.WARNING, msg, kv)

    def error(self, msg: str, exc_info=None, **kv: Any) -> None:
        self._emit(logging.ERROR, msg, kv, exc_info=exc_info)


def get(subsystem: str, **ctx: Any) -> Logger:
    configure()
    return Logger(subsystem, **ctx)
