"""Log facility (the port's copy of the root logger of
``uda_tpu/utils/logging.py``).

Equivalent of the reference logger (reference src/CommUtils/IOUtility.cc:
406-557): severity enum lsNONE..lsTRACE, either routed to the embedding
application through a registered sink (the ``logToJava`` up-call path,
UdaBridge.cc:440-452) or written to stderr. Every message carries a
``(file:line)`` suffix like the reference (IOUtility.cc:514-536), computed
only for messages that emit. The reference's private log files and named
child loggers are not ported yet.
"""

from __future__ import annotations

import enum
import os
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["LogLevel", "Logger", "get_logger"]


class LogLevel(enum.IntEnum):
    # Mirrors the severity enum in reference src/include/IOUtility.h
    NONE = 0
    FATAL = 1
    ERROR = 2
    WARN = 3
    INFO = 4
    DEBUG = 5
    TRACE = 6


_THIS_FILE = __file__


def _caller_suffix() -> str:
    """`` (file:line)`` of the first frame outside this module."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == _THIS_FILE:
        f = f.f_back
    if f is None:
        return ""
    return f" ({os.path.basename(f.f_code.co_filename)}:{f.f_lineno})"


class Logger:
    """Process-wide logger with an optional up-call sink: ``sink``
    receives ``(level, message)``; when unset, messages go to stderr."""

    def __init__(self, name: str = "uda_tpu_torch") -> None:
        self.name = name
        self.level = LogLevel.INFO
        self.sink: Optional[Callable[[int, str], None]] = None
        self._lock = threading.Lock()

    def set_level(self, level: int) -> None:
        self.level = LogLevel(max(0, min(6, int(level))))

    def set_sink(self, sink: Optional[Callable[[int, str], None]]) -> None:
        self.sink = sink

    def log(self, level: LogLevel, msg: str) -> None:
        if level > self.level or self.level == LogLevel.NONE:
            return
        text = f"{msg}{_caller_suffix()}"
        if self.sink is not None:
            self.sink(int(level), text)
            return
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        with self._lock:
            sys.stderr.write(f"{stamp} {level.name:5s} {self.name}: {text}\n")

    def fatal(self, msg: str) -> None:
        self.log(LogLevel.FATAL, msg)

    def error(self, msg: str) -> None:
        self.log(LogLevel.ERROR, msg)

    def warn(self, msg: str) -> None:
        self.log(LogLevel.WARN, msg)

    def info(self, msg: str) -> None:
        self.log(LogLevel.INFO, msg)

    def debug(self, msg: str) -> None:
        self.log(LogLevel.DEBUG, msg)

    def trace(self, msg: str) -> None:
        self.log(LogLevel.TRACE, msg)


_LOGGER = Logger()


def get_logger() -> Logger:
    """The root logger."""
    return _LOGGER
