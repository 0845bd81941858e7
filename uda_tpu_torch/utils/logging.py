"""Log facility (the port's copy of the root logger of
``uda_tpu/utils/logging.py``).

Equivalent of the reference logger (reference src/CommUtils/IOUtility.cc:
406-557): severity enum lsNONE..lsTRACE, either routed to the embedding
application through a registered sink (the ``logToJava`` up-call path,
UdaBridge.cc:440-452) or written to stderr. Every message carries a
``(file:line)`` suffix like the reference (IOUtility.cc:514-536), computed
only for messages that emit. Named child loggers (``get_logger("uda.stats")``)
share the root's output and carry their own level. The reference's private
log files are not ported yet.
"""

from __future__ import annotations

import enum
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

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
    receives ``(level, message)``; when unset, messages go to stderr.
    A child logger (``parent`` set) writes through its parent and
    inherits its level until :meth:`set_level` is called."""

    def __init__(self, name: str = "uda_tpu_torch",
                 parent: Optional["Logger"] = None) -> None:
        self.name = name
        self.parent = parent
        self.level: Optional[LogLevel] = None if parent else LogLevel.INFO
        self.sink: Optional[Callable[[int, str], None]] = None
        self._lock = threading.Lock()

    def effective_level(self) -> LogLevel:
        node: Optional[Logger] = self
        while node is not None:
            if node.level is not None:
                return node.level
            node = node.parent
        return LogLevel.INFO

    def set_level(self, level: int) -> None:
        self.level = LogLevel(max(0, min(6, int(level))))

    def clear_level(self) -> None:
        """Child loggers only: drop the override, inherit the root's."""
        if self.parent is not None:
            self.level = None

    def set_sink(self, sink: Optional[Callable[[int, str], None]]) -> None:
        self.sink = sink

    def log(self, level: LogLevel, msg: str) -> None:
        eff = self.effective_level()
        if level > eff or eff == LogLevel.NONE:
            return
        text = f"{msg}{_caller_suffix()}"
        out: Logger = self
        while out.parent is not None and out.sink is None:
            out = out.parent
        if out.sink is not None:
            out.sink(int(level), text)
            return
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        with out._lock:
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
_NAMED: Dict[str, Logger] = {}
_NAMED_LOCK = threading.Lock()


def get_logger(name: Optional[str] = None) -> Logger:
    """The root logger (no name) or a named child sharing the root's
    output with a level of its own."""
    if name is None or name == _LOGGER.name:
        return _LOGGER
    with _NAMED_LOCK:
        lg = _NAMED.get(name)
        if lg is None:
            lg = _NAMED[name] = Logger(name, parent=_LOGGER)
        return lg
