"""Structured logging: the part of ``paddle_tpu.utils.log`` that the
serving engine uses.

- :func:`get_logger`: a classic logger with the reference's format;
  its level comes from ``PT_LOG_LEVEL`` (a name or a number), else from
  ``GLOG_v`` (0 = warning, 1 = info, 2+ = debug).
- :func:`log_kv`: one ``event key=value ...`` line through a logger.
- :func:`log_event`: one structured event into the process event log,
  an in-memory ring (plus a JSON-lines file when ``PADDLE_LOG_DIR`` is
  set when the log is first used).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from collections import deque

__all__ = ["get_logger", "kv_line", "log_kv", "EventLog", "log_event",
           "default_event_log"]

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

_LEVEL_NAMES = {"debug": logging.DEBUG, "info": logging.INFO,
                "warning": logging.WARNING, "warn": logging.WARNING,
                "error": logging.ERROR, "critical": logging.CRITICAL}


def _glog_level() -> int:
    pt = os.environ.get("PT_LOG_LEVEL", "").strip().lower()
    if pt:
        if pt in _LEVEL_NAMES:
            return _LEVEL_NAMES[pt]
        try:
            return int(pt)
        except ValueError:
            pass
    try:
        v = int(os.environ.get("GLOG_v", "0"))
    except ValueError:
        v = 0
    return {0: logging.WARNING, 1: logging.INFO}.get(v, logging.DEBUG)


def get_logger(name, level=None, fmt=_FMT):
    """A configured logger that does not propagate to the root logger."""
    logger = logging.getLogger(name)
    logger.setLevel(level if level is not None else _glog_level())
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(fmt))
        logger.addHandler(h)
    logger.propagate = False
    return logger


def kv_line(event: str, **fields) -> str:
    """``event key=value key=value``."""
    if not fields:
        return event
    return event + " " + " ".join(f"{k}={v}" for k, v in fields.items())


def log_kv(logger, event: str, *, level=logging.INFO, **fields) -> str:
    """Emit a ``key=value`` line through ``logger``; returns the line."""
    line = kv_line(event, **fields)
    logger.log(level, line)
    return line


class EventLog:
    """JSON-lines structured event stream with an in-memory ring."""

    def __init__(self, path=None, ring_size=1024):
        self._path = path
        self._file = None
        self.ring = deque(maxlen=ring_size)

    def emit(self, event: str, **fields):
        rec = {"ts": round(time.time(), 3), "event": event,
               "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0")),
               **fields}
        self.ring.append(rec)
        if self._path:
            if self._file is None:
                os.makedirs(os.path.dirname(self._path) or ".",
                            exist_ok=True)
                self._file = open(self._path, "a")
            self._file.write(json.dumps(rec, default=str) + "\n")
            self._file.flush()
        return rec

    def events(self, event=None):
        return [r for r in self.ring if event is None or r["event"] == event]


_DEFAULT: list[EventLog] = []


def default_event_log() -> EventLog:
    """The process event log, created on first use."""
    if not _DEFAULT:
        d = os.environ.get("PADDLE_LOG_DIR")
        path = os.path.join(
            d, f"events.rank{os.environ.get('PADDLE_TRAINER_ID', '0')}"
               f".jsonl") if d else None
        _DEFAULT.append(EventLog(path=path))
    return _DEFAULT[0]


def log_event(event: str, **fields):
    """Emit to the process event log."""
    return default_event_log().emit(event, **fields)
