"""Small structured logger for the launch drivers.

Human-readable lines on stdout by default (the ``launch/serve.py`` summary
stays copy-pasteable), with level filtering and an optional JSON-lines mode
for machine consumers:

* ``REPRO_LOG_LEVEL=debug|info|warning|error`` — filter (default ``info``).
* ``REPRO_LOG_JSON=1`` — emit one JSON object per line instead of text.

``log.info("served 8 requests", tokens=128, tok_s=41.2)`` renders as

    served 8 requests tokens=128 tok_s=41.2            # text mode
    {"ts": ..., "level": "info", "logger": "launch.serve",
     "msg": "served 8 requests", "tokens": 128, "tok_s": 41.2}   # JSON mode

No dependency on :mod:`logging` — the drivers need exactly level filtering
and key=value structure, and stdlib logging's global config would fight the
test harness.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, Optional

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _env_level() -> str:
    lvl = os.environ.get("REPRO_LOG_LEVEL", "info").lower()
    return lvl if lvl in LEVELS else "info"


def _env_json() -> bool:
    return os.environ.get("REPRO_LOG_JSON", "") not in ("", "0", "false")


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:g}"
    s = str(v)
    return json.dumps(s) if any(c in s for c in ' "=') else s


class StructuredLogger:
    """Level-filtered key=value / JSON-lines logger."""

    def __init__(self, name: str, level: Optional[str] = None,
                 json_lines: Optional[bool] = None, stream=None):
        self.name = name
        self.level = LEVELS[(level or _env_level()).lower()]
        self.json_lines = _env_json() if json_lines is None else json_lines
        self.stream = stream          # None → current sys.stdout at log time

    def log(self, level: str, msg: str, **fields):
        if LEVELS[level] < self.level:
            return
        stream = self.stream or sys.stdout
        if self.json_lines:
            rec = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S"), "level": level,
                   "logger": self.name, "msg": msg, **fields}
            print(json.dumps(rec, default=str), file=stream, flush=True)
            return
        prefix = "" if level == "info" else f"[{level}] "
        kv = " ".join(f"{k}={_fmt_value(v)}" for k, v in fields.items())
        print(prefix + msg + (" " + kv if kv else ""), file=stream,
              flush=True)

    def debug(self, msg: str, **fields):
        self.log("debug", msg, **fields)

    def info(self, msg: str, **fields):
        self.log("info", msg, **fields)

    def warning(self, msg: str, **fields):
        self.log("warning", msg, **fields)

    def error(self, msg: str, **fields):
        self.log("error", msg, **fields)


_loggers: Dict[str, StructuredLogger] = {}
_lock = threading.Lock()


def get_logger(name: str) -> StructuredLogger:
    """Cached per-name logger (env-configured level/format)."""
    with _lock:
        lg = _loggers.get(name)
        if lg is None:
            lg = StructuredLogger(name)
            _loggers[name] = lg
        return lg
