"""Colored console logger: the port's own copy of
`video_styler_tpu/agent/logger.py` (the reference's src/utils/colored_logger.py)."""
from __future__ import annotations

import sys
import time

_COLORS = {"info": "\033[36m", "warn": "\033[33m", "error": "\033[31m",
           "save": "\033[32m", "node": "\033[35m"}
_RESET = "\033[0m"


def _log(level: str, msg: str):
    color = _COLORS.get(level, "") if sys.stdout.isatty() else ""
    reset = _RESET if color else ""
    ts = time.strftime("%H:%M:%S")
    print(f"{color}[{ts}] [{level.upper()}]{reset} {msg}")


def log_info(msg):
    _log("info", msg)


def log_warn(msg):
    _log("warn", msg)


def log_error(msg):
    _log("error", msg)


def log_save(msg):
    _log("save", msg)


def log_node(msg):
    _log("node", msg)
