"""Structured logging: the vptFATAL/WARN/INFO/DEBUG layer.

Copy of volume_path_tracer_tpu/utils/logging.py. Parity with the reference
renderer's logging macros (its include/vpt/logging.hpp:10-23): severity-tagged lines to
stderr, DEBUG decorated with the call site (the reference uses
std::source_location), FATAL exits the process with status 1 after printing
(logging.hpp:16 -> exit(1)). Severity filtering via the VPT_LOG_LEVEL
environment variable (DEBUG/INFO/WARN/FATAL, default INFO), which the
reference lacks but any production service needs.
"""
from __future__ import annotations

import inspect
import os
import sys

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "FATAL": 40}


def _threshold() -> int:
    return _LEVELS.get(os.environ.get("VPT_LOG_LEVEL", "INFO").upper(), 20)


def _emit(level: str, msg: str, loc: bool = False) -> None:
    if _LEVELS[level] < _threshold():
        return
    if loc:
        f = inspect.stack()[2]
        msg = f"{os.path.basename(f.filename)}:{f.lineno} {msg}"
    print(f"[vpt {level}] {msg}", file=sys.stderr, flush=True)


def debug(msg: str) -> None:
    _emit("DEBUG", msg, loc=True)


def info(msg: str) -> None:
    _emit("INFO", msg)


def warn(msg: str) -> None:
    _emit("WARN", msg)


def fatal(msg: str) -> None:
    """Print and exit(1) — the reference's vptFATAL (logging.hpp:16)."""
    _emit("FATAL", msg)
    raise SystemExit(1)
