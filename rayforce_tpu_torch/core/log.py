"""Leveled logging (reference core/log.c: TRACE..ERROR with
file/line/func, fully compiled out in release builds).

Python analogue: a module logger that is a no-op unless RAYFORCE_LOG
names a level (trace|debug|info|warn|error) — the "compiled out"
discipline becomes a single short-circuit branch.
"""
from __future__ import annotations

import os
import sys
import time

_LEVELS = {"trace": 0, "debug": 1, "info": 2, "warn": 3, "error": 4}
_active = _LEVELS.get(os.environ.get("RAYFORCE_LOG", "").lower(), 99)


def set_level(name: str | None) -> None:
    global _active
    _active = _LEVELS.get((name or "").lower(), 99)


def _emit(level: str, msg: str, *args):
    if _LEVELS[level] < _active:
        return
    t = time.strftime("%H:%M:%S")
    try:
        fr = sys._getframe(2)
        where = f"{os.path.basename(fr.f_code.co_filename)}:" \
                f"{fr.f_lineno}:{fr.f_code.co_name}"
    except Exception:
        where = "?"
    text = msg % args if args else msg
    print(f"[{t}] {level.upper():5s} {where} {text}", file=sys.stderr)


def trace(msg, *a):
    if _active <= 0:
        _emit("trace", msg, *a)


def debug(msg, *a):
    if _active <= 1:
        _emit("debug", msg, *a)


def info(msg, *a):
    if _active <= 2:
        _emit("info", msg, *a)


def warn(msg, *a):
    if _active <= 3:
        _emit("warn", msg, *a)


def error(msg, *a):
    if _active <= 4:
        _emit("error", msg, *a)
