"""Global symbol interning.

The reference interns strings into a lock-free hash table backed by an
append-only arena (core/symbols.c:37-151). Here the process-wide table is a
Python dict guarded by the GIL; ids are dense i64 starting at 0 and id->str
lookup is O(1) via a list. Symbol columns hold these ids as int64 arrays so
they are directly device-residable.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()
_by_name: dict[str, int] = {}
_by_id: list[str] = []


def intern(name: str) -> int:
    sid = _by_name.get(name)
    if sid is not None:
        return sid
    with _lock:
        sid = _by_name.get(name)
        if sid is None:
            sid = len(_by_id)
            _by_id.append(name)
            _by_name[name] = sid
        return sid


def name_of(sid: int) -> str:
    if 0 <= sid < len(_by_id):
        return _by_id[sid]
    return ""  # null / foreign id


def count() -> int:
    return len(_by_id)


# The empty symbol is id 0 and doubles as the symbol null's printed form "".
EMPTY = intern("")
