"""Event-loop timers: `(timer ms fn n)` registers a repeating callback
fired from the reactor loop (reference core/chrono.c:361, binary-heap
timers on the poll loop)."""
from __future__ import annotations

import heapq
import time

import numpy as np

from ..core import types as T
from ..core.obj import Obj
from ..core.errors import RayError

_heap: list = []
_seq = 0


def register(ms: int, fn_obj, repeats: int) -> int:
    global _seq
    _seq += 1
    heapq.heappush(_heap, (time.monotonic() + ms / 1000.0, _seq, ms,
                           fn_obj, repeats))
    return _seq


def next_timeout():
    if not _heap:
        return None
    return max(0.0, _heap[0][0] - time.monotonic())


def fire_due(runtime) -> int:
    """Run all due timer callbacks; reschedule repeating ones."""
    now = time.monotonic()
    fired = 0
    while _heap and _heap[0][0] <= now:
        due, seq, ms, fn_obj, reps = heapq.heappop(_heap)
        try:
            runtime.interp.call_lambda(fn_obj.v, [])
        except RayError:
            pass
        fired += 1
        if reps is None or reps > 1:
            heapq.heappush(_heap, (due + ms / 1000.0, seq, ms, fn_obj,
                                   None if reps is None else reps - 1))
    return fired
