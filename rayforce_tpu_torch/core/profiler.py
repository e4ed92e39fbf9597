"""Per-query phase profiler: the analogue of the reference's `-t`
timeit span recorder (core/chrono.h:62-81 `timeit_t`, 1024 spans of
start/end/tick). Kernels call `tick("label")` at phase boundaries; when
profiling is enabled (CLI `-t`), the REPL prints the recorded spans
after each eval (reference app/repl.c:76).

A tick closes the span that began at the previous tick (or at reset).
Disabled, tick() is a single branch — kernels stay instrumented at
negligible cost.
"""
from __future__ import annotations

import time

enabled = False
_events: list = []     # (label, t)
_t0 = 0.0


def reset() -> None:
    global _t0
    _events.clear()
    _t0 = time.perf_counter()


def tick(label: str) -> None:
    if enabled:
        _events.append((label, time.perf_counter()))


def spans() -> list:
    """[(label, ms)] for the spans since reset()."""
    out = []
    prev = _t0
    for label, t in _events:
        out.append((label, (t - prev) * 1000.0))
        prev = t
    return out


def report() -> str:
    ss = spans()
    if not ss:
        return ""
    total = sum(ms for _, ms in ss)
    lines = [f"  {label:<28s} {ms:9.3f} ms" for label, ms in ss]
    lines.append(f"  {'total':<28s} {total:9.3f} ms")
    return "\n".join(lines)
