"""The port's span recorder: the analogue of the reference's `-t` timeit
span recorder (core/chrono.h:62-81 `timeit_t`), nested.

A span is one stretch of work at a layer boundary of the query path:
`query` (the request's root, `Interp.eval_str`), `select: eval spec`,
`plan`, `plan: build`, `engine: <name>`, `sync: <site>` (a device-to-
host read, through `host`) and `gather` (a lazy column forced). Each
closed span is the record

    (index, request, name, start_ns, end_ns, parent)

`index` counts every span the process opened; `parent` is the index of
the span that was open on the same thread when it opened (-1 for none);
`request` is the id `reset()` gave the current request. Stamps are
`time.time_ns()`, the clock torch.profiler converts its device events
to, so spans lie over the device's timeline.

Closed spans go to one ring of RING records that `reset()` does not
clear; `log()` returns it and `dropped()` counts the records it lost.
`spans()` and `report()` read the current request (the CLI's and the
REPL's `-t`). Disabled, `span`, `begin`, `end` and `host` take one
branch each: no clock is read, nothing is allocated or appended.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque, namedtuple

enabled = False
RING = 1 << 20

Span = namedtuple("Span", "index request name start_ns end_ns parent")

_ring: deque = deque(maxlen=RING)
_dropped = 0
_index = itertools.count()
_request = 0
_t0 = time.time_ns()
_local = threading.local()


def reset() -> None:
    """Start a new request."""
    global _request, _t0
    _request += 1
    _t0 = time.time_ns()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _record(rec) -> None:
    global _dropped
    if len(_ring) == _ring.maxlen:
        _dropped += 1
    _ring.append(rec)


def begin(name: str):
    """Open a span on this thread; returns the token `end` takes (None
    when disabled)."""
    if not enabled:
        return None
    st = _stack()
    tok = (next(_index), _request, name, time.time_ns(),
           st[-1][0] if st else -1)
    st.append(tok)
    return tok


def end(tok) -> None:
    """Close the span `begin` opened."""
    if tok is None:
        return
    t = time.time_ns()
    st = _stack()
    if tok in st:
        st.remove(tok)
    i, rid, name, s, parent = tok
    _record((i, rid, name, s, t, parent))


class _Open:
    __slots__ = ("name", "tok")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.tok = begin(self.name)
        return self

    def __exit__(self, *exc):
        end(self.tok)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """`with span(name):` records the block as one span."""
    if not enabled:
        return _OFF
    return _Open(name)


def host(site: str, read, *args, **kw):
    """`read(*args, **kw)`, a read that waits for the device (a copy to
    the host, `.tolist()`, `int()` or `bool()` of a device tensor,
    `nonzero`, a blocking copy to the device), recorded as the span
    "sync: <site>". Returns what `read` returns."""
    if not enabled:
        return read(*args, **kw)
    tok = begin("sync: " + site)
    try:
        return read(*args, **kw)
    finally:
        end(tok)


def since_request(name: str) -> None:
    """Record a span from the request's start (`reset()`) to now, as a
    child of this thread's open span."""
    if not enabled:
        return
    st = _stack()
    _record((next(_index), _request, name, _t0, time.time_ns(),
             st[-1][0] if st else -1))


def open_spans() -> list:
    """The names of this thread's open spans, outermost first."""
    return [tok[2] for tok in _stack()]


def log() -> list:
    """Every span in the ring, as Span records, oldest first."""
    return [Span._make(r) for r in list(_ring)]


def dropped() -> int:
    """Records the ring has lost since the process began."""
    return _dropped


def _current() -> list:
    """The current request's records, in the order they opened."""
    out = []
    for r in reversed(_ring):
        if r[1] != _request:
            break
        out.append(r)
    out.sort()
    return out


def spans() -> list:
    """[(name, ms)] of the current request's spans, in the order they
    opened."""
    return [(r[2], (r[4] - r[3]) / 1e6) for r in _current()]


def self_ns(recs) -> dict:
    """{index: self time in ns} of the records: each span's time less
    the part of it that its children cover."""
    kids: dict = {}
    for r in recs:
        kids.setdefault(r[5], []).append((r[3], r[4]))
    out = {}
    for i, _rid, _name, s, t, _parent in recs:
        covered, reach = 0, s
        for a, b in sorted(kids.get(i, ())):
            a, b = max(a, reach), min(b, t)
            if b > a:
                covered += b - a
                reach = b
        out[i] = t - s - covered
    return out


def report() -> str:
    """The current request's spans, each indented under its parent with
    its time and its self time, and the total of its root spans."""
    recs = _current()
    if not recs:
        return ""
    own = self_ns(recs)
    depth: dict = {}
    lines = [f"  {'span':<36s} {'ms':>9s} {'self ms':>9s}"]
    total = 0.0
    for i, _rid, name, s, t, parent in recs:
        d = depth[i] = depth[parent] + 1 if parent in depth else 0
        ms = (t - s) / 1e6
        if d == 0:
            total += ms
        lines.append(f"  {'  ' * d + name:<36s} {ms:9.3f} "
                     f"{own[i] / 1e6:9.3f}")
    lines.append(f"  {'total':<36s} {total:9.3f}")
    return "\n".join(lines)
