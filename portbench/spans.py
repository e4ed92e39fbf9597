"""The program's own spans in a traced window, laid over the device's.

The program records each span of a request on the host's time.time_ns
clock, the clock of the trace's device events
(`rayforce_tpu_torch/core/profiler.py`: `log()`, `dropped()`): `query`
(a request's root, `eval_str`), `plan`, `plan: build` and `engine:
<name>` (the engine layer), `sync: <site>` (a read that waits for the
device) and `gather` (a lazy column forced; a root of the request when
the harness forces it after `eval_str`). The window's requests are the
last as many requests with a root `query` span as the window completed
queries: the harness starts a request before each query of the window,
and the profiler records only while the window is traced.

Per window (all times in ns, over the union of the spans of a kind):
- `syncs`: `sync:` spans; `sync_ns`: time inside them;
- `engine_host_ns`: time inside engine spans and outside the `sync:`
  and `gather` spans below them: host time planning and launching
  kernels;
- `engine_idle_ns`: time inside engine spans, outside the `sync:` spans
  below them, with no device operation running;
- `frontend_idle_ns`: time inside `query` spans and root `gather`
  spans, outside engine and `sync:` spans, with no device operation
  running: parse, spec, result wrapping, lazy columns.
Idle time lies outside every device operation of `ctx.trace.ops`, so
the two idle sums are parts of the window's device idle; the rest of it
falls outside the program's spans, in the harness's own loop. On a cell
of several cards `ctx.trace.ops` holds every card's operations, so idle
here is time in which no card runs one, as the trace's idle gaps are.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Split:
    queries: int
    syncs: int
    sync_ns: int
    engine_host_ns: int
    engine_idle_ns: int | None
    frontend_idle_ns: int | None

    def per_query_ms(self, ns):
        return None if ns is None else ns / 1e6 / self.queries


def _union(iv):
    """Sorted, disjoint intervals covering the (start, end) pairs."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        elif e > s:
            out.append([s, e])
    return out


def _minus(a, b):
    """a less b, both sorted and disjoint."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def _measure(iv):
    return sum(e - s for s, e in iv)


def _engine(name):
    return name in ("plan", "plan: build") or name.startswith("engine: ")


def split(log, n_queries, ops):
    """The Split of the last `n_queries` requests of `log` (records with
    request, name, start_ns, end_ns and parent), against the device
    operations `ops` ((name, start_ns, end_ns)); None where the log
    holds no such request. The idle sums are None where `ops` is
    empty."""
    reqs = sorted({r.request for r in log
                   if r.name == "query" and r.parent == -1})
    if not reqs or n_queries <= 0:
        return None
    keep = set(reqs[-n_queries:])
    recs = {r.index: r for r in log if r.request in keep}

    def below_engine(r):
        while r.parent in recs:
            r = recs[r.parent]
            if _engine(r.name):
                return True
        return False
    front, eng, sync, sync_e, gather_e = [], [], [], [], []
    for r in recs.values():
        iv = (r.start_ns, r.end_ns)
        if r.name.startswith("sync: "):
            sync.append(iv)
            if below_engine(r):
                sync_e.append(iv)
        elif _engine(r.name):
            eng.append(iv)
        elif r.name == "gather":
            if r.parent == -1:
                front.append(iv)
            elif below_engine(r):
                gather_e.append(iv)
        elif r.name == "query" and r.parent == -1:
            front.append(iv)
    u_eng = _union(eng)
    out = Split(queries=len(keep), syncs=len(sync),
                sync_ns=_measure(_union(sync)),
                engine_host_ns=_measure(_minus(u_eng,
                                               _union(sync_e + gather_e))),
                engine_idle_ns=None, frontend_idle_ns=None)
    if ops:
        busy = _union((s, e) for _name, s, e in ops)
        out.engine_idle_ns = _measure(_minus(_minus(u_eng, _union(sync_e)),
                                             busy))
        out.frontend_idle_ns = _measure(_minus(
            _minus(_union(front), _union(eng + sync)), busy))
    return out


_last: list = [None, None, None]


def read(ctx):
    """The Split of the traced window `ctx` from the program's span log,
    or None: a program without the span log, a ring that dropped spans,
    no completed query, or a trace with no device operation (on CPU
    torch the device's work is the host's, and no read waits for it)."""
    if ctx.trace is None or not ctx.trace.ops or not ctx.queries:
        return None
    if _last[0] is ctx and _last[1] is ctx.trace:
        return _last[2]
    from rayforce_tpu_torch.core import profiler
    log = getattr(profiler, "log", None)
    if log is None or profiler.dropped():
        return None
    out = split(log(), len(ctx.queries), ctx.trace.ops)
    _last[:] = [ctx, ctx.trace, out]
    return out
