"""What the device did in a traced window, from torch.profiler's events.

A card's busy time is the union of its operations (kernels, copies,
memsets) inside the window; the window's busy time is the mean of that
over the cell's cards (`busy_s_per_card` keeps each card's, in card
order, by the event's `device_index()`; with one card every operation
is its). The idle share is 1 - busy / window, as
`rayforce_tpu_torch/tools/sortprof.py` works it out (there from the sum
of kernel times, which equals the union on one stream). An idle gap is
a stretch of the window in which no card runs an operation; it is named by the
query the harness was running and the host event of the trace that
covers at least half of it (the shortest of equal overlaps), else as
the host's own code: on the card the trace records the device's
activity and the CUDA runtime calls, not every host op.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    # each card's busy seconds, in the order of the cards given
    busy_s_per_card: list = field(default_factory=list)
    kernels: int = 0
    # (name, start_ns, end_ns) of each device operation in the window,
    # on any card
    ops: list = field(default_factory=list)
    # [[name, seconds]]: the device operations that took most time
    device_ops: list = field(default_factory=list)
    # [[label, seconds]]: the longest idle gaps
    idle_gaps: list = field(default_factory=list)

    def seconds_of(self, match):
        """Device seconds of the operations whose name `match` accepts."""
        return sum(e - s for name, s, e in self.ops if match(name)) / 1e9


def _annotation(e):
    """A user range mirrored on the device's timeline: no device work."""
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _busy(ops):
    """Sorted, disjoint [start, end] intervals covering sorted ops."""
    busy = []
    for _name, s, t in ops:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    return busy


def summarize(prof, start_ns, end_ns, spans, cards=(0,)):
    """A Trace of [start_ns, end_ns] (the host's time.time_ns clock, the
    profiler's own). `spans`: [(start_ns, end_ns, query)] of the
    harness's queries; `cards`: the device indices of the cell's
    cards."""
    from torch.autograd import DeviceType
    tr = Trace(window_s=(end_ns - start_ns) / 1e9)
    cards = list(cards)
    host, per_card = [], {c: [] for c in cards}
    # the raw events: no per-event Python object is built beyond what
    # is read here
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= start_ns or s >= end_ns:
            continue
        if e.device_type() == DeviceType.CPU:
            host.append((s, t, e))
            continue
        if _annotation(e):
            continue
        name = e.name()
        op = (name, max(s, start_ns), min(t, end_ns))
        tr.ops.append(op)
        if len(cards) > 1:
            per_card.setdefault(e.device_index(), []).append(op)
        tr.kernels += not name.startswith(("Memcpy", "Memset"))
    tr.ops.sort(key=lambda o: o[1])
    by_name = {}
    for name, s, t in tr.ops:
        by_name[name] = by_name.get(name, 0) + (t - s)
    busy = _busy(tr.ops)
    per = [busy] if len(cards) == 1 else \
        [_busy(sorted(per_card[c], key=lambda o: o[1])) for c in cards]
    tr.busy_s_per_card = [sum(t - s for s, t in b) / 1e9 for b in per]
    tr.busy_s = sum(tr.busy_s_per_card) / len(cards)
    tr.device_ops = [[name[:160], ns / 1e9] for name, ns in
                     sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    gaps, prev = [], start_ns
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if end_ns > prev:
        gaps.append((prev, end_ns))
    gaps = sorted(sorted(gaps, key=lambda g: g[0] - g[1])[:TOP])
    ops = _host_ops(gaps, host)
    tr.idle_gaps = sorted(([_query(g, spans) + ": " + _what(g, *ops[i]),
                            (g[1] - g[0]) / 1e9] for i, g in enumerate(gaps)),
                          key=lambda x: -x[1])
    return tr


def _what(gap, event, overlap):
    """The host event that covers at least half of a gap, or the host's
    own code."""
    if event is None or 2 * overlap < gap[1] - gap[0]:
        return "host code outside the traced calls"
    return event.name()[:120]


def _query(gap, spans):
    """The query the harness was running when a gap began."""
    i = bisect.bisect_right([sp[0] for sp in spans], gap[0]) - 1
    return spans[i][2] if i >= 0 and spans[i][1] > gap[0] else \
        "between queries"


def _host_ops(gaps, host):
    """Per gap (sorted, disjoint) the host event that overlaps it most,
    the shortest of equal overlaps, or None, with the overlap: one pass
    over the events."""
    ends = [g[1] for g in gaps]
    best = [None] * len(gaps)
    keys = [None] * len(gaps)
    for hs, ht, e in host:
        i = bisect.bisect_right(ends, hs)
        while i < len(gaps) and gaps[i][0] < ht:
            s, t = gaps[i]
            k = (min(t, ht) - max(s, hs), hs - ht)
            if k[0] > 0 and (keys[i] is None or k > keys[i]):
                best[i], keys[i] = e, k
            i += 1
    return [(e, k[0] if k else 0) for e, k in zip(best, keys)]
