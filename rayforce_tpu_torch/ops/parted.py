"""Parted (partitioned) column helpers (reference core/vary.c:185-391,
TYPE_PARTED*). A parted column is Obj(PARTED_OF[t], [per-partition Obj]).
Full date-parted storage lives in storage/parted.py; these are the in-memory
kernel hooks.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core.obj import Obj, to_np


def parted_raze(o: Obj) -> Obj:
    base = T.UNPARTED_OF[o.t]
    parts = [to_np(p) for p in o.v]
    if not parts:
        return Obj(base, np.zeros(0, dtype=T.DTYPE.get(base, np.int64)))
    dom = o.v[0].domain if base == T.ENUM else None
    return Obj(base, np.concatenate(parts), domain=dom)


def parted_at_idx(o: Obj, i: int):
    from ..core.obj import at_idx
    for p in o.v:
        n = len(p)
        if i < n:
            return at_idx(p, i)
        i -= n
    raise IndexError(i)


def parted_where(o: Obj) -> Obj:
    """PARTEDB8 -> PARTEDI64 of per-partition indices; -1 marks 'whole
    partition' (items.c:1373-1393)."""
    outs = []
    for p in o.v:
        a = to_np(p)
        idx = np.nonzero(a)[0].astype(np.int64)
        if len(idx) == len(a):
            idx = np.asarray([-1], dtype=np.int64)
        outs.append(Obj(T.I64, idx))
    return Obj(T.PARTED_OF[T.I64], outs)
