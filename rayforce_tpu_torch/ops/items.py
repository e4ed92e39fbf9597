"""Indexing & set ops: at/find/filter/take/in/within/sect/except/union/
key/value/where/first/last/count/bin/binr (reference core/items.c).
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import (Obj, to_np, list_, dict_, table, at_idx, NULL_OBJ,
                        atom_null, col_by_name, vec_sym)
from ..core.errors import err_type, err_index, err_length
from .compose import gather, take_n, unify_list


def ray_count(o: Obj) -> Obj:
    if o.t in T.UNPARTED_OF:
        return Obj(-T.I64, np.int64(len(o)))
    if o.t == T.MAPGROUP:
        from .aggr import grouped_aggregate
        return grouped_aggregate("count", o.v[0], o.v[1])
    if o.t == T.MAPFILTER:
        from .filter import filter_len
        return Obj(-T.I64, np.int64(filter_len(o)))
    if o.t < 0:
        return Obj(-T.I64, np.int64(1))
    return Obj(-T.I64, np.int64(len(o)))


def ray_first(o: Obj) -> Obj:
    if o.t == T.MAPGROUP:
        from .aggr import grouped_aggregate
        return grouped_aggregate("first", o.v[0], o.v[1])
    if o.t == T.MAPFILTER:
        from .filter import filter_collect
        o = filter_collect(o.v[0], o.v[1])
    if o.t == T.DICT:
        return o    # dicts pass through whole (oracle-pinned)
    if o.t < 0:
        return o
    if len(o) == 0:
        return _empty_first(o)
    return at_idx(o, 0)


def ray_last(o: Obj) -> Obj:
    if o.t == T.MAPGROUP:
        from .aggr import grouped_aggregate
        return grouped_aggregate("last", o.v[0], o.v[1])
    if o.t == T.MAPFILTER:
        from .filter import filter_collect
        o = filter_collect(o.v[0], o.v[1])
    if o.t == T.DICT:
        return o    # dicts pass through whole (oracle-pinned)
    if o.t < 0:
        return o
    if len(o) == 0:
        return _empty_first(o)
    return at_idx(o, len(o) - 1)


def _empty_first(o: Obj) -> Obj:
    if o.t == T.LIST:
        return NULL_OBJ
    return atom_null(o.t if o.t != T.ENUM else T.SYMBOL)


def ray_where(o: Obj) -> Obj:
    """bool vector -> i64 indices (items.c:1366)."""
    if o.t in T.UNPARTED_OF:
        from .parted import parted_where
        return parted_where(o)
    if o.t != T.B8:
        raise err_type("where needs a boolean vector")
    return Obj(T.I64, np.nonzero(to_np(o))[0].astype(np.int64))


def ray_at(o: Obj, k: Obj) -> Obj:
    """Polymorphic indexing (items.c:74)."""
    if k.t in T.UNPARTED_OF:
        # a parted INDEX vector: raze it (the reference type-errors;
        # indexing by the razed rows is the obvious superset)
        from .parted import parted_raze
        k = parted_raze(k)
    t = o.t
    if t == T.TABLE:
        if k.t == -T.SYMBOL:
            c = col_by_name(o, symbols.name_of(int(k.v)))
            if c is None:
                raise err_index("no such column")
            return c
        if k.t == T.SYMBOL:
            # (at t [cols]) -> LIST of column values (oracle-pinned)
            sel = []
            for sid in to_np(k):
                c = col_by_name(o, symbols.name_of(int(sid)))
                if c is None:
                    raise err_index("no such column")
                sel.append(c)
            return list_(sel)
        if k.t < 0:  # row -> dict
            return at_idx(o, int(k.v))
        # (at t [rows]) -> LIST of row dicts (oracle-pinned; the
        # reference's at over tables yields rows, items.c:74)
        idx = to_np(k).astype(np.int64)
        return list_([at_idx(o, int(i)) for i in idx])
    if t == T.DICT:
        keys, vals = o.v
        if k.t < 0:
            i = _dict_find(keys, k)
            if i is None:
                return NULL_OBJ
            return at_idx(vals, i)
        out = []
        for j in range(len(k)):
            i = _dict_find(keys, at_idx(k, j))
            out.append(NULL_OBJ if i is None else at_idx(vals, i))
        return unify_list(out)
    if t < 0:
        raise err_type("at on atom")
    if k.t < 0:
        if -k.t not in (T.I16, T.I32, T.I64, T.U8):
            raise err_type("at index must be integer")
        i = int(k.v)
        if i < 0:
            i += len(o)   # negative = from the end ((at [1 2 3] -1)=3)
        if i < 0 or i >= len(o):
            if o.t == T.LIST:
                return NULL_OBJ
            return atom_null(o.t if o.t != T.ENUM else T.SYMBOL)
        return at_idx(o, i)
    if k.t == T.LIST:
        return list_([ray_at(o, e) for e in k.v])
    idx = to_np(k).astype(np.int64)
    return gather(o, idx)


def _dict_find(keys: Obj, k: Obj):
    from .cmp import obj_equal
    for i in range(len(keys)):
        if obj_equal(at_idx(keys, i), k):
            return i
    return None


def ray_key(o: Obj) -> Obj:
    if o.t == T.DICT:
        return o.v[0]
    if o.t == T.TABLE:
        return o.v[0]
    if o.t == T.ENUM:
        if o.domain is not None and o.domain.t == -T.SYMBOL:
            return o.domain
        from ..core.obj import enum_domain
        return enum_domain(o)
    if o.t > 0:
        return o  # key of a plain vector is itself (oracle-pinned)
    raise err_type("key on atom")


def ray_value(o: Obj) -> Obj:
    if o.t == T.DICT:
        return o.v[1]
    if o.t == T.TABLE:
        return list_(o.v[1])
    if o.t == T.ENUM:
        from ..core.obj import enum_domain
        dom = to_np(enum_domain(o))
        ids = to_np(o)
        safe = np.where((ids >= 0) & (ids < len(dom)), ids, 0)
        out = dom[safe]
        out = np.where(ids == T.NULL_I64, T.NULL_I64, out)
        return Obj(T.SYMBOL, out.astype(np.int64))
    if o.t == -T.ENUM:
        from ..core.obj import enum_domain
        dom = to_np(enum_domain(o))
        i = int(o.v)
        sid = int(dom[i]) if 0 <= i < len(dom) else T.NULL_I64
        return Obj(-T.SYMBOL, np.int64(sid))
    return o


def ray_find(o: Obj, x: Obj) -> Obj:
    """First index of x in o; null if absent (items.c:302)."""
    if o.t == T.DICT:
        keys, vals = o.v
        # reverse lookup: find value -> key
        from .cmp import obj_equal
        for i in range(len(vals)):
            if obj_equal(at_idx(vals, i), x):
                return at_idx(keys, i)
        return NULL_OBJ
    if o.t == T.TABLE:
        raise err_type("find in table")   # as the reference
    if o.t < 0:
        raise err_type("find in atom")
    if x.t < 0 and o.t != T.LIST:
        a = to_np(o)
        if o.t == T.ENUM:
            v = ray_value(o)
            return ray_find(v, x)
        hits = np.nonzero(a == T.DTYPE.get(o.t, np.int64)(x.v))[0] \
            if o.t != T.GUID else \
            np.nonzero((a == np.asarray(x.v)).all(axis=1))[0]
        if len(hits) == 0:
            return Obj(-T.I64, T.NULL_I64)
        return Obj(-T.I64, np.int64(hits[0]))
    if x.t < 0 and o.t == T.LIST:
        i = _list_find(o.v, x)
        return Obj(-T.I64, T.NULL_I64 if i is None else np.int64(i))
    # vector of lookups
    out = []
    for j in range(len(x)):
        out.append(ray_find(o, at_idx(x, j)))
    return unify_list(out)


def _list_find(items, x):
    from .cmp import obj_equal
    for i, e in enumerate(items):
        if obj_equal(e, x):
            return i
    return None


def ray_in(x: Obj, o: Obj) -> Obj:
    """(in x set) -> booleans shaped like x (items.c:736)."""
    if x.t < 0:
        f = ray_find(o, x)
        hit = not (f.t == -T.I64 and int(f.v) == int(T.NULL_I64)) \
            if f.t == -T.I64 else f.t != -T.NULL
        return Obj(-T.B8, np.int8(1 if hit else 0))
    if x.t == T.LIST:
        return list_([ray_in(e, o) for e in x.v])
    if o.t == T.LIST or o.t < 0:
        out = np.zeros(len(x), dtype=np.int8)
        for j in range(len(x)):
            out[j] = int(ray_in(at_idx(x, j), o).v)
        return Obj(T.B8, out)
    xa = _comparable(x)
    oa = _comparable(o)
    return Obj(T.B8, np.isin(xa, oa).astype(np.int8))


def _comparable(o: Obj) -> np.ndarray:
    if o.t == T.ENUM:
        return to_np(ray_value(o))
    return to_np(o)


def ray_within(x: Obj, rng: Obj) -> Obj:
    if rng.t <= 0 or rng.t == T.LIST:
        raise err_type("within needs a typed 2-element vector")
    if len(rng) != 2:
        raise err_length("within needs a 2-element range")
    lo = at_idx(rng, 0)
    hi = at_idx(rng, 1)
    from .vops import compare
    ge = compare("ge", x, lo)
    le = compare("le", x, hi)
    from .logic import bool_and
    return bool_and(ge, le)


def ray_sect(a: Obj, b: Obj) -> Obj:
    """Set intersection, keeping a's order AND duplicates (oracle-pinned
    (sect [1 2 2 3] [2 2 4]) -> [2 2]) — a filtered left side, not a
    dedup (reference items.c:898)."""
    mask = ray_in(a, b)
    if mask.t < 0:
        return a if int(mask.v) else take_n(a, 0)
    idx = np.nonzero(to_np(mask))[0].astype(np.int64)
    return gather(a, idx)


def ray_except(a: Obj, b: Obj) -> Obj:
    mask = ray_in(a, b)
    if a.t < 0:
        return a if not int(mask.v) else NULL_OBJ
    idx = np.nonzero(~to_np(mask).astype(bool))[0].astype(np.int64)
    return gather(a, idx)


def ray_union(a: Obj, b: Obj) -> Obj:
    from .compose import ray_concat, ray_distinct
    return ray_distinct(ray_concat(a, b))


def ray_filter(f: Obj, o: Obj):
    """(filter pred xs) (items.c:351)."""
    from ..core.interp import collect_lazy
    raise err_type("filter is bound in builtins with interp access")


def ray_bin(hay: Obj, needles: Obj) -> Obj:
    """binary search: index of last element <= needle (items.c:1552)."""
    a = to_np(hay)
    if needles.t < 0:
        i = int(np.searchsorted(a, needles.v, side="right")) - 1
        return Obj(-T.I64, np.int64(i))
    n = to_np(needles)
    idx = np.searchsorted(a, n, side="right").astype(np.int64) - 1
    return Obj(T.I64, idx)


def ray_binr(hay: Obj, needles: Obj) -> Obj:
    """index of first element >= needle; a needle past the last element
    yields len (oracle-pinned (binr [10 20 30] [35]) -> 3), matching
    the reference's lower-bound scan (items.c:1599)."""
    a = to_np(hay)
    if needles.t < 0:
        i = int(np.searchsorted(a, needles.v, side="left"))
        return Obj(-T.I64, np.int64(i))
    n = to_np(needles)
    idx = np.searchsorted(a, n, side="left").astype(np.int64)
    return Obj(T.I64, idx)


def ray_take(o: Obj, n: Obj) -> Obj:
    """(take x n): n>=0 head/repeat, n<0 tail (items.c:398). Dicts take
    entries, cycling like vectors (oracle-pinned: (take {a:1 b:2} 5)
    repeats entries)."""
    if n.t >= 0:
        raise err_type("take count must be an atom")
    cnt = int(n.v)
    if o.t < 0:
        return take_n(o, abs(cnt))
    if o.t == T.DICT:
        k, v = o.v
        from ..core.obj import dict_
        return dict_(ray_take(k, n), ray_take(v, n))
    ln = len(o)
    if cnt >= 0:
        if cnt <= ln:
            idx = np.arange(cnt, dtype=np.int64)
        else:
            idx = np.arange(cnt, dtype=np.int64) % max(ln, 1) \
                if ln else np.zeros(0, dtype=np.int64)
        return gather(o, idx)
    cnt = -cnt
    if cnt <= ln:
        idx = np.arange(ln - cnt, ln, dtype=np.int64)
    else:
        idx = (np.arange(cnt, dtype=np.int64) % max(ln, 1)) if ln \
            else np.zeros(0, dtype=np.int64)
    return gather(o, idx)
