"""Whole-vector math builtins: arithmetic wrappers, unary rounding, and the
ungrouped aggregates (reference core/math.c fold drivers + core/aggr.c null
disciplines; see tests/golden/math_sem.json for the pinned behaviors).

Aggregate null/empty semantics (reference ops.h:136-190, aggr.c):
- sum uses ADD -> any null makes the result null; empty sum of ints is 0.
- avg/med/dev skip nulls and return f64; empty -> 0Nf.
- min/max skip nulls (min inits to INF, max to NULL); empty -> typed null.
- sum keeps i32 for i32 input but widens i16/u8 to i64 (oracle-pinned).
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core.obj import Obj, to_np, list_, dict_, atom_null
from ..core.errors import err_type
from .vops import arith, is_null_np

# -- arithmetic builtin entry points ---------------------------------------


def ray_add(a, b):
    return arith("add", a, b)


def ray_sub(a, b):
    return arith("sub", a, b)


def ray_mul(a, b):
    return arith("mul", a, b)


def ray_div(a, b):
    return arith("idiv", a, b)


def ray_fdiv(a, b):
    return arith("fdiv", a, b)


def ray_mod(a, b):
    return arith("mod", a, b)


def ray_xbar(a, b):
    return arith("xbar", a, b)


# -- unary math -------------------------------------------------------------

def _unary_f64(o: Obj, fn):
    t = abs(o.t)
    if t == T.LIST:
        return list_([_unary_f64(e, fn) for e in o.v])
    if t == T.F64:
        if o.t < 0:
            v = float(o.v)
            return Obj(-T.F64, np.float64(fn(np.float64(v))))
        return Obj(T.F64, fn(to_np(o)))
    if t in (T.I16, T.I32, T.I64, T.U8):
        return o  # integers unchanged (round/floor/ceil are identity)
    raise err_type("round/floor/ceil on non-numeric")


def _round_half_away(v):
    return np.where(np.asarray(v) >= 0, np.floor(np.asarray(v) + 0.5),
                    np.ceil(np.asarray(v) - 0.5))


def ray_round(o):
    return _unary_f64(o, _round_half_away)


def ray_floor(o):
    return _unary_f64(o, np.floor)


def ray_ceil(o):
    return _unary_f64(o, np.ceil)


def ray_neg(o):
    t = abs(o.t)
    if t == T.LIST:
        return list_([ray_neg(e) for e in o.v])
    if t in (T.B8, T.U8):
        # booleans/bytes negate as i64 (oracle-pinned: (neg [true
        # false]) -> I64 [-1 0])
        if o.t < 0:
            return Obj(-T.I64, np.int64(-int(o.v)))
        return Obj(T.I64, -to_np(o).astype(np.int64))
    if t in (T.I16, T.I32, T.I64, T.F64):
        if o.t < 0:
            return Obj(o.t, T.DTYPE[t](-o.v))
        a = to_np(o)
        nulls = is_null_np(t, a)
        r = -a
        if t != T.F64 and np.any(nulls):
            r = np.where(nulls, a, r)
        return Obj(t, r)
    raise err_type("neg on non-numeric")


# -- ungrouped aggregates ---------------------------------------------------

SUM_TYPE = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64,
            T.F64: T.F64}


def _aggr_dispatch(o: Obj, scalar_fn, name):
    """Handle MAPGROUP fusion, LIST auto-map, dict, atoms."""
    from .aggr import grouped_aggregate
    if o.t == T.MAPGROUP:
        return grouped_aggregate(name, o.v[0], o.v[1])
    if o.t == T.MAPFILTER:
        from .filter import filter_collect
        return scalar_fn(filter_collect(o.v[0], o.v[1]))
    if o.t in T.UNPARTED_OF:
        if name == "count":
            return Obj(-T.I64, np.int64(sum(len(p) for p in o.v)))
        if name in ("avg", "med", "dev"):
            # not exactly combinable from per-piece partials (float
            # summation order / rank statistics): compute over the
            # razed view so the result is bit-identical to the
            # unparted kernel
            from .parted import parted_raze
            return scalar_fn(parted_raze(o))
        # stream partition-at-a-time, combine partials
        # (reference PARTED_MAP, aggr.c:183-260)
        parts = [_aggr_dispatch(p, scalar_fn, name) for p in o.v]
        return _combine_partials(name, parts)
    if o.t == T.LIST:
        from .compose import unify_list
        return unify_list([_aggr_dispatch(e, scalar_fn, name)
                           for e in o.v])
    if o.t == T.DICT:
        k, v = o.v
        return dict_(k, _aggr_dispatch(v, scalar_fn, name))
    return scalar_fn(o)


def _combine_partials(name: str, parts: list) -> Obj:
    from .compose import unify_list
    from .items import ray_count as _cnt
    vec = unify_list(parts)
    if name == "sum":
        return _sum_np(vec)
    if name in ("min",):
        return _minmax_np(vec, True)
    if name in ("max",):
        return _minmax_np(vec, False)
    if name in ("first",):
        return parts[0]
    if name in ("last",):
        return parts[-1]
    raise err_type(f"parted {name} needs full materialization")


def _sum_np(o: Obj):
    if o.t < 0:
        t = -o.t
        if t in SUM_TYPE or t == T.B8:
            if t == T.B8:
                raise err_type("sum of b8")
            return o
        raise err_type("sum on non-numeric")
    t = o.t
    if t in (T.TIME, T.TIMESTAMP):
        # durations sum to their own type (oracle-pinned: (sum
        # [01:00:00.000 02:00:00.000]) -> 03:00:00.000); dates do not
        a = to_np(o)
        a = a[~is_null_np(t, a)]
        with np.errstate(over="ignore"):
            s = a.astype(np.int64).sum()
        return Obj(-t, T.DTYPE[t](s))
    if t == T.ENUM or t not in SUM_TYPE:
        raise err_type("sum on non-numeric")
    rt = SUM_TYPE[t]
    a = to_np(o)
    nulls = is_null_np(t, a)
    if nulls.any():
        a = a[~nulls]  # sum skips nulls (oracle: (sum [1 0Nl 3]) -> 4)
    if t == T.F64:
        return Obj(-T.F64, np.float64(a.sum()))
    dt = T.DTYPE[rt]
    with np.errstate(over="ignore"):
        s = a.astype(np.int64).sum()
    return Obj(-rt, dt(s))


def ray_sum(o):
    return _aggr_dispatch(o, _sum_np, "sum")


def _avg_np(o: Obj):
    if o.t in T.UNPARTED_OF:
        from .parted import parted_raze
        o = parted_raze(o)
    if o.t < 0:
        o = Obj(abs(o.t), np.asarray([o.v]))
    t = o.t
    if t not in SUM_TYPE:
        raise err_type("avg on non-numeric")
    a = to_np(o)
    nulls = is_null_np(t, a)
    good = a[~nulls].astype(np.float64)
    if len(good) == 0:
        return Obj(-T.F64, T.NULL_F64)
    return Obj(-T.F64, np.float64(good.sum() / len(good)))


def ray_avg(o):
    return _aggr_dispatch(o, _avg_np, "avg")


def _med_np(o: Obj):
    if o.t < 0:
        o = Obj(abs(o.t), np.asarray([o.v]))
    t = o.t
    if t not in SUM_TYPE:
        raise err_type("med on non-numeric")
    a = to_np(o)
    good = a[~is_null_np(t, a)].astype(np.float64)
    if len(good) == 0:
        return Obj(-T.F64, T.NULL_F64)
    return Obj(-T.F64, np.float64(np.median(good)))


def ray_med(o):
    return _aggr_dispatch(o, _med_np, "med")


def _dev_np(o: Obj):
    if o.t < 0:
        o = Obj(abs(o.t), np.asarray([o.v]))
    t = o.t
    if t not in SUM_TYPE:
        raise err_type("dev on non-numeric")
    a = to_np(o)
    good = a[~is_null_np(t, a)].astype(np.float64)
    if len(good) == 0:
        return Obj(-T.F64, T.NULL_F64)
    return Obj(-T.F64, np.float64(good.std()))


def ray_dev(o):
    return _aggr_dispatch(o, _dev_np, "dev")


MINMAX_OK = (T.U8, T.I16, T.I32, T.I64, T.F64, T.DATE, T.TIME, T.TIMESTAMP,
             T.B8)


def _minmax_np(o: Obj, is_min: bool):
    if o.t < 0:
        return o
    t = o.t
    if t not in MINMAX_OK:
        raise err_type("min/max on this type")
    a = to_np(o)
    nulls = is_null_np(t, a)
    good = a[~nulls]
    if len(good) == 0:
        return atom_null(t)
    v = good.min() if is_min else good.max()
    return Obj(-t, v)


def ray_min(o):
    return _aggr_dispatch(o, lambda x: _minmax_np(x, True), "min")


def ray_max(o):
    return _aggr_dispatch(o, lambda x: _minmax_np(x, False), "max")
