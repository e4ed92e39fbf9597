"""Atomic (elementwise) operation machinery.

Semantics mirror the reference kernels (core/math.c, ops.h:136-190),
pinned down against the oracle (tests/golden/math_sem.json):

- promotion: i16 < i32 < i64 < f64; u8 op u8 stays u8 (wrapping); b8 in
  arithmetic is a type error; temporal +- integer keeps the temporal type;
  date - date -> i32, time - time -> time, timestamp - timestamp -> i64;
  f64 with temporal is a type error.
- nulls propagate through + - * / % (typed sentinel out); division or
  modulo by zero yields null; min/max-style ops skip nulls instead.
- `/` is floor division on integers, real division on floats (div-by-zero
  and NaN-operand -> null); `div` is always f64 division; `%` is floor mod;
  `(xbar y x)` buckets y by x: y - mod(y, x).

Arrays may be numpy (host) or torch tensors (device); the same numpy-flavored code
runs on either via the array-namespace helper in engine.backend.
"""
from __future__ import annotations

import numpy as np

from ..core import profiler as prof
from ..core import types as T
from ..core.obj import Obj, to_np, list_, dict_, is_null_scalar
from ..core.errors import err_type, err_length

INT_TYPES = (T.I16, T.I32, T.I64)
RANK = {T.U8: 0, T.I16: 1, T.I32: 2, T.I64: 3, T.F64: 4}


def is_null_np(t: int, a):
    if t == T.F64:
        return np.isnan(a)
    if t in T.NULL_BY_TYPE:
        return a == T.NULL_BY_TYPE[t]
    return np.zeros(np.shape(a), dtype=bool)


def null_of(t: int):
    return T.NULL_BY_TYPE.get(t)


def _temporal_base(t):
    # underlying integer type of a temporal
    return {T.DATE: T.I32, T.TIME: T.I32, T.TIMESTAMP: T.I64}[t]


def promote_arith(op: str, ta: int, tb: int) -> tuple:
    """Return (result_type, compute_type) or raise type error.
    compute_type is the type both operands are converted to."""
    a_tmp, b_tmp = ta in T.TEMPORAL, tb in T.TEMPORAL
    if a_tmp and b_tmp:
        if op == "sub" and ta == tb:
            if ta == T.DATE:
                return T.I32, T.I32
            if ta == T.TIME:
                return T.TIME, T.I32
            return T.I64, T.I64
        if op == "add" and ta == tb and ta != T.DATE:
            return ta, _temporal_base(ta)
        if op in ("mod", "xbar") and ta == tb:
            # durations bucket/mod within their own unit (oracle:
            # (xbar 01:00:00.000 [01:30:00.000 ...]) -> TIME)
            return ta, _temporal_base(ta)
        raise err_type(f"arith on {T.TYPE_NAMES.get(ta)} and "
                       f"{T.TYPE_NAMES.get(tb)}")
    if a_tmp or b_tmp:
        tmp, other = (ta, tb) if a_tmp else (tb, ta)
        if other in (T.U8, T.I16, T.I32, T.I64, T.B8):
            if other == T.B8:
                raise err_type("b8 in arithmetic")
            # DATEs only shift/bucket ((* date 2) is a type error in
            # the reference), and for non-add/sub ops the temporal
            # side must be the DATA (first) operand — (xbar 3600000
            # 09:45:00.000) and (xbar 7 2024.01.05) both type-error
            if op not in ("add", "sub"):
                if not a_tmp:
                    raise err_type("temporal must be the data operand")
                if tmp == T.DATE and op != "xbar":
                    raise err_type("date arithmetic")
            return tmp, _temporal_base(tmp)
        raise err_type("temporal with non-integer")
    if ta == T.B8 or tb == T.B8:
        raise err_type("b8 in arithmetic")
    if ta not in RANK or tb not in RANK:
        raise err_type("non-numeric in arithmetic")
    if ta == T.U8 and tb == T.U8:
        return T.U8, T.U8
    r = max(RANK[ta], RANK[tb])
    rt = {0: T.I64, 1: T.I16, 2: T.I32, 3: T.I64, 4: T.F64}[r]
    # u8 mixed with an int takes the int's type
    if ta == T.U8:
        rt = tb if tb in RANK else rt
    elif tb == T.U8:
        rt = ta if ta in RANK else rt
    return rt, rt


def _to_dtype(arr, t):
    dt = T.DTYPE[t]
    a = np.asarray(arr)
    if a.dtype == dt:
        return a
    return a.astype(dt)


def _compute(op: str, ct: int, va, vb):
    """Raw compute in type ct. Returns (raw_result, extra_null_mask)."""
    if ct == T.F64:
        va = np.asarray(va, dtype=np.float64)
        vb = np.asarray(vb, dtype=np.float64)
        if op == "add":
            return va + vb, None
        if op == "sub":
            return va - vb, None
        if op == "mul":
            return va * vb, None
        if op == "fdiv":
            with np.errstate(divide="ignore", invalid="ignore"):
                r = va / vb
            return r, (vb == 0)
        if op == "idiv":
            # `/` is floor division even on floats (oracle: (/ 7.0 2) -> 3.00)
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.floor_divide(va, vb)
            return r, (vb == 0)
        if op == "mod":
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.mod(va, vb)
            return r, (vb == 0)
        if op == "xbar":
            # (xbar a b) = b * trunc(a/b) (oracle: (xbar 5 -7) -> 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                r = vb * np.trunc(va / vb)
            return r, (vb == 0)
        raise err_type(f"bad float op {op}")
    va = _to_dtype(va, ct)
    vb = _to_dtype(vb, ct)
    with np.errstate(over="ignore"):
        if op == "add":
            return va + vb, None
        if op == "sub":
            return va - vb, None
        if op == "mul":
            return va * vb, None
        if op == "idiv":
            zero = vb == 0
            safe = np.where(zero, 1, vb)
            return np.floor_divide(va, safe), zero
        if op == "mod":
            zero = vb == 0
            safe = np.where(zero, 1, vb)
            return np.mod(va, safe), zero
        if op == "xbar":
            zero = vb == 0
            safe = np.where(zero, 1, vb)
            q = (np.abs(va) // np.abs(safe)) * np.sign(va) * np.sign(safe)
            return safe * q, zero
    raise err_type(f"bad int op {op}")


def _has_dev(o):
    return (isinstance(o.meta, dict) and "dev" in o.meta) or \
        o.pending() is not None


def _dev_len(o):
    p = o.pending()
    return int(p.shape[0]) if p is not None else len(o)


def _dev_arith_fast(op, a, b, ta, tb, rt, ct):
    """+-* over DEVICE-RESIDENT vectors (with a scalar or with each
    other) stays on device: the result is a lazy DevPending column, so
    chains like the window-join bounds `(map-left + [-1000 1000] ts)`
    never fetch 10M+ rows to the host and never pay the re-upload (the
    reference computes these in RAM because RAM is where the data
    lives, core/math.c binop_map; here the data lives on the device). Host
    semantics are mirrored exactly: typed null sentinels in EITHER
    operand yield the result type's null (NaN for F64 — an integer
    sentinel must be masked before the f64 cast, it does not become
    NaN by casting), ints wrap, f64 NaNs propagate natively. Returns
    None whenever the host path should run instead (no device copy,
    small vector, null scalar, unsupported compute type)."""
    if ct not in (T.I16, T.I32, T.I64, T.F64):
        return None
    if ta == T.ENUM or tb == T.ENUM:
        return None
    from ..engine import device as dev
    if not dev.available():
        return None
    from ..core.obj import DevPending
    from ..engine.exprc import torch_dtype
    import torch
    cdt = torch_dtype(T.DTYPE[ct])

    def vec_operand(o, t):
        """(value in ct, null mask | None) for a vector operand."""
        arr = dev.dev_col(o)
        nv = T.NULL_BY_TYPE.get(t)
        nulls = None
        if nv is not None and t != T.F64:
            nulls = arr == int(nv)
        return arr.to(cdt), nulls

    if a.t > 0 and b.t > 0:
        if not (_has_dev(a) and _has_dev(b)):
            return None
        if not dev.should_use(_dev_len(a)):
            return None
        x, na = vec_operand(a, ta)
        y, nb = vec_operand(b, tb)
        nulls = na if nb is None else (nb if na is None else na | nb)
    else:
        if a.t > 0 and b.t < 0:
            vec, sc, tv = a, b, ta
        elif b.t > 0 and a.t < 0:
            vec, sc, tv = b, a, tb
        else:
            return None
        if not _has_dev(vec) or not dev.should_use(_dev_len(vec)):
            return None
        sval = sc.v
        if is_null_scalar(abs(sc.t), sval):
            return None
        v, nulls = vec_operand(vec, tv)
        s = prof.host("vops.scalar", torch.tensor,
                      T.DTYPE[ct](sval) if ct != T.F64 else np.float64(sval),
                      dtype=cdt, device=v.device)
        x, y = (v, s) if vec is a else (s, v)
    if op == "add":
        raw = x + y
    elif op == "sub":
        raw = x - y
    else:
        raw = x * y
    out_dt = torch_dtype(T.DTYPE[rt])
    if raw.dtype != out_dt:
        raw = raw.to(out_dt)
    if nulls is not None:
        nv_out = null_of(rt)
        if nv_out is not None:
            raw = torch.where(nulls, prof.host(
                "vops.null", torch.tensor,
                np.asarray(nv_out, dtype=T.DTYPE[rt]), device=raw.device),
                raw)
        elif rt == T.F64:
            raw = torch.where(nulls, np.nan, raw)
    o = Obj(rt, DevPending(raw))
    o.meta = {"dev": raw}
    return o


def arith(op: str, a: Obj, b: Obj) -> Obj:
    """Elementwise arithmetic with broadcasting, recursion over LIST/dict."""
    if a.t in T.UNPARTED_OF or b.t in T.UNPARTED_OF:
        from .parted import parted_raze
        if a.t in T.UNPARTED_OF:
            a = parted_raze(a)
        if b.t in T.UNPARTED_OF:
            b = parted_raze(b)
    # list / dict recursion (FN_ATOMIC mapping)
    for x, y, flip in ((a, b, False), (b, a, True)):
        if x.t == T.LIST:
            out = []
            ylen = None if (y.t < 0 or y.t == T.DICT) else len(y)
            if ylen is not None and ylen != len(x.v):
                raise err_length("list arith length mismatch")
            from ..core.obj import at_idx
            for i, el in enumerate(x.v):
                yv = y if ylen is None else at_idx(y, i)
                out.append(arith(op, el, yv) if not flip
                           else arith(op, yv, el))
            return list_(out)
    if a.t in (-T.NULL, T.NULL) or b.t in (-T.NULL, T.NULL):
        raise err_type("null in arithmetic")
    if a.t == T.DICT or b.t == T.DICT:
        # the reference rejects dicts in arithmetic (oracle-pinned:
        # (+ {a:1} 100) -> type error)
        raise err_type("dict in arithmetic")

    # ENUM degrades to SYMBOL ids -> type error in arithmetic, as reference
    ta, tb = abs(a.t), abs(b.t)
    if op == "add" and {ta, tb} == {T.DATE, T.TIME}:
        # date + time composes a TIMESTAMP (oracle-pinned:
        # (+ 2024.01.01 09:30:00.000) -> 2024.01.01D09:30:00.000000000)
        d, tm = (a, b) if ta == T.DATE else (b, a)
        dv = np.asarray(to_np(d) if d.t > 0 else d.v, dtype=np.int64)
        tv = np.asarray(to_np(tm) if tm.t > 0 else tm.v, dtype=np.int64)
        nulls = (dv == T.NULL_I32) | (tv == T.NULL_I32)
        ns = dv * np.int64(86_400_000_000_000) + tv * np.int64(1_000_000)
        ns = np.where(nulls, np.int64(T.NULL_I64), ns)
        if a.t < 0 and b.t < 0:
            return Obj(-T.TIMESTAMP, np.int64(ns))
        if ns.ndim == 0:
            ns = ns[None]
        return Obj(T.TIMESTAMP, ns)
    if op == "fdiv":
        rt, ct = T.F64, T.F64
        _ = promote_arith("mul", ta, tb)  # validate operand classes
    else:
        rt, ct = promote_arith(op, ta, tb)

    if a.t > 0 and b.t > 0 and len(a) != len(b):
        raise err_length(f"{len(a)} vs {len(b)}")
    if op in ("add", "sub", "mul"):
        dres = _dev_arith_fast(op, a, b, ta, tb, rt, ct)
        if dres is not None:
            return dres
    va, vb = a.v, b.v
    nulls = None
    na = is_null_np(ta, to_np(a) if a.t > 0 else va)
    nb = is_null_np(tb, to_np(b) if b.t > 0 else vb)
    raw, extra = _compute(op if op != "fdiv" else "fdiv", ct, va, vb)
    nulls = na | nb
    if extra is not None:
        nulls = nulls | extra

    out_dt = T.DTYPE[rt]
    raw = np.asarray(raw)
    if raw.dtype != out_dt:
        raw = raw.astype(out_dt)
    if np.any(nulls):
        nv = null_of(rt)
        if nv is not None:
            raw = np.where(nulls, np.asarray(nv, dtype=out_dt), raw)
    if a.t < 0 and b.t < 0:
        return Obj(-rt, out_dt(raw))
    if a.t > 0 and b.t > 0 and len(a) != len(b):
        raise err_length(f"{len(a)} vs {len(b)}")
    if raw.ndim == 0:
        raw = raw[None]
    return Obj(rt, raw)


# -- comparisons ------------------------------------------------------------

CMP_CLASS = {
    T.B8: "num", T.U8: "num", T.I16: "num", T.I32: "num", T.I64: "num",
    T.F64: "num", T.SYMBOL: "sym", T.DATE: "date", T.TIME: "time",
    T.TIMESTAMP: "ts", T.C8: "c8", T.GUID: "guid", T.ENUM: "sym",
}


def _cmp_key(o: Obj):
    """Comparable numpy value(s) + class tag."""
    t = abs(o.t)
    if abs(t) == T.ENUM:
        from ..core.obj import enum_domain
        dom = to_np(enum_domain(o))
        ids = to_np(o) if o.t > 0 else np.asarray(o.v)
        safe = np.where((ids >= 0) & (ids < len(dom)), ids, 0)
        vals = dom[safe]
        vals = np.where(ids == T.NULL_I64, T.NULL_I64, vals)
        if o.t < 0:
            vals = vals[()] if np.ndim(vals) == 0 else vals
        return "sym", vals
    v = to_np(o) if o.t > 0 else o.v
    return CMP_CLASS.get(t), v


def _unpart(o: Obj) -> Obj:
    if o.t in T.UNPARTED_OF:
        from .parted import parted_raze
        return parted_raze(o)
    return o


def compare(op: str, a: Obj, b: Obj) -> Obj:
    a = _unpart(a)
    b = _unpart(b)
    if T.TABLE in (a.t, b.t) or T.DICT in (a.t, b.t):
        # whole-object equality yields one boolean (oracle-pinned:
        # (== t t) -> true); ordering comparisons are type errors
        if op not in ("eq", "ne"):
            raise err_type("cmp on table/dict")
        from .cmp import obj_equal
        r = obj_equal(a, b)
        if op == "ne":
            r = not r
        return Obj(-T.B8, np.int8(1 if r else 0))
    for x, y, flip in ((a, b, False), (b, a, True)):
        if x.t == T.LIST:
            from ..core.obj import at_idx
            out = []
            ylen = None if y.t < 0 else (len(y) if y.t != T.DICT else None)
            if ylen is not None and ylen != len(x.v):
                raise err_length("cmp length mismatch")
            for i, el in enumerate(x.v):
                yv = y if ylen is None else at_idx(y, i)
                out.append(compare(op, el, yv) if not flip
                           else compare(op, yv, el))
            return list_(out)
    ca, va = _cmp_key(a)
    cb, vb = _cmp_key(b)
    if ca is None or cb is None or ca != cb:
        raise err_type("cmp type mismatch")
    if ca == "num":
        fa = np.asarray(va, dtype=np.float64) \
            if abs(a.t) == T.F64 or abs(b.t) == T.F64 else None
        if fa is not None:
            # NaN sorts first: substitute -inf for ordering AND equality
            va = np.where(np.isnan(np.asarray(va, dtype=np.float64)),
                          -np.inf, np.asarray(va, dtype=np.float64))
            vb = np.where(np.isnan(np.asarray(vb, dtype=np.float64)),
                          -np.inf, np.asarray(vb, dtype=np.float64))
    if ca == "c8":
        # whole-string comparison yields a scalar b8
        if a.t == T.C8 and b.t == T.C8:
            sa = to_np(a).tobytes()
            sb = to_np(b).tobytes()
            r = {"eq": sa == sb, "ne": sa != sb, "lt": sa < sb,
                 "gt": sa > sb, "le": sa <= sb, "ge": sa >= sb}[op]
            return Obj(-T.B8, np.int8(1 if r else 0))
    va = np.asarray(va)
    vb = np.asarray(vb)
    if op == "eq":
        raw = va == vb
    elif op == "ne":
        raw = va != vb
    elif op == "lt":
        raw = va < vb
    elif op == "gt":
        raw = va > vb
    elif op == "le":
        raw = va <= vb
    elif op == "ge":
        raw = va >= vb
    else:
        raise err_type("bad cmp op")
    if a.t < 0 and b.t < 0:
        return Obj(-T.B8, np.int8(1 if raw else 0))
    if a.t > 0 and b.t > 0 and len(a) != len(b):
        raise err_length(f"{len(a)} vs {len(b)}")
    return Obj(T.B8, np.asarray(raw, dtype=np.int8).reshape(-1))
