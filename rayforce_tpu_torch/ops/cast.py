"""`as` — type casting (reference core/rayforce.c cast_obj:2312,
core/compose.c ray_cast_obj:42).

Typenames are SIGNED: lowercase names are ATOM types, uppercase names are
VECTOR types (env.c init_typenames:272). `(as 'i64 x)` on an atom uses the
atom conversion table; on a vector whose type is in the numeric/temporal
set the target flips to the vector type (ray_cast_obj:53-65), so both
cases convert vectors elementwise.

Conversions are RAW C-style casts — integer narrowing wraps, widening
sign-extends, and NULL sentinels are NOT special-cased (an i64 null cast
to f64 is -9.22e18, not NaN; oracle-pinned in tests/golden/cast_matrix).
f64 -> int goes through C truncation: cvtt to i32 for <=32-bit targets
and to i64 for 64-bit targets, NaN/out-of-range landing on INT_MIN of the
conversion width, then wrapping to the target width — exactly what the
reference's `(i16_t)obj->f64` compiles to.
"""
from __future__ import annotations

import re

import numpy as np

from ..core import types as T
from ..core import symbols, temporal
from ..core.obj import Obj, to_np, string, str_of, atom_null
from ..core.errors import err_type, err_value

# name -> SIGNED type (negative = atom semantics, positive = vector)
NAME2TYPE = {}
for _t, _n in T.TYPE_NAMES.items():
    if 0 < _t <= T.ENUM:
        NAME2TYPE[_n] = -_t             # lowercase = atom
        NAME2TYPE[_n.upper()] = _t      # uppercase = vector
NAME2TYPE["SYMBOL"] = T.SYMBOL
NAME2TYPE["symbol"] = -T.SYMBOL
NAME2TYPE["LIST"] = T.LIST
NAME2TYPE["TABLE"] = T.TABLE
NAME2TYPE["DICT"] = T.DICT

NUMERIC = (T.B8, T.U8, T.I16, T.I32, T.I64, T.F64, T.DATE, T.TIME,
           T.TIMESTAMP)
_I32_FAM = (T.I32, T.DATE, T.TIME)      # i32 storage
_I64_FAM = (T.I64, T.TIMESTAMP)         # i64 storage


def target_type(name_obj: Obj) -> int:
    """Signed target type for a typename symbol (err: value, like the
    reference's unknown-typename path, compose.c:50)."""
    if name_obj.t != -T.SYMBOL:
        raise err_type("as: target must be a symbol")
    name = symbols.name_of(int(name_obj.v))
    t = NAME2TYPE.get(name)
    if t is None:
        raise err_value(f"as: unknown type {name}")
    return t


def _cvtt32(a) -> np.ndarray:
    """C `(i32_t)double`: truncate; NaN/out-of-range -> INT32_MIN."""
    a = np.asarray(a, dtype=np.float64)
    bad = ~((a > -(2.0 ** 31) - 1) & (a < 2.0 ** 31))   # NaN -> True
    with np.errstate(invalid="ignore"):
        r = np.trunc(np.where(bad, 0.0, a)).astype(np.int32)
    return np.where(bad, np.int32(-2 ** 31), r)


def _cvtt64(a) -> np.ndarray:
    """C `(i64_t)double`: truncate; NaN/out-of-range -> INT64_MIN."""
    a = np.asarray(a, dtype=np.float64)
    bad = ~((a >= -(2.0 ** 63)) & (a < 2.0 ** 63))
    with np.errstate(invalid="ignore"):
        r = np.trunc(np.where(bad, 0.0, a)).astype(np.int64)
    return np.where(bad, np.int64(-2 ** 63), r)


def _vec_num(t: int, ot: int, a: np.ndarray) -> np.ndarray:
    """Raw elementwise conversion between numeric/temporal vector types
    (the big MTYPE2 switch, rayforce.c). Returns the target-typed array
    or raises for the pairs the reference's table omits (B8<->U8)."""
    if (t, ot) in ((T.B8, T.U8), (T.U8, T.B8)):
        raise err_type("cannot cast")       # not in the reference table
    if t == T.F64:
        return a.astype(np.float64)
    if ot == T.F64:
        w = _cvtt64(a) if t in _I64_FAM else _cvtt32(a)
        return w.astype(T.DTYPE[t])
    # int -> int: C casts (wrap on narrowing, sign-extend on widening)
    return a.astype(T.DTYPE[t])


# Prefix-parse semantics mirroring the reference's from_str family
# (string.c i64_from_str/f64_from_str, date.c date_from_str,
# time.c time_from_str, timestamp.c timestamp_from_str). Sign is '-'
# ONLY (a '+' prefix parses zero digits -> 0); junk after the numeric
# prefix is ignored; a field with no digits at all reads as 0.
_INT_RE = re.compile(r"[ \t\r\n]*(-?\d+)")
_F64_RE = re.compile(r"[ \t\r\n]*(-?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")


def _int_from_str(s: str) -> int:
    m = _INT_RE.match(s)
    return int(m.group(1)) if m else 0


def _f64_from_str(s: str) -> float:
    m = _F64_RE.match(s)
    return float(m.group(1)) if m else 0.0


def _date_from_str(s: str) -> int:
    """Reference date.c date_from_str: three digit runs separated by
    any non-digit runs; year wraps u16, month 1-12, day 1-31."""
    runs = re.findall(r"\d+", s)
    if len(runs) < 3:
        return T.NULL_I32
    y, mo, d = int(runs[0]) & 0xFFFF, int(runs[1]), int(runs[2])
    if not (1 <= mo <= 12 and 1 <= d <= 31):
        return T.NULL_I32
    return temporal.days_from_civil(y, mo, d)


def _time_from_str(s: str) -> int:
    """Reference time.c time_from_str: '-' anywhere flips sign,
    ':'/'.' both advance the field, other non-digits -> null; needs
    h:m:s or h:m:s.ms; h/m/s wrap u8, ms wraps u16 and is RAW
    (".5" is 5 milliseconds, not 500)."""
    sign, cnt, val = 1, 0, 0
    parts = [0, 0, 0, 0]
    for ch in s:
        if ch == "-":
            sign = -1
        elif ch in ":.":
            if cnt > 2:
                return T.NULL_I32
            parts[cnt] = val
            cnt += 1
            val = 0
        elif ch.isdigit():
            val = val * 10 + int(ch)
        else:
            return T.NULL_I32
    if cnt == 2:
        parts[2] = val
    elif cnt == 3:
        parts[3] = val
    else:
        return T.NULL_I32
    hh, mm, ss = parts[0] & 0xFF, parts[1] & 0xFF, parts[2] & 0xFF
    ms = parts[3] & 0xFFFF
    return sign * ((hh * 3600 + mm * 60 + ss) * 1000 + ms)


_NS_IN_DAY = 86_400_000_000_000


def _ts_from_str(s: str) -> int:
    """Reference timestamp.c timestamp_from_str: ISO when char 4 is
    '-', else digit runs y.m.d[.h.m.s.nanos] with RAW nanos (".5" is
    5 ns); ISO pads fractional digits to 9 and applies Z/+hh:mm."""
    if len(s) >= 5 and s[4] == "-":
        return _ts_from_iso(s)
    runs = re.findall(r"\d+", s)
    if len(runs) < 3:
        return T.NULL_I64
    vals = [int(r) for r in runs[:7]] + [0] * (7 - min(len(runs), 7))
    y, mo, d, hh, mm, ss, ns = vals
    y &= 0xFFFF
    if not (1 <= mo <= 12 and 1 <= d <= 31 and hh <= 23
            and mm <= 59 and ss <= 59):
        return T.NULL_I64
    days = temporal.days_from_civil(y, mo, d)
    return days * _NS_IN_DAY \
        + (hh * 3600 + mm * 60 + ss) * 1_000_000_000 + (ns & 0xFFFFFFFF)


_ISO_RE = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})"
    r"(?:[T ](\d{2}):(\d{2}):(\d{2})(?:\.(\d+))?"
    r"(?:[Zz]|([+-])(\d{2}):?(\d{2})?)?)?")


def _ts_from_iso(s: str) -> int:
    m = _ISO_RE.match(s)
    if not m:
        return T.NULL_I64
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    if not (1 <= mo <= 12 and 1 <= d <= 31):
        return T.NULL_I64
    hh = int(m.group(4) or 0)
    mm = int(m.group(5) or 0)
    ss = int(m.group(6) or 0)
    if hh > 23 or mm > 59 or ss > 59:
        return T.NULL_I64
    ns = int((m.group(7) or "0")[:9].ljust(9, "0"))
    v = temporal.days_from_civil(y, mo, d) * _NS_IN_DAY \
        + (hh * 3600 + mm * 60 + ss) * 1_000_000_000 + ns
    if m.group(8):
        off = int(m.group(9)) * 60 + int(m.group(10) or 0)
        if m.group(8) == "-":
            off = -off
        v -= off * 60 * 1_000_000_000
    return v


def _guid_from_str(s: str) -> np.ndarray:
    """Reference guid_from_str (string.c:381): exactly 36 chars,
    '-' skipped wherever it appears, remaining chars must be hex."""
    z = np.zeros(16, dtype=np.uint8)
    if len(s) != 36:
        return z
    hx = s.replace("-", "")
    if len(hx) != 32:
        return z
    try:
        return np.frombuffer(bytes.fromhex(hx), dtype=np.uint8).copy()
    except ValueError:
        return z


def _atom_from_string(t: int, s: str) -> Obj:
    """Lowercase target applied to a C8 vector: the reference's
    string->atom parse table (rayforce.c string-to-atom cases)."""
    if t == T.B8:
        return Obj(-T.B8, np.int8(1 if len(s) > 0 else 0))
    if t == T.U8:
        return Obj(-T.U8, np.uint8(np.int32(_int_from_str(s) & 0xFFFFFFFF
                                            ).astype(np.uint8)))
    if t == T.I16:
        return Obj(-T.I16, np.int64(_int_from_str(s)).astype(np.int16))
    if t == T.I32:
        return Obj(-T.I32, np.int64(_int_from_str(s)).astype(np.int32))
    if t == T.I64:
        iv = _int_from_str(s)
        iv = (iv & (2 ** 64 - 1))
        if iv >= 2 ** 63:
            iv -= 2 ** 64
        return Obj(-T.I64, np.int64(iv))
    if t == T.F64:
        return Obj(-T.F64, np.float64(_f64_from_str(s)))
    if t == T.SYMBOL:
        return Obj(-T.SYMBOL, np.int64(symbols.intern(s)))
    if t == T.C8:
        return Obj(-T.C8, np.uint8(ord(s[0]) if s else 0))
    if t == T.DATE:
        return Obj(-T.DATE, np.int32(_date_from_str(s)))
    if t == T.TIME:
        return Obj(-T.TIME, np.int32(_time_from_str(s)))
    if t == T.TIMESTAMP:
        return Obj(-T.TIMESTAMP, np.int64(_ts_from_str(s)))
    if t == T.GUID:
        return Obj(-T.GUID, _guid_from_str(s))
    raise err_type("cannot cast string")


def _sym_text(t: int, v) -> str:
    """sprintf text for symbol-from-number atoms (rayforce.c SYMBOL
    atom conversions: %d/%u/%lld/%f)."""
    if t == T.F64:
        return "%f" % float(v)          # 6 decimals, like C "%f"
    if t == T.B8:
        return "%d" % int(v)
    return "%d" % int(v)


def _atom_cast(t: int, o: Obj) -> Obj:
    """Atom -> atom conversions (the negative-target MTYPE2 cases)."""
    ot = -o.t
    v = o.v
    if ot not in NUMERIC and ot not in (T.SYMBOL,):
        raise err_type("cannot cast")
    if t == T.B8:
        if ot in NUMERIC and ot != T.B8:
            # != 0 test (NaN != 0 -> true) — NOT the vector low-byte rule
            nz = (float(v) != 0.0) if ot == T.F64 else (int(v) != 0)
            return Obj(-T.B8, np.int8(1 if nz else 0))
        raise err_type("cannot cast")
    if t == T.U8:
        if ot == T.F64:
            return Obj(-T.U8, _cvtt32([v])[0].astype(np.uint8))
        if ot in NUMERIC:
            return Obj(-T.U8, np.int64(v).astype(np.uint8))
        raise err_type("cannot cast")
    if t == T.C8:
        if ot == T.B8:
            return Obj(-T.C8, np.uint8(ord("1") if int(v) else ord("0")))
        if ot == T.F64:
            return Obj(-T.C8, _cvtt32([v])[0].astype(np.uint8))
        if ot == T.SYMBOL:
            nm = symbols.name_of(int(v))
            return Obj(-T.C8, np.uint8(ord(nm[0]) if nm else 0))
        if ot in NUMERIC:
            return Obj(-T.C8, np.int64(v).astype(np.uint8))
        raise err_type("cannot cast")
    if t == T.I16:
        if ot == T.F64:
            return Obj(-T.I16, _cvtt32([v])[0].astype(np.int16))
        if ot in NUMERIC:
            return Obj(-T.I16, np.int64(v).astype(np.int16))
        raise err_type("cannot cast")
    if t in _I32_FAM:
        if ot == T.F64:
            return Obj(-t, _cvtt32([v])[0])
        if ot in NUMERIC:
            return Obj(-t, np.int64(v).astype(np.int32))
        raise err_type("cannot cast")
    if t in _I64_FAM:
        if ot == T.F64:
            return Obj(-t, _cvtt64([v])[0])
        if ot in NUMERIC:
            return Obj(-t, np.int64(v))
        raise err_type("cannot cast")
    if t == T.F64:
        if ot in NUMERIC:
            return Obj(-T.F64, np.float64(np.int64(v) if ot != T.F64
                                          else v))
        raise err_type("cannot cast")
    if t == T.SYMBOL:
        if ot in (T.DATE, T.TIME, T.TIMESTAMP, T.GUID):
            from ..core import fmt
            return Obj(-T.SYMBOL,
                       np.int64(symbols.intern(
                           fmt.format_obj(o, 0, None, 0))))
        if ot in NUMERIC:
            return Obj(-T.SYMBOL,
                       np.int64(symbols.intern(_sym_text(ot, v))))
        raise err_type("cannot cast")
    raise err_type("cannot cast")


def cast_obj(st: int, o: Obj) -> Obj:
    """Signed-type cast: st < 0 = atom semantics, st > 0 = vector
    semantics (rayforce.c cast_obj:2312)."""
    from ..core import fmt
    if st == o.t:
        return o
    t = abs(st)

    # empty vectors cast to an empty vector of the target base type
    # (cast_obj's early `vector(type, 0)` return)
    if o.t > 0 and o.t != T.LIST and len(o) == 0:
        if t == T.GUID:
            return Obj(T.GUID, np.zeros((0, 16), dtype=np.uint8))
        return Obj(t, np.zeros(0, dtype=T.DTYPE.get(t, np.int64)))

    if st < 0:
        # --- atom semantics ---
        if o.t == T.C8:                 # string -> atom parse table
            return _atom_from_string(t, str_of(o))
        if o.t < 0:
            if -o.t == T.NULL:
                return atom_null(t)     # extension: typed null from nil
            return _atom_cast(t, o)
        raise err_type("cannot cast vector to atom")

    # --- vector semantics ---
    ot = o.t
    if ot < 0:
        # atom source with a vector target: only the whole-object
        # format-to-string default applies (rayforce.c default case)
        if t == T.C8:
            return string(fmt.format_obj(o, 0, None, 0))
        raise err_type("cannot cast atom to vector")
    if t == T.TABLE and ot == T.DICT:
        from ..core.obj import table as mk_table
        k, v = o.v
        return mk_table(k, list(v.v) if v.t == T.LIST else [v])
    if t == T.DICT and ot == T.TABLE:
        from ..core.obj import dict_ as mk_dict, list_
        k, cols = o.v
        return mk_dict(k, list_(list(cols)))
    if t in NUMERIC and ot in NUMERIC:
        return Obj(t, _vec_num(t, ot, to_np(o)))
    if t == T.SYMBOL and ot == T.I64:
        ids = [symbols.intern("%d" % int(x)) for x in to_np(o)]
        return Obj(T.SYMBOL, np.asarray(ids, dtype=np.int64))
    if t == T.C8:
        # default branch: format the WHOLE object to one string
        return string(fmt.format_obj(o, 0, None, 0))
    if ot == T.LIST:
        # LIST -> vector: elementwise atom casts (rayforce.c:2806)
        if len(o.v) == 0:
            if t == T.GUID:
                return Obj(T.GUID, np.zeros((0, 16), dtype=np.uint8))
            return Obj(t, np.zeros(0, dtype=T.DTYPE.get(t, np.int64)))
        outs = [cast_obj(-t, e) for e in o.v]
        if t == T.GUID:
            return Obj(T.GUID, np.stack([e.v for e in outs]))
        return Obj(t, np.asarray([e.v for e in outs],
                                 dtype=T.DTYPE.get(t, np.int64)))
    raise err_type(f"cannot cast {T.TYPE_NAMES.get(ot)} to "
                   f"{T.TYPE_NAMES.get(t)}")


def cast_any(t: int, o: Obj) -> Obj:
    """Engine-internal cast with POSITIVE base type t: atom operands use
    atom semantics, vectors use vector semantics (the signedness the
    user-facing `as` would pick for that operand)."""
    return cast_obj(-t if o.t < 0 else t, o)


def ray_cast(name_obj: Obj, o: Obj) -> Obj:
    st = target_type(name_obj)
    # lowercase target on a numeric/temporal VECTOR flips to the vector
    # cast (compose.c ray_cast_obj:53-65)
    if st < 0 and o.t > 0 and o.t != T.LIST and -st in NUMERIC \
            and o.t in NUMERIC:
        st = -st
    return cast_obj(st, o)
