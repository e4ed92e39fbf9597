"""Formatter producing byte-identical output to the reference's core/format.c.

`full` modes (format.h:76): 0 = compact/bare, 1 = full with display limits
(the REPL / `format` mode), 2 = full without limits (`show`).

Behavioral spec extracted from format.c: float formatting (f64_fmt_into,
format.c:317-332), container layouts (list/dict/vector/table *_fmt_into),
display constants (TABLE_MAX_WIDTH=10, TABLE_MAX_HEIGHT=20,
LIST_MAX_HEIGHT=50, MAX_ROW_WIDTH=80).
"""
from __future__ import annotations

import math

import numpy as np

from . import types as T
from . import symbols, temporal
from .obj import Obj, to_np, enum_domain
from .errors import RayError

NO_LIMIT = -1
TABLE_MAX_WIDTH = 10
TABLE_MAX_HEIGHT = 20
LIST_MAX_HEIGHT = 50
DEFAULT_MAX_ROW_WIDTH = 80
DEFAULT_F64_PRECISION = 2

_state = {"fpr": DEFAULT_F64_PRECISION, "row_width": DEFAULT_MAX_ROW_WIDTH}

# Box-drawing glyphs (format.c:58-59).
VLINE, HLINE = "│", "─"
TL, TR, BL, BR = "┌", "┐", "└", "┘"
L_TEE, R_TEE, T_TEE, B_TEE, CROSS = "├", "┤", "┬", "┴", "┼"
HDOTS, VDOTS = "…", "┆"


def set_fpr(n) -> None:
    _state["fpr"] = DEFAULT_F64_PRECISION if n is None else int(n)


def get_fpr() -> int:
    return _state["fpr"]


def _limit_reached(limit: int, n: int) -> bool:
    return limit != NO_LIMIT and n >= limit


# -- scalar formatters ------------------------------------------------------

def fmt_b8(v) -> str:
    return "true" if v else "false"


def fmt_u8(v) -> str:
    return "0x%02x" % (int(v) & 0xFF)


def fmt_c8(v, full) -> str:
    c = int(v) & 0xFF
    if c == 0x22:
        return "'\\\"'" if full else "\\\""
    if c == 0x0A:
        return "'\\n'" if full else "\\n"
    if c == 0x0D:
        return "'\\r'" if full else "\\r"
    if c == 0x09:
        return "'\\t'" if full else "\\t"
    if c == 0:
        return "''" if full else " "
    if 0 < c < 32:
        return ("'\\%03o'" % c) if full else ("\\%03o" % c)
    ch = chr(c)
    return f"'{ch}'" if full else ch


def fmt_i16(v) -> str:
    return "0Nh" if int(v) == int(T.NULL_I16) else str(int(v))


def fmt_i32(v) -> str:
    return "0Ni" if int(v) == int(T.NULL_I32) else str(int(v))


def fmt_i64(v) -> str:
    return "0Nl" if int(v) == int(T.NULL_I64) else str(int(v))


def fmt_f64(v) -> str:
    v = float(v)
    fpr = _state["fpr"]
    if math.isnan(v):
        return "0Nf"
    if v == 0.0:
        return ("%." + str(fpr) + "f") % 0.0
    order = math.log10(abs(v)) if not math.isinf(v) else math.inf
    if order > 6 or order < -1:
        return ("%." + str(fpr) + "e") % v
    return ("%." + str(fpr) + "f") % v


def fmt_sym(v, full) -> str:
    if int(v) == int(T.NULL_I64):
        return "0Ns" if full else ""
    return symbols.name_of(int(v))


def fmt_date(v) -> str:
    if int(v) == int(T.NULL_I32):
        return "0Nd"
    y, m, d = temporal.civil_from_days(int(v))
    return "%.4d.%.2d.%.2d" % (y, m, d)


def fmt_time(v) -> str:
    if int(v) == int(T.NULL_I32):
        return "0Nt"
    sign, h, m, s, ms = temporal.time_parts(int(v))
    body = "%.2d:%.2d:%.2d.%.3d" % (h, m, s, ms)
    return "-" + body if sign == -1 else body


def fmt_timestamp(v) -> str:
    if int(v) == int(T.NULL_I64):
        return "0Np"
    y, mo, d, h, mi, s, ns = temporal.ts_parts(int(v))
    return "%.4d.%.2d.%.2dD%.2d:%.2d:%.2d.%.9d" % (y, mo, d, h, mi, s, ns)


def fmt_guid(v) -> str:
    b = bytes(np.asarray(v, dtype=np.uint8).tobytes())
    if not any(b):
        return "0Ng"
    h = b.hex()
    return f"{h[0:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"


_SCALAR = {
    T.B8: lambda v, full: fmt_b8(v),
    T.U8: lambda v, full: fmt_u8(v),
    T.I16: lambda v, full: fmt_i16(v),
    T.I32: lambda v, full: fmt_i32(v),
    T.I64: lambda v, full: fmt_i64(v),
    T.F64: lambda v, full: fmt_f64(v),
    T.SYMBOL: fmt_sym,
    T.DATE: lambda v, full: fmt_date(v),
    T.TIME: lambda v, full: fmt_time(v),
    T.TIMESTAMP: lambda v, full: fmt_timestamp(v),
    T.C8: fmt_c8,
    T.GUID: lambda v, full: fmt_guid(v),
}


# -- element formatter (raw_fmt_into, format.c) -----------------------------

def raw_fmt(o: Obj, i: int, indent: int, limit: int) -> str:
    """Format element i of a vector-ish object. Symbols/chars print quoted
    forms per raw_fmt_into (format.c)."""
    t = o.t
    if t == T.SYMBOL:
        return fmt_sym(to_np(o)[i], True)
    if t == T.C8:
        return fmt_c8(to_np(o)[i], True)
    if t in _SCALAR:
        return _SCALAR[t](to_np(o)[i], False)
    if t == T.LIST:
        return format_obj(o.v[i], indent=indent, limit=limit, full=0)
    if t == T.ENUM:
        idx = int(to_np(o)[i])
        return fmt_sym(_enum_sym_id(o, idx), True)
    if t in T.UNPARTED_OF:
        from ..ops.parted import parted_at_idx
        return format_obj(parted_at_idx(o, i), indent=indent, limit=limit,
                          full=0)
    raise RayError("nyi", f"raw_fmt for type {t}")


def _enum_sym_id(o: Obj, idx: int):
    dom = to_np(enum_domain(o))
    if idx == int(T.NULL_I64) or idx < 0 or idx >= len(dom):
        return T.NULL_I64
    return dom[idx]


# -- containers -------------------------------------------------------------

def _fmt_vector(o: Obj, limit: int) -> str:
    n = len(o)
    if n == 0:
        return "[]"
    parts = ["["]
    width = 1
    truncated = False
    for i in range(n):
        s = raw_fmt(o, i, 0, limit)
        parts.append(s)
        width += len(s)
        if _limit_reached(limit, width):
            truncated = True
            break
        if i + 1 < n:
            parts.append(" ")
            width += 1
            if _limit_reached(limit, width):
                truncated = True
                break
    parts.append("..]" if truncated else "]")
    return "".join(parts)


def _fmt_string(o: Obj, limit: int, full) -> str:
    # decode the byte buffer as UTF-8 first: the reference emits string
    # bytes raw (format.c c8_fmt_into "%c"), so a multibyte character
    # must reach the terminal as ONE character, not per-byte mojibake
    raw = bytes(bytearray(np.asarray(to_np(o), dtype=np.uint8)))
    try:
        chars = raw.decode("utf-8")
    except UnicodeDecodeError:
        chars = "".join(chr(x) for x in raw)
    parts = ['"'] if full else []
    width = 1 if full else 0
    truncated = False
    for ch in chars:
        c = ord(ch)
        s = fmt_c8(c, False) if c < 128 else ch
        parts.append(s)
        width += len(s)
        if _limit_reached(limit, width):
            truncated = True
            break
    if truncated:
        parts.append("..")
    if full:
        parts.append('"')
    return "".join(parts)


def _fmt_list(o: Obj, indent: int, limit: int, full) -> str:
    items = o.v
    h = len(items)
    if h == 0:
        return "()"
    shown = min(h, LIST_MAX_HEIGHT)
    if not full:
        parts = ["("]
        for i in range(shown):
            parts.append(format_obj(items[i], indent, limit, 0))
            if i + 1 < shown:
                parts.append(" ")
        if shown < h:
            parts.append("..")
        parts.append(")")
        return "".join(parts)
    ind = " " * (indent + 2)
    parts = ["("]
    for i in range(shown):
        parts.append("\n" + ind + format_obj(items[i], indent + 2, limit, 0))
    if shown < h:
        parts.append("\n" + ind + "..")
    parts.append("\n" + " " * indent + ")")
    return "".join(parts)


def _fmt_dict(o: Obj, indent: int, limit: int, full) -> str:
    keys, vals = o.v
    h = len(keys)
    if h == 0:
        return "{}"
    shown = min(h, LIST_MAX_HEIGHT)
    row_w = _state["row_width"]
    if not full:
        parts = ["{"]
        for i in range(shown):
            parts.append(raw_fmt(keys, i, indent, row_w))
            parts.append(": ")
            parts.append(raw_fmt(vals, i, indent, row_w))
            if i + 1 < shown:
                parts.append(" ")
        if shown < h:
            parts.append("..")
        parts.append("}")
        return "".join(parts)
    ind = " " * (indent + 2)
    parts = ["{"]
    for i in range(shown):
        parts.append("\n" + ind + raw_fmt(keys, i, indent + 2, row_w) + ": "
                     + raw_fmt(vals, i, indent + 2, row_w))
    if shown < h:
        parts.append("\n" + ind + "..")
    parts.append("\n" + " " * indent + "}")
    return "".join(parts)


def _fmt_enum(o: Obj, indent: int, limit: int) -> str:
    # prints 'domain-name#values (enum_fmt_into); ray_key gives the name
    dom = o.domain if (o.domain is not None and o.domain.t == -T.SYMBOL) \
        else enum_domain(o)
    n = len(o)
    cap = min(n, TABLE_MAX_HEIGHT) if n >= TABLE_MAX_HEIGHT else n
    ids = to_np(o)[:cap]
    sym_ids = np.array([_enum_sym_id(o, int(i)) for i in ids], dtype=np.int64)
    vals = Obj(T.SYMBOL, sym_ids)
    lim = TABLE_MAX_HEIGHT if n >= TABLE_MAX_HEIGHT else limit
    return ("'" + format_obj(dom, indent, lim, 0) + "#"
            + format_obj(vals, indent, lim, 0))


def _type_name_of_col(c: Obj) -> str:
    from ..ops.misc import type_name
    return type_name(c)


def _fmt_table(o: Obj, indent: int, full) -> str:
    names_o, cols = o.v
    names = to_np(names_o)
    ncols_all = len(names)
    if not full:
        return ("(table " + format_obj(names_o, indent, _state["row_width"], 0)
                + HDOTS + ")")
    if ncols_all == 0:
        return "@table"

    rows = len(o)
    tw = ncols_all
    th = rows
    if full == 1:
        tw = min(tw, TABLE_MAX_WIDTH)
        th = min(th, TABLE_MAX_HEIGHT)
    hidden_cols = (full == 1 and tw < ncols_all)

    # Format the shown cells: first half head rows, second half tail rows.
    col_strs: list[list[str]] = []
    type_names: list[str] = []
    widths: list[int] = []
    total = 0
    for ci in range(tw):
        col = cols[ci]
        col_len = len(col)
        tn = _type_name_of_col(col)
        type_names.append(tn)
        w = max(len(symbols.name_of(int(names[ci]))), len(tn))
        cells = []
        half = th // 2
        for j in range(half):
            s = raw_fmt(col, j, 0, 38) if j < col_len else "NA"
            cells.append(s)
            w = max(w, len(s))
        for j in range(half, th):
            if th == col_len:
                s = raw_fmt(col, j, 0, 38) if j < col_len else "NA"
            else:
                idx = col_len - th + j
                s = raw_fmt(col, idx, 0, 38) if 0 <= idx < col_len else "NA"
            cells.append(s)
            w = max(w, len(s))
        col_strs.append(cells)
        widths.append(w + 2)
        total += w + 2
    total += tw - 1

    footer = " %d rows (%d shown) %d columns (%d shown)" % (rows, th,
                                                            ncols_all, tw)
    # The reference's footer obj includes its NUL terminator in len
    # (str_fmt), which prints as one extra blank: account with +1.
    flen = len(footer) + 1
    if total < flen:
        widths[tw - 1] += flen - total
        total = flen
        for i in range(tw - 1):
            if widths[i] < 4:
                total += 4 - widths[i]
                widths[i] = 4
    if hidden_cols:
        total += 4

    ind = " " * indent
    out = []

    def border(lc, tee, rc):
        row = [lc]
        for i in range(tw):
            row.append(HLINE * widths[i])
            if i < tw - 1 or hidden_cols:
                row.append(tee)
            else:
                row.append(rc)
        if hidden_cols:
            row.append(HLINE * 3 + rc)
        return "".join(row)

    out.append(border(TL, T_TEE, TR))

    def centered_row(texts):
        row = [VLINE]
        for i in range(tw):
            lp = (widths[i] - len(texts[i])) // 2
            rp = widths[i] - len(texts[i]) - lp
            row.append(" " * lp + texts[i] + " " * rp + VLINE)
        if hidden_cols:
            row.append(" " + HDOTS + " " + VLINE)
        return "".join(row)

    out.append("\n" + ind + centered_row(
        [symbols.name_of(int(names[i])) for i in range(tw)]))
    out.append("\n" + ind + centered_row(type_names))
    out.append("\n" + ind + border(L_TEE, CROSS, R_TEE))

    for j in range(th):
        out.append("\n" + ind)
        if full == 1 and j == th // 2 and th != rows:
            row = [VDOTS]
            for i in range(tw):
                pad = widths[i] - 3 + 1
                row.append(" " + HDOTS + " " * pad + VDOTS)
            if hidden_cols:
                row.append(" " + HDOTS + " " + VDOTS)
            out.append("".join(row))
            out.append("\n" + ind)
        row = [VLINE]
        for i in range(tw):
            s = col_strs[i][j]
            row.append(" " + s + " " + " " * (widths[i] - len(s) - 2) + VLINE)
        if hidden_cols:
            row.append(" " + HDOTS + " " + VLINE)
        out.append("".join(row))

    out.append("\n" + ind + border(L_TEE, B_TEE, R_TEE))
    out.append("\n" + ind + VLINE + footer
               + " " * (total - len(footer)) + VLINE)
    out.append("\n" + BL + HLINE * total + BR)
    return "".join(out)


def _fmt_lambda(o: Obj, limit: int) -> str:
    lam = o.v
    if lam.name is not None:
        return "@" + lam.name
    return ("(fn " + format_obj(lam.args_obj, 0, limit, 0) + " "
            + format_obj(lam.body, 0, limit, 0) + ")")


def _fmt_error(e, limit: int) -> str:
    out = [f"Error: {e.kind}"]
    if e.msg:
        out.append(f"  - {e.msg}")
    return "\n".join(out)


# -- entry points -----------------------------------------------------------

def format_obj(o, indent: int = 0, limit=None, full=1) -> str:
    """obj_fmt_into equivalent. `full`: 0 bare, 1 limited, 2 show."""
    if limit is None:
        limit = _state["row_width"]
    if isinstance(o, RayError):
        return _fmt_error(o, limit)
    t = o.t
    if t < 0:
        st = -t
        if st == T.NULL:
            return "Null"
        if st == T.ENUM:
            return fmt_sym(_enum_sym_id(o, int(o.v)), bool(full))
        if st in _SCALAR:
            return _SCALAR[st](o.v, bool(full))
        raise RayError("nyi", f"format atom type {t}")
    if t == T.C8:
        return _fmt_string(o, limit, full)
    if T.is_vector(t) and t != T.ENUM and t not in T.UNPARTED_OF:
        return _fmt_vector(o, limit)
    if t in T.UNPARTED_OF:
        from ..ops.parted import parted_raze
        return _fmt_vector(parted_raze(o), limit)
    if t == T.LIST:
        return _fmt_list(o, indent, limit, full)
    if t == T.ENUM:
        return _fmt_enum(o, indent, limit)
    if t == T.DICT:
        return _fmt_dict(o, indent, limit, full)
    if t == T.TABLE:
        return _fmt_table(o, indent, full)
    if t == T.LAMBDA:
        return _fmt_lambda(o, limit)
    if t in (T.UNARY, T.BINARY, T.VARY):
        return o.v.name
    if t == T.MAPGROUP or t == T.MAPFILTER:
        from .interp import collect_lazy
        return format_obj(collect_lazy(o), indent, limit, full)
    raise RayError("nyi", f"format type {t}")


def format_top(o) -> str:
    """The single-arg `format` builtin: obj_fmt(x, x.type != C8)
    (reference core/format.c obj_fmt_n n==1)."""
    full = 0 if (not isinstance(o, RayError) and o.t == T.C8) else 1
    return format_obj(o, 0, _state["row_width"], full)
