"""Typed CSV reader/writer (reference core/io.c:367-1029).

`(read-csv [types] path [sep])`: first row is the header (column names);
each column parses to its declared type. The reference parallelizes by
line ranges over its pool; here numpy does the columnar conversion after a
single split pass (the device path never touches CSV — loads land in
host columns, then stage to device memory).
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core import symbols, temporal, fmt
from ..core.obj import Obj, to_np, table, vec_sym, string, str_of
from ..core.errors import RayError, err_type, err_value


def _parse_col(vals: list, t: int) -> Obj:
    """Column conversion with the reference's null rule
    (parse_csv_line, io.c:473-532): a MISSING field (one that starts
    at line end — vals holds None) is a typed null, while an EMPTY
    field followed by a separator is a zero-length span that parses as
    a zero value (0 / 0.0 / false); temporal parses are lenient
    digit-run reads that yield nulls on malformed input."""
    n = len(vals)
    if t == T.SYMBOL:
        # both the missing and the empty field intern to the null
        # symbol (io.c:440-450: NULL span -> id 0 == 0Ns)
        ids = np.fromiter(
            (symbols.intern(v) if v else T.NULL_I64 for v in vals),
            dtype=np.int64, count=n)
        return Obj(T.SYMBOL, ids)
    if t == T.C8:
        from ..core.obj import list_
        return list_([string(v or "") for v in vals])
    if t == T.F64:
        from ..ops.cast import _f64_from_str
        out = np.empty(n, dtype=np.float64)
        for i, v in enumerate(vals):
            # strtod-prefix semantics: "0Nf" in a CSV cell reads 0.0
            # (f64_from_str); only a MISSING cell is null
            out[i] = T.NULL_F64 if v is None else _f64_from_str(v)
        return Obj(T.F64, out)
    if t == T.B8:
        # b8_from_str (string.c:108): "true"/"True"/"TRUE" prefix is
        # true, anything else (including missing) is false
        out = np.fromiter(
            (1 if v is not None and v[:4] in ("true", "True", "TRUE")
             else 0 for v in vals), dtype=np.int8, count=n)
        return Obj(T.B8, out)
    if t in (T.I16, T.I32, T.I64, T.U8):
        from ..ops.cast import _int_from_str
        out = np.empty(n, dtype=T.DTYPE[t])
        nullv = T.NULL_BY_TYPE.get(t, 0)
        for i, v in enumerate(vals):
            out[i] = nullv if v is None \
                else np.int64(_int_from_str(v)).astype(T.DTYPE[t])
        return Obj(t, out)
    if t == T.DATE:
        from ..ops.cast import _date_from_str
        out = np.empty(n, dtype=np.int32)
        for i, v in enumerate(vals):
            out[i] = T.NULL_I32 if not v else _date_from_str(v)
        return Obj(T.DATE, out)
    if t == T.TIME:
        from ..ops.cast import _time_from_str
        out = np.empty(n, dtype=np.int32)
        for i, v in enumerate(vals):
            out[i] = T.NULL_I32 if not v else _time_from_str(v)
        return Obj(T.TIME, out)
    if t == T.TIMESTAMP:
        from ..ops.cast import _ts_from_str
        out = np.empty(n, dtype=np.int64)
        for i, v in enumerate(vals):
            out[i] = T.NULL_I64 if not v else _ts_from_str(v)
        return Obj(T.TIMESTAMP, out)
    if t == T.GUID:
        from ..ops.cast import _guid_from_str
        out = np.zeros((n, 16), dtype=np.uint8)
        for i, v in enumerate(vals):
            if v:   # missing/malformed -> NULL_GUID (all zeros)
                out[i] = _guid_from_str(v)
        return Obj(T.GUID, out)
    raise err_type(f"read-csv: unsupported column type {t}")


def _split_line(line: str, sep: str):
    """Field split with the reference's quote rule (io.c:491-505): a
    field STARTING with '\"' runs to the next '\"' (no doubled-quote
    escapes), then the separator follows. Returns (fields,
    last_quoted) — a quoted empty last field is a real zero-length
    span, not a missing field."""
    out = []
    i = 0
    n = len(line)
    lastq = False
    while i <= n:
        if i < n and line[i] == '"':
            j = line.find('"', i + 1)
            if j < 0:
                raise RayError("length", "read-csv: unterminated quote")
            out.append(line[i + 1:j])
            lastq = True
            i = j + 2   # skip quote and separator
            if i > n:
                break
        else:
            j = line.find(sep, i)
            lastq = False
            if j < 0:
                out.append(line[i:])
                break
            out.append(line[i:j])
            i = j + 1
    return out, lastq


def _read_csv_native(tcodes, path: str, sep: str):
    """Multithreaded typed parse via the C++ runtime
    (native/rayforce_native.cpp, the analogue of the reference's
    parallel line-range CSV, core/io.c:535-632). Returns None when the
    native library or a column type is unavailable."""
    from .native import NativeCsv, lib
    from ..core.obj import list_
    if lib() is None:
        return None
    if any(t not in (T.I16, T.I32, T.I64, T.U8, T.B8, T.F64, T.SYMBOL,
                     T.DATE, T.TIME, T.TIMESTAMP, T.C8)
           for t in tcodes):
        return None
    with open(path, "rb") as f:
        data = f.read()
    nc = NativeCsv(data, sep)
    if nc.n_rows == 0:
        return None
    hdr_end = data.find(b"\n")
    header = data[:hdr_end if hdr_end >= 0 else len(data)] \
        .rstrip(b"\r").decode().split(sep)
    if len(tcodes) != len(header):
        raise RayError("length", "read-csv type count mismatch")
    nc.slice_rows(1, nc.n_rows)   # drop the header line
    if nc.n_rows:
        mf = nc.min_fields()
        if mf < 0 or mf < len(tcodes):
            # unterminated quote / short line: the Python path raises
            # the reference's err_length (io.c:496-499, 520-523)
            return None
    cols = []
    for i, t in enumerate(tcodes):
        if t == T.B8:
            cols.append(Obj(T.B8, nc.col_b8(i)))
        elif t in (T.I16, T.I32, T.I64, T.U8):
            nullv = int(T.NULL_BY_TYPE.get(t, 0))
            a = nc.col_i64(i, nullv)
            cols.append(Obj(t, a.astype(T.DTYPE[t])))
        elif t == T.F64:
            cols.append(Obj(T.F64, nc.col_f64(i)))
        elif t == T.DATE:
            cols.append(Obj(T.DATE,
                            nc.col_date(i, int(T.NULL_I32))))
        elif t == T.TIME:
            cols.append(Obj(T.TIME,
                            nc.col_time(i, int(T.NULL_I32))))
        elif t == T.TIMESTAMP:
            cols.append(Obj(T.TIMESTAMP,
                            nc.col_timestamp(i, int(T.NULL_I64))))
        elif t == T.SYMBOL:
            strs, inv = nc.col_strings(i)
            # empty field -> NULL symbol (matches _parse_col)
            ids = np.fromiter(
                (symbols.intern(s) if s else T.NULL_I64 for s in strs),
                dtype=np.int64, count=len(strs))
            cols.append(Obj(T.SYMBOL, ids[inv]))
        else:  # C8
            cols.append(list_([string(b) for b in nc.col_raw(i)]))
    return table(vec_sym(header), cols)


# Which parser produced the last read-csv result ("native" |
# "python") — provenance for tests and the -t profiler.
last_engine: str = ""


def read_csv(types_o: Obj, path: str, sep: str = ",") -> Obj:
    global last_engine
    from ..ops.cast import NAME2TYPE
    if types_o.t != T.SYMBOL:
        raise err_type("read-csv needs a type vector")
    tnames = [symbols.name_of(int(s)) for s in to_np(types_o)]
    tcodes = []
    for nm in tnames:
        t = NAME2TYPE.get(nm)
        t = abs(t) if t is not None else None
        if t is None:
            raise err_value(f"unknown type {nm}")
        tcodes.append(t)
    try:
        fast = _read_csv_native(tcodes, path, sep)
        if fast is not None:
            last_engine = "native"
            return fast
    except RayError:
        raise
    except Exception:
        pass  # fall back to the Python parser
    last_engine = "python"
    with open(path, "r", newline="") as f:
        header = f.readline().rstrip("\r\n").split(sep)
        ncols = len(header)
        raw_cols: list[list] = [[] for _ in header]
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                # blank line: every field is missing -> a null row
                # (parse_csv_line len==0 branch per field)
                for col in raw_cols:
                    col.append(None)
                continue
            if '"' in line:
                parts, lastq = _split_line(line, sep)
            else:
                parts, lastq = line.split(sep), False
            if len(parts) < ncols:
                # a non-last field with no following separator is a
                # length error in the reference (io.c:520-523)
                raise RayError("length", "read-csv: short line")
            if len(parts) == ncols and parts[-1] == "" and not lastq:
                parts[-1] = None   # field starting at line end: null
            for i in range(ncols):
                raw_cols[i].append(parts[i])
    if len(tcodes) != len(header):
        raise RayError("length", "read-csv type count mismatch")
    cols = [_parse_col(raw_cols[i], tcodes[i]) for i in range(len(header))]
    return table(vec_sym(header), cols)


def write_csv(path: str, tbl: Obj, sep: str = ",") -> None:
    if tbl.t != T.TABLE:
        raise err_type("write-csv needs a table")
    names_o, cols = tbl.v
    names = [symbols.name_of(int(s)) for s in to_np(names_o)]
    n = len(tbl)
    with open(path, "w") as f:
        f.write(sep.join(names) + "\n")
        from ..core.obj import at_idx
        for i in range(n):
            row = []
            for c in cols:
                row.append(fmt.format_obj(at_idx(c, i), 0, None, 0))
            f.write(sep.join(row) + "\n")
