"""Date-parted databases: `db/<partition>/<table>/<cols>`
(reference core/vary.c ray_get_parted:185-391).

The loader scans partition directories (date-named), sorts them, validates
schemas, and builds a table whose columns are TYPE_PARTED* lists of
mmapped per-partition vectors, plus a virtual partition column (the date)
represented as a MAPCOMMON-style parted column holding the partition value
repeated per row. Query kernels stream partition-at-a-time (ops/parted.py).
"""
from __future__ import annotations

import os
import re

import numpy as np

from ..core import types as T
from ..core import symbols, temporal
from ..core.obj import Obj, to_np, table, vec_sym
from ..core.errors import RayError, err_type
from . import binary, splayed

_DATE_RE = re.compile(r"^(\d{4})\.(\d{2})\.(\d{2})$")


def set_parted(db: str, part: str, tbl_name: str, tbl: Obj,
               interp=None) -> None:
    """Write one partition of a parted DB (splayed under
    db/part/tbl_name, sym file shared at db/sym)."""
    path = os.path.join(db, part, tbl_name)
    os.makedirs(path, exist_ok=True)
    splayed.set_splayed(path, tbl, symfile=os.path.join(db, "sym"),
                        interp=interp)


_INT_RE = re.compile(r"^\d+$")


def get_parted(db: str, tbl_name: str, interp=None) -> Obj:
    """Load a parted table: columns become parted lists of mmaps. Date-
    named partition dirs yield a virtual `Date` column, integer-named
    dirs a virtual `Id` column (reference core/vary.c:185-391); either
    is a per-partition CONSTANT (value + rowcount, MAPCOMMON) — never
    materialized per row."""
    date_parts = []
    int_parts_l = []
    for d in sorted(os.listdir(db)):
        if os.path.isdir(os.path.join(db, d, tbl_name)):
            if _DATE_RE.match(d):
                date_parts.append(d)
            elif _INT_RE.match(d):
                int_parts_l.append(d)
    if date_parts and int_parts_l:
        raise RayError(
            "os", f"mixed date/integer partition names in {db}: "
            f"{date_parts[0]} vs {int_parts_l[0]}")
    int_parts = bool(int_parts_l)
    parts = sorted(int_parts_l, key=int) if int_parts else date_parts
    if not parts:
        raise RayError("os", f"no partitions for {tbl_name} in {db}")
    # shared sym
    symp = os.path.join(db, "sym")
    dom = None
    if os.path.exists(symp):
        dom = binary.get_path(symp)
        if interp is None:
            from ..core.interp import current_interp
            interp = current_interp()
        if interp is not None:
            interp.globals[symbols.intern("sym")] = dom

    from ..core.progress import Progress
    prog = Progress(f"load {tbl_name}", len(parts))
    per_part = []
    schema = None
    for p in parts:
        path = os.path.join(db, p, tbl_name)
        names_o = binary.get_path(os.path.join(path, ".d"))
        names = tuple(int(s) for s in to_np(names_o))
        if schema is None:
            schema = names
            schema_o = names_o
        elif names != schema:
            raise err_type(f"partition {p} schema mismatch")
        cols = []
        for s in names:
            nm = symbols.name_of(s)
            cols.append(binary.get_path(os.path.join(path, nm)))
        per_part.append(cols)
        prog.step()

    prog.finish()
    from ..core.obj import ConstPending
    ncols = len(schema)
    out_cols = []
    # virtual Date/Id column: per-partition constants (MAPCOMMON)
    vparts = []
    for p, cols in zip(parts, per_part):
        n = len(cols[0])
        if int_parts:
            vparts.append(Obj(T.I64, ConstPending(
                np.int64(int(p)), n, np.int64)))
        else:
            y, mo, d = map(int, p.split("."))
            days = temporal.days_from_civil(y, mo, d)
            vparts.append(Obj(T.DATE, ConstPending(
                np.int32(days), n, np.int32)))
    vt = T.I64 if int_parts else T.DATE
    out_cols.append(Obj(T.PARTED_OF[vt], vparts))
    names = [symbols.intern("Id" if int_parts else "Date")] \
        + list(schema)
    for ci in range(ncols):
        pieces = [per_part[pi][ci] for pi in range(len(parts))]
        base = pieces[0].t
        pt = T.PARTED_OF.get(base)
        if pt is None:
            raise err_type("unsupported parted column type")
        col = Obj(pt, pieces)
        if base == T.ENUM:
            # bind the loaded shared domain DIRECTLY on every piece: a
            # named domain resolved through the current interpreter
            # breaks when several Runtimes coexist in one process (the
            # other engine's `sym` global would win)
            if dom is not None:
                for pc in pieces:
                    pc.domain = dom
            col.domain = pieces[0].domain
        out_cols.append(col)
    return table(Obj(T.SYMBOL, np.asarray(names, dtype=np.int64)),
                 out_cols)
