"""Introspection & output: type/count/rc/meta/show/format/print/println/
set-fpr/memstat/sysinfo (reference core/misc.c, format.c entry points)."""
from __future__ import annotations

import sys

import numpy as np

from ..core import types as T
from ..core import symbols, fmt
from ..core.obj import Obj, to_np, list_, dict_, string, sym, vec_sym, \
    NULL_OBJ, str_of
from ..core.errors import RayError, err_type


def type_name(o: Obj) -> str:
    t = o.t
    if isinstance(o, RayError):
        return "ERROR"
    if t < 0:
        st = -t
        if st == T.NULL:
            return "NULL"
        if st == T.ENUM:
            return "enum"
        return T.TYPE_NAMES.get(st, "?")
    if t == T.LIST:
        return "LIST"
    if t <= T.ENUM or t in (T.TABLE, T.DICT, T.LAMBDA, T.UNARY, T.BINARY,
                            T.VARY):
        base = T.TYPE_NAMES.get(t, "?")
        if t in (T.TABLE, T.DICT, T.LAMBDA, T.UNARY, T.BINARY, T.VARY):
            return base.upper()
        return base.upper()
    if t in T.UNPARTED_OF:
        return "PARTED" + T.TYPE_NAMES[T.UNPARTED_OF[t]].upper()
    if t == T.MAPGROUP:
        return "MAPGROUP"
    if t == T.MAPFILTER:
        return "MAPFILTER"
    if t == T.NULL:
        return "NULL"
    return "?"


def ray_type(o: Obj) -> Obj:
    return sym(type_name(o))


def ray_rc(o: Obj) -> Obj:
    return Obj(-T.I64, np.int64(sys.getrefcount(o) - 2))


def ray_meta(o: Obj) -> Obj:
    """meta of a table = table [name type mmod attrs] with one row per
    column (misc.c meta_table); other types get a small info dict."""
    from ..core.obj import table as mk_table
    if o.t == T.TABLE:
        names, cols = o.v
        tnames = vec_sym([type_name(c) for c in cols])
        n = len(cols)
        # mmod is a heap-internal byte; host objects report 255
        mmod = Obj(T.I64, np.full(n, 255, dtype=np.int64))
        attrs = Obj(T.I64, np.asarray([names.attrs] * n, dtype=np.int64))
        return mk_table(vec_sym(["name", "type", "mmod", "attrs"]),
                        [names, tnames, mmod, attrs])
    if o.t == T.DICT:
        k, v = o.v
        return dict_(vec_sym(["type", "len", "key_type", "val_type",
                              "keys"]),
                     list_([sym(type_name(o)),
                            Obj(-T.I64, np.int64(len(k))),
                            sym(type_name(k)),
                            sym(type_name(v)),
                            k]))
    if o.t >= 0 and o.t != T.LIST:
        return dict_(vec_sym(["type", "len", "mmod", "attrs"]),
                     list_([sym(type_name(o)),
                            Obj(-T.I64, np.int64(len(o))),
                            Obj(-T.I64, np.int64(255)),
                            Obj(-T.I64, np.int64(o.attrs))]))
    return dict_(vec_sym(["type", "mmod", "attrs"]),
                 list_([sym(type_name(o)),
                        Obj(-T.I64, np.int64(255)),
                        Obj(-T.I64, np.int64(o.attrs))]))


def _mem_of(o: Obj) -> int:
    try:
        a = to_np(o)
        return int(a.nbytes)
    except Exception:
        return 0


def ray_show(o: Obj) -> Obj:
    print(fmt.format_obj(o, 0, fmt.NO_LIMIT, 2))
    return NULL_OBJ


def obj_fmt_n(args: list):
    """format/print/println shared: single arg -> full format; multiple ->
    '%' placeholder substitution in bare mode (format.c obj_fmt_n)."""
    if not args:
        return None
    if len(args) == 1:
        return fmt.format_top(args[0])
    if args[0].t != T.C8:
        return None
    template = str_of(args[0])
    parts = template.split("%")
    if len(parts) - 1 < len(args) - 1:
        return None
    if len(parts) - 1 > len(args) - 1:
        return None
    out = [parts[0]]
    for i, a in enumerate(args[1:], 1):
        out.append(fmt.format_obj(a, 0, None, 0))
        out.append(parts[i])
    return "".join(out)


def ray_format(args: list) -> Obj:
    s = obj_fmt_n(args)
    if s is None:
        raise RayError("parse", "bad format")
    if s == "":
        # the reference's obj_fmt never allocates for zero rendered
        # bytes, so (format "") returns the NULL object (format.c
        # obj_fmt: dst stays NULL_OBJ)
        return NULL_OBJ
    return string(s)


def ray_print(args: list) -> Obj:
    s = obj_fmt_n(args)
    if s is None:
        raise RayError("parse", "bad format")
    sys.stdout.write(s)
    sys.stdout.flush()
    return NULL_OBJ


def ray_println(args: list) -> Obj:
    s = obj_fmt_n(args)
    if s is None:
        raise RayError("parse", "bad format")
    sys.stdout.write(s + "\n")
    return NULL_OBJ


def ray_set_fpr(o: Obj) -> Obj:
    if o.t == -T.NULL:
        fmt.set_fpr(None)
    else:
        fmt.set_fpr(int(o.v))
    return NULL_OBJ


def ray_memstat(args: list) -> Obj:
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return dict_(vec_sym(["msys", "heap", "free", "syms"]),
                 list_([Obj(-T.I64, np.int64(ru.ru_maxrss * 1024)),
                        Obj(-T.I64, np.int64(0)),
                        Obj(-T.I64, np.int64(0)),
                        Obj(-T.I64, np.int64(symbols.count()))]))


def ray_sysinfo(args: list) -> Obj:
    import platform
    import torch
    devs = [torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())]
    return dict_(vec_sym(["os", "arch", "devices"]),
                 list_([string(platform.system().lower()),
                        string(platform.machine()),
                        list_([string(d) for d in devs])]))


def ray_row(o: Obj) -> Obj:
    """(row x): in a grouped select, the per-group ROW-ID vectors; on a
    plain value, its count (reference compose.c:1166 ray_row default
    branch returns ops_count)."""
    if o.t == T.MAPGROUP:
        from .aggr import aggr_row
        return aggr_row(o.v[0], o.v[1])
    if o.t == T.MAPFILTER:
        from .aggr import aggr_row
        from .group import GroupIndex
        _val, f = o.v
        if f.t == T.I64:
            ids = to_np(f)
            gi = GroupIndex(np.zeros(len(ids), dtype=np.int64), 1,
                            np.zeros(1, dtype=np.int64))
            return aggr_row(o, gi)
    from .items import ray_count
    return ray_count(o)
