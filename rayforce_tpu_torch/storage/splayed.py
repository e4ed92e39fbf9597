"""Splayed tables: one directory, a `.d` column-name file, one mmap-able
file per column; symbol columns become enums over a shared `sym` file
(reference core/io.c io_set_table_splayed:1194-1363).
"""
from __future__ import annotations

import os

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import Obj, to_np, table, sym, vec_sym
from ..core.errors import RayError, err_type
from . import binary


def set_splayed(path: str, tbl: Obj, symfile: str | None = None,
                interp=None) -> None:
    """Write a table splayed into `path/`; symbol columns are enumerated
    over `sym` (local file or the shared `symfile`, merge-preserving)."""
    if tbl.t != T.TABLE:
        raise err_type("set-splayed needs a table")
    os.makedirs(path, exist_ok=True)
    names_o, cols = tbl.v
    binary.set_path(os.path.join(path, ".d"), names_o)

    # collect the symbol domain
    sym_ids: list[int] = []
    seen = set()
    for c in cols:
        if c.t == T.SYMBOL:
            for s in to_np(c):
                if int(s) not in seen:
                    seen.add(int(s))
                    sym_ids.append(int(s))
    if sym_ids:
        dom = Obj(T.SYMBOL, np.asarray(sym_ids, dtype=np.int64))
        if symfile is not None and os.path.exists(symfile):
            # merge-preserving re-enumeration (io.c:1230-1260)
            old = binary.get_path(symfile)
            old_ids = [int(x) for x in to_np(old)]
            extra = [s for s in sym_ids if s not in set(old_ids)]
            dom = Obj(T.SYMBOL,
                      np.asarray(old_ids + extra, dtype=np.int64))
        target = symfile if symfile is not None \
            else os.path.join(path, "sym")
        binary.set_path(target, dom)
        # bind the in-process global `sym` so enum columns resolve
        if interp is None:
            from ..core.interp import current_interp
            interp = current_interp()
        if interp is not None:
            interp.globals[symbols.intern("sym")] = dom
        dom_pos = {int(s): i for i, s in enumerate(to_np(dom))}

    names = [symbols.name_of(int(s)) for s in to_np(names_o)]
    for nm, c in zip(names, cols):
        fp = os.path.join(path, nm)
        if c.t == T.SYMBOL:
            ids = np.asarray([dom_pos[int(s)] for s in to_np(c)],
                             dtype=np.int64)
            e = Obj(T.ENUM, ids, domain=sym("sym"))
            binary.set_path(fp, e)
        elif c.t == T.LIST:
            raise err_type("cannot splay list columns")
        else:
            binary.set_path(fp, c)


def get_splayed(path: str, interp=None) -> Obj:
    """mmap-load a splayed table (io.c io_get_table_splayed:1310)."""
    names_o = binary.get_path(os.path.join(path, ".d"))
    if names_o.t != T.SYMBOL:
        raise RayError("parse", "bad .d file")
    symp = os.path.join(path, "sym")
    dom = None
    if os.path.exists(symp):
        dom = binary.get_path(symp)
        if interp is None:
            from ..core.interp import current_interp
            interp = current_interp()
        if interp is not None:
            interp.globals[symbols.intern("sym")] = dom
    cols = []
    for s in to_np(names_o):
        nm = symbols.name_of(int(s))
        c = binary.get_path(os.path.join(path, nm))
        # bind the loaded domain DIRECTLY: a named domain resolved via
        # the current interpreter breaks when several Runtimes coexist
        # in one process (the other engine's `sym` global would win)
        if c.t == T.ENUM and dom is not None:
            c.domain = dom
        cols.append(c)
    return table(names_o, cols)
