"""Mutation family: insert / upsert / alter / modify
(reference core/update.c). All copy-on-write: when the target is a quoted
symbol naming a global, the rebuilt value is stored back (reference __fetch
+ UNCOW discipline); otherwise a new value is returned.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import (Obj, to_np, list_, dict_, table, at_idx, NULL_OBJ,
                        atom_null, col_by_name)
from ..core.errors import (RayError, err_type, err_arity, err_length,
                           err_domain, err_value)
from .compose import gather, take_n, unify_list, ray_concat, ray_remove
from .vops import is_null_np


def fetch_target(interp, x: Obj):
    """Resolve a mutation target: ('name, value) for symbol targets (write
    back after), (None, value) otherwise."""
    if x.t == -T.SYMBOL:
        v = interp.resolve(int(x.v))
        if v is None:
            raise err_value("not found")
        return int(x.v), v
    return None, x


def store_back(interp, sid, val):
    if sid is not None:
        interp.globals[sid] = val


# -- insert -----------------------------------------------------------------

def _reorder_rows(tbl: Obj, rows: Obj):
    """dict/table input -> LIST of per-column values in table column order;
    missing columns -> None (update.c __reorder_columns)."""
    tnames = to_np(tbl.v[0])
    if rows.t == T.DICT:
        rnames, rvals = rows.v
        if rnames.t != T.SYMBOL:
            raise err_type("insert dict needs symbol keys")
        rcols = list(rvals.v) if rvals.t == T.LIST else \
            [at_idx(rvals, i) for i in range(len(rvals))]
    elif rows.t == T.TABLE:
        rnames, rcols = rows.v
    else:
        return None
    rid = {int(s): i for i, s in enumerate(to_np(rnames))}
    if len(rid) > len(tnames):
        raise err_length("more columns than table")
    out = []
    for s in tnames:
        i = rid.get(int(s))
        out.append(rcols[i] if i is not None else None)
    return out


def _col_append(col: Obj, v) -> Obj:
    """Append value(s)/nulls to a column."""
    n_new = 1 if (v is None or v.t < 0) else len(v)
    if v is None:
        t = col.t
        if t == T.LIST:
            return list_(col.v + [NULL_OBJ] * n_new)
        nullv = T.NULL_BY_TYPE.get(t)
        if nullv is None:
            raise err_type("cannot null-fill this column type")
        add = np.full(n_new, nullv, dtype=T.DTYPE[t])
        return Obj(t, np.concatenate([to_np(col), add]), domain=col.domain)
    return ray_concat(col, v)


def _suitable(col: Obj, v: Obj) -> bool:
    if col.t == T.LIST:
        return True
    ct = col.t
    vt = abs(v.t)
    if ct == T.ENUM:
        return vt in (T.SYMBOL, T.ENUM)
    return ct == vt


def ray_insert(interp, args: list) -> Obj:
    if len(args) != 2:
        raise err_arity("insert needs 2 args")
    sid, tbl = fetch_target(interp, args[0])
    if tbl.t != T.TABLE:
        raise err_type("insert needs a table")
    rows = args[1]
    reordered = _reorder_rows(tbl, rows)
    names, cols = tbl.v
    if reordered is None:
        if rows.t != T.LIST:
            raise err_type("insert needs a list/dict/table")
        vals = list(rows.v)
        if len(vals) > len(cols):
            raise err_length("more values than columns")
        reordered = vals + [None] * (len(cols) - len(vals))
    new_cols = []
    for col, v in zip(cols, reordered):
        if v is not None and not _suitable(col, v):
            raise err_type("insert value type mismatch")
        if v is not None and col.t == T.ENUM and abs(v.t) == T.SYMBOL:
            from ..core.obj import enum_domain
            dom = to_np(enum_domain(col))
            pos = {int(s): i for i, s in enumerate(dom)}
            ids = [pos.get(int(x), -1) for x in
                   (to_np(v) if v.t > 0 else [v.v])]
            if any(i < 0 for i in ids):
                raise err_domain("symbol not in enum domain")
            v = Obj(T.ENUM if v.t > 0 else -T.ENUM,
                    np.asarray(ids, dtype=np.int64)
                    if v.t > 0 else np.int64(ids[0]), domain=col.domain)
        new_cols.append(_col_append(col, v))
    out = table(names, new_cols)
    store_back(interp, sid, out)
    if sid is not None:
        # a NAMED insert returns the target symbol (oracle-pinned:
        # (insert 't {a: 5}) -> t), like alter/modify
        from ..core.obj import sym
        return sym(sid)
    return out


# -- upsert -----------------------------------------------------------------

def ray_upsert(interp, args: list) -> Obj:
    """(upsert t nkeys rows): match on the first nkeys columns; update hits,
    append misses (update.c:556-750)."""
    if len(args) != 3:
        raise err_arity("upsert needs 3 args")
    if args[1].t != -T.I64 and abs(args[1].t) not in (T.I16, T.I32, T.I64):
        raise err_type("upsert key count must be an integer")
    nkeys = int(args[1].v)
    if nkeys < 1:
        raise err_domain("upsert needs >=1 key")
    sid, tbl = fetch_target(interp, args[0])
    if tbl.t != T.TABLE:
        raise err_type("upsert needs a table")
    rows = args[2]
    reordered = _reorder_rows(tbl, rows)
    names, cols = tbl.v
    if reordered is None:
        if rows.t != T.LIST:
            raise err_type("upsert needs a list/dict/table")
        vals = list(rows.v)
        reordered = vals + [None] * (len(cols) - len(vals))
    if any(reordered[i] is None for i in range(nkeys)):
        raise err_domain("upsert key columns required")
    # normalize incoming values to vectors of equal length
    in_len = None
    for v in reordered:
        if v is not None and v.t >= 0 and v.t != T.LIST:
            in_len = len(v) if in_len is None else in_len
    if in_len is None:
        in_len = 1
    norm = []
    for v in reordered:
        if v is None:
            norm.append(None)
        elif v.t < 0:
            norm.append(take_n(v, in_len))
        else:
            norm.append(v)
    # match keys (reference quirk: a single atoms-record with nkeys > 1
    # never matches and is always appended — oracle-pinned)
    from .join import left_join_ids
    atoms_row = all(v is None or v.t < 0 for v in reordered)
    if atoms_row and nkeys > 1:
        hit_ids = np.full(in_len, T.NULL_I64, dtype=np.int64)
    else:
        lk = [norm[i] for i in range(nkeys)]
        rk = [cols[i] for i in range(nkeys)]
        hit_ids = left_join_ids(lk, rk)  # per input row: row id or NULL
    hits = hit_ids != T.NULL_I64
    new_cols = [to_np(c).copy() if c.t != T.LIST else list(c.v)
                for c in cols]
    # update matched rows
    for ci, (col, v) in enumerate(zip(cols, norm)):
        if v is None:
            continue
        va = to_np(v) if v.t != T.LIST else v.v
        if col.t == T.LIST:
            for i, h in enumerate(hits):
                if h:
                    new_cols[ci][int(hit_ids[i])] = v.v[i]
        else:
            tgt = new_cols[ci]
            sel = hit_ids[hits]
            tgt[sel] = np.asarray(va)[hits]
    out_cols = [Obj(c.t, nc, domain=c.domain) if c.t != T.LIST
                else list_(nc) for c, nc in zip(cols, new_cols)]
    # append missed rows
    if (~hits).any():
        miss = np.nonzero(~hits)[0].astype(np.int64)
        for ci, (col, v) in enumerate(zip(out_cols, norm)):
            if v is None:
                out_cols[ci] = _col_append(col, None)
            else:
                out_cols[ci] = _col_append(col, gather(v, miss))
    out = table(names, out_cols)
    store_back(interp, sid, out)
    if sid is not None:
        from ..core.obj import sym
        return sym(sid)   # named upsert returns the symbol, like insert
    return out


# -- alter / modify ---------------------------------------------------------

def _apply_alter(interp, obj: Obj, fn: Obj, idx, val: Obj) -> Obj:
    """__alter: no idx -> obj = fn(obj, val); with idx -> amend at
    indices."""
    from .iter import _call
    if idx is None:
        return _call(interp, fn, [obj, val])
    is_set = fn.t in (T.UNARY, T.BINARY, T.VARY) and fn.v.name == "set"
    if obj.t == T.LIST:
        items = list(obj.v)
        ids = [int(idx.v)] if idx.t < 0 else [int(i) for i in to_np(idx)]
        vs = [val] * len(ids) if val.t < 0 or len(ids) == 1 else \
            [at_idx(val, i) for i in range(len(ids))]
        if val.t >= 0 and len(ids) > 1 and len(val) == len(ids):
            vs = [at_idx(val, i) for i in range(len(ids))]
        for k, i in enumerate(ids):
            if i < 0 or i >= len(items):
                raise RayError("index", "alter index out of range")
            items[i] = vs[min(k, len(vs) - 1)] if is_set else \
                _call(interp, fn, [items[i], vs[min(k, len(vs) - 1)]])
        return list_(items)
    if obj.t == T.TABLE:
        # idx = column symbols
        names, cols = obj.v
        ncols = list(cols)
        targets = [int(idx.v)] if idx.t < 0 else list(to_np(idx))
        nm = to_np(names)
        for t_sid in targets:
            hit = np.nonzero(nm == t_sid)[0]
            if not len(hit):
                raise err_value("no such column")
            ci = int(hit[0])
            ncols[ci] = val if is_set else \
                _call(interp, fn, [ncols[ci], val])
        return table(names, ncols)
    if obj.t == T.DICT:
        keys, vals = obj.v
        from .items import _dict_find
        i = _dict_find(keys, idx if idx.t < 0 else at_idx(idx, 0))
        if i is None:
            raise err_value("no such key")
        nv = list(vals.v) if vals.t == T.LIST else \
            [at_idx(vals, j) for j in range(len(vals))]
        nv[i] = val if is_set else _call(interp, fn, [nv[i], val])
        return dict_(keys, unify_list(nv))
    if obj.t > 0:
        a = to_np(obj).copy()
        ids = np.asarray([int(idx.v)] if idx.t < 0 else to_np(idx),
                         dtype=np.int64)
        if (ids < 0).any() or (ids >= len(a)).any():
            raise RayError("index", "alter index out of range")
        if is_set:
            if val.t < 0:
                if obj.t == T.GUID:
                    a[ids] = np.asarray(val.v)
                else:
                    a[ids] = T.DTYPE[obj.t](val.v)
            else:
                a[ids] = to_np(val)
            return Obj(obj.t, a, domain=obj.domain)
        cur = Obj(obj.t, a[ids], domain=obj.domain)
        res = _call(interp, fn, [cur, val])
        a[ids] = to_np(res)
        return Obj(obj.t, a, domain=obj.domain)
    raise err_type("cannot alter this type")


def ray_alter(interp, args: list) -> Obj:
    if len(args) < 3:
        raise err_arity("alter needs 3 or 4 args")
    sid, obj = fetch_target(interp, args[0])
    fn = args[1]
    if fn.t not in (T.LAMBDA, T.UNARY, T.BINARY, T.VARY):
        raise err_type("alter needs a function")
    if len(args) == 4:
        out = _apply_alter(interp, obj, fn, args[2], args[3])
    else:
        out = _apply_alter(interp, obj, fn, None, args[2])
    store_back(interp, sid, out)
    if sid is None:
        return out
    from ..core.obj import sym
    return sym(sid)


def ray_modify(interp, args: list) -> Obj:
    """(modify target fn path val): amend at a nested path
    (update.c:359)."""
    if len(args) < 4:
        raise err_arity("modify needs 4 args")
    sid, obj = fetch_target(interp, args[0])
    fn = args[1]
    if fn.t not in (T.LAMBDA, T.UNARY, T.BINARY, T.VARY):
        raise err_type("modify needs a function")
    path = args[2]
    val = args[3]
    if path.t < 0:
        path_items = [path]
    else:
        path_items = [at_idx(path, i) for i in range(len(path))]

    def go(cur: Obj, depth: int) -> Obj:
        if depth == len(path_items) - 1:
            return _apply_alter(interp, cur, fn, path_items[depth], val)
        key = path_items[depth]
        from .items import ray_at
        child = ray_at(cur, key)
        new_child = go(child, depth + 1)
        return _set_at(cur, key, new_child)

    out = go(obj, 0)
    store_back(interp, sid, out)
    if sid is None:
        return out
    from ..core.obj import sym
    return sym(sid)


def _set_at(cur: Obj, key: Obj, new_child: Obj) -> Obj:
    """Replace cur[key] with new_child (COW)."""
    if cur.t == T.DICT:
        keys, vals = cur.v
        from .items import _dict_find
        i = _dict_find(keys, key)
        if i is None:
            raise err_value("no such key")
        nv = list(vals.v) if vals.t == T.LIST else \
            [at_idx(vals, j) for j in range(len(vals))]
        nv[i] = new_child
        return dict_(keys, unify_list(nv))
    if cur.t == T.TABLE:
        names, cols = cur.v
        nm = to_np(names)
        hit = np.nonzero(nm == int(key.v))[0]
        if not len(hit):
            raise err_value("no such column")
        nc = list(cols)
        nc[int(hit[0])] = new_child
        return table(names, nc)
    if cur.t == T.LIST:
        items = list(cur.v)
        items[int(key.v)] = new_child
        return list_(items)
    if cur.t > 0:
        a = to_np(cur).copy()
        a[int(key.v)] = new_child.v if new_child.t < 0 else to_np(new_child)
        return Obj(cur.t, a, domain=cur.domain)
    raise err_type("cannot modify this type")
